// Periodic Block-ELL mid-section for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel periodic_block_ell_matvec of
// keynet_tpu/ops/pallas_kernels.py (:550-595, body _periodic_kernel
// :490-547).  Contract: rows [s, s+P*R) of a row-block-periodic Block-ELL
// operator, whose row s+rho+j*P has the tile ids of row s+rho (only rows
// [s, s+P) of tile_ids are read) and its own column blocks:
//   out[:, (j*P+rho)*TM + m] = sum_k x[:, col_blk[s+rho+j*P, k]*TN : +TN]
//                                    . tiles[tile_ids[s+rho, k]][m, :]
// f32 accumulation and output, tile id 0 skipped (the zero tile), as the
// TPU kernel skips it (:540).
//
// What bounds it on this card.  A period row's KB tiles serve all R reps,
// so the least traffic is one read of the period's tile set (P*KB tiles)
// plus x and the f32 output; the work is 2*TM*TN FLOPs per non-zero slot,
// rep and image.  For the keyed VGG-16 conv1_1 core of the Givens recipe
// (P = 784, KB = 19, R = 31) the period set is ~1 GB of f32 tiles: at the
// H100 SXM data-sheet rates (3.35 TB/s, 67 TFLOP/s f32 without tensor
// cores) B = 1 is bound by bytes (~0.3 ms) and B >= 8 by operations.  f32
// tiles stay IEEE (the exact keyed == source contract), so the FMA pipes
// are the ceiling; bf16 tiles are widened in shared memory.
//
// What the design does about it.  On the TPU x sits whole in VMEM and a
// group's tiles stay resident over the reps.  Here x does not fit shared
// memory (conv1_1's padded x is 0.66 MB an image), but it fits L2; the
// reuse kept is a tile across the reps.  A block owns one period row rho,
// one 128-wide chunk of its TM output columns, and 64 consecutive
// (rep, image) pairs q = j*B + b, so the rep chunk and the batch tile come
// from B and R (B = 1, R = 31: one block holds every rep; B = 32: two reps
// a block).  For each slot k it stages tiles[tile_ids[s+rho, k]] through
// shared memory 16 columns at a time, once, and applies it to the x block
// that each of its 64 pairs picks through col_blk[s+rho+j*P, k]: the
// 64 x 128 register tile of block_ell.cu, with rows gathered per rep.
// Blocks of one period row sit next to each other on grid.x, so their
// common tiles are read from L2.  Each block writes its outputs once, with
// no atomics, so results are run-to-run deterministic.  No TMA, wgmma or
// pipelining yet: a simple kernel that is right comes first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output columns per block (tile rows)
constexpr int BK = 16;   // contraction columns staged per iteration
constexpr int BT = 64;   // (rep, image) rows per block
constexpr int NT = 256;  // threads per block, 16 x 16

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(NT) periodic_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int KB, int TM, int TN,
    int s, int P, int R) {
  constexpr int RB = BT / 16;  // rows per thread
  __shared__ __align__(16) float xs[BK][BT + 4];
  __shared__ __align__(16) float ts[BK][BM + 4];
  __shared__ long long xoff[BT];  // row's x offset at this slot, -1 = none

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long q0 = (long long)blockIdx.x * BT;  // first (rep, image) pair
  const long long n_pairs = (long long)R * B;
  const int per_row = TM / BM;
  const int rho = blockIdx.y / per_row;             // period row
  const int m0 = (blockIdx.y % per_row) * BM;       // first tile row of the chunk

  float acc[RB][8];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int* ids = tile_ids + (size_t)(s + rho) * KB;
  for (int k = 0; k < KB; ++k) {
    const int t = ids[k];
    if (t <= 0) continue;  // the zero tile (uniform across the block)
    // the trailing __syncthreads of the previous slot ended every read of xoff
    if (tid < BT) {
      const long long q = q0 + tid;
      long long o = -1;
      if (q < n_pairs) {
        const int j = (int)(q / B), b = (int)(q % B);
        const int cb = col_blk[((size_t)s + rho + (size_t)j * P) * KB + k];
        o = (long long)b * n_cols + (long long)cb * TN;
      }
      xoff[tid] = o;
    }
    __syncthreads();
    const T* tp = tiles + ((size_t)t * TM + m0) * TN;
    for (int kc = 0; kc < TN; kc += BK) {
      // x blocks: BT rows x BK cols, stored transposed xs[kk][row]
      for (int i = tid; i < BT * (BK / 4); i += NT) {
        const int r = i / (BK / 4), qq = (i % (BK / 4)) * 4;
        const long long o = xoff[r];
        const float4 v = (o >= 0) ? load4(x + o + kc + qq)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        xs[qq + 0][r] = v.x; xs[qq + 1][r] = v.y;
        xs[qq + 2][r] = v.z; xs[qq + 3][r] = v.w;
      }
      // tile: BM rows x BK cols, stored transposed ts[kk][m]
      for (int i = tid; i < BM * (BK / 4); i += NT) {
        const int m = i / (BK / 4), qq = (i % (BK / 4)) * 4;
        const float4 v = load4(tp + (size_t)m * TN + kc + qq);
        ts[qq + 0][m] = v.x; ts[qq + 1][m] = v.y;
        ts[qq + 2][m] = v.z; ts[qq + 3][m] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[RB], w[8];
#pragma unroll
        for (int i = 0; i < RB; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(&xs[kk][ty * RB + i]);
          a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
        }
        const float4 w0 = *reinterpret_cast<const float4*>(&ts[kk][tx * 4]);
        const float4 w1 = *reinterpret_cast<const float4*>(&ts[kk][64 + tx * 4]);
        w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
        w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
#pragma unroll
        for (int i = 0; i < RB; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // row (rep j, image b) of this block -> out[b, (j*P + rho)*TM + m0 + c]
  const size_t n_out = (size_t)P * R * TM;
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const long long q = q0 + ty * RB + i;
    if (q >= n_pairs) continue;
    const int j = (int)(q / B), b = (int)(q % B);
    float* o = out + (size_t)b * n_out + ((size_t)j * P + rho) * TM + m0;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int KB,
                   int TM, int TN, int s, int P, int R, cudaStream_t stream) {
  const long long n_pairs = (long long)R * B;
  const dim3 grid((unsigned)((n_pairs + BT - 1) / BT), (unsigned)(P * (TM / BM)));
  periodic_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
      B, n_cols, KB, TM, TN, s, P, R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16
// (bf16 = 1); tile_ids/col_blk: (n_rb, KB) int32 with s + P*R <= n_rb;
// out: (B, P*R*TM) f32.  TM and TN are multiples of 128; all arrays
// contiguous.
int periodic_block_ell(const void* x, const void* tiles, const void* tile_ids,
                       const void* col_blk, void* out, int B, int n_cols,
                       int KB, int TM, int TN, int s, int P, int R, int bf16,
                       void* stream) {
  if (TM % BM != 0 || TN % BK != 0 || B <= 0 || P <= 0 || R <= 0 || s < 0 ||
      (long long)P * (TM / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16
      ? launch<__nv_bfloat16>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN, s, P, R, st)
      : launch<float>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN, s, P, R, st);
  return static_cast<int>(err);
}

const char* periodic_block_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
