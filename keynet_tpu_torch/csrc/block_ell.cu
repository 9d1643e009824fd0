// Block-ELL slot walk for Hopper (sm_90a): y = x @ W^T for a Block-ELL W.
//
// Replaces the Pallas TPU kernels of keynet_tpu/ops/pallas_kernels.py:
//   block_ell_matmul        (:93-130, body _kernel :35-90)
//   block_ell_matmul_xres2  (:288-324, body _kernel_xres2 :225-285)
//   block_ell_matmul_xresd  (:388-426, body _kernel_xresd :327-385)
// with their contract: y[:, r*TM:(r+1)*TM] = sum_k x[:, col_blk[r,k]*TN : +TN]
// @ tiles[tile_ids[r,k]]^T, f32 accumulation and output, tile id 0 = zeros.
// The three differ on the TPU only in where x lives (HBM or VMEM) and in how
// many slots one MXU dot fuses; neither has a meaning here, so all three
// launch the one kernel below.
//
// What bounds it on this card.  Per image a non-zero slot costs 2*TM*TN
// FLOPs; the bytes are the unique tiles (read once at best), x and the f32
// output.  For the keyed AllConvNet conv1 core (6,879 non-zero slots of
// 128x128, 2,981 unique f32 tiles = 195 MB) that is 225 MFLOP per image
// against 195 MB + 12.8 KB + 394 KB per image: at the H100 SXM data-sheet
// rates (67 TFLOP/s f32 without tensor cores, 3.35 TB/s) the kernel is
// memory-bound below B ~ 18 and compute-bound above.  f32 tiles must stay
// IEEE (the exact keyed == source contract), so the f32 rate without tensor
// cores is the ceiling; bf16 tiles are converted to f32 in shared memory and
// take the same FMA path.
//
// What the design does about it.  The grid is (batch tile, 128-wide output
// chunk of a row-block).  Each block owns out[b0:b0+BT, c0:c0+128] in
// registers (a 64 x 128 register tile, 4 x 8 per thread), walks the
// row-block's KB slots, skips a slot whose tile id is 0 (its tile is zeros),
// and for every other slot stages the x block and the tile through shared
// memory BK columns at a time.  Each staged element feeds BT (tile) or 128
// (x) FMAs, which keeps the loop on the FMA pipes rather than on memory once
// B is past the crossover.  The output is written once, with no atomics, so
// results are run-to-run deterministic.  Batch tiles sit on grid.x, so the
// blocks resident together share one row-block's tiles in L2.  No TMA, wgmma
// or pipelining yet: a simple kernel that is right comes first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output columns per block (tile rows)
constexpr int BK = 16;   // contraction columns staged per iteration
constexpr int BT = 64;   // batch rows per block
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
__global__ void __launch_bounds__(NT) slot_walk_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int n_rb, int KB, int TM,
    int TN, int n_out) {
  constexpr int RB = BT / 16;  // batch rows per thread
  __shared__ __align__(16) float xs[BK][BT + 4];
  __shared__ __align__(16) float ts[BK][BM + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b0 = blockIdx.x * BT;
  const int chunk = blockIdx.y;
  const int per_rb = TM / BM;
  const int r = chunk / per_rb;           // row-block
  const int m0 = (chunk % per_rb) * BM;   // first tile row of this chunk
  const int c0 = chunk * BM;              // first output column

  float acc[RB][8];
#pragma unroll
  for (int i = 0; i < RB; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (r < n_rb) {
    const int* ids = tile_ids + (size_t)r * KB;
    const int* cbs = col_blk + (size_t)r * KB;
    for (int k = 0; k < KB; ++k) {
      const int t = ids[k];
      if (t <= 0) continue;  // the zero tile
      const T* xp = x + (size_t)cbs[k] * TN;
      const T* tp = tiles + ((size_t)t * TM + m0) * TN;
      for (int kc = 0; kc < TN; kc += BK) {
        // x block: BT rows x BK cols, stored transposed xs[kk][b]
        for (int i = tid; i < BT * (BK / 4); i += NT) {
          const int b = i / (BK / 4), q = (i % (BK / 4)) * 4;
          const float4 v = (b0 + b < B)
              ? load4(xp + (size_t)(b0 + b) * n_cols + kc + q)
              : make_float4(0.f, 0.f, 0.f, 0.f);
          xs[q + 0][b] = v.x; xs[q + 1][b] = v.y;
          xs[q + 2][b] = v.z; xs[q + 3][b] = v.w;
        }
        // tile: BM rows x BK cols, stored transposed ts[kk][m]
        for (int i = tid; i < BM * (BK / 4); i += NT) {
          const int m = i / (BK / 4), q = (i % (BK / 4)) * 4;
          const float4 v = load4(tp + (size_t)m * TN + kc + q);
          ts[q + 0][m] = v.x; ts[q + 1][m] = v.y;
          ts[q + 2][m] = v.z; ts[q + 3][m] = v.w;
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
  }

#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + ty * RB + i;
    if (b >= B) continue;
    float* o = out + (size_t)b * n_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx * 4 + j;
      if (c < n_out) o[c] = acc[i][j];
      const int c2 = c0 + 64 + tx * 4 + j;
      if (c2 < n_out) o[c2] = acc[i][4 + j];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, cudaStream_t stream) {
  const dim3 grid((B + BT - 1) / BT, (n_out + BM - 1) / BM);
  slot_walk_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
      B, n_cols, n_rb, KB, TM, TN, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16
// (bf16 = 1); tile_ids/col_blk: (n_rb, KB) int32; out: (B, n_out) f32.
// TM and TN are multiples of 128; all arrays contiguous.
int block_ell_slot_walk(const void* x, const void* tiles, const void* tile_ids,
                        const void* col_blk, void* out, int B, int n_cols,
                        int n_rb, int KB, int TM, int TN, int n_out, int bf16,
                        void* stream) {
  if (TM % BM != 0 || TN % BK != 0 || B <= 0 || n_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16
      ? launch<__nv_bfloat16>(x, tiles, ids, cols, o, B, n_cols, n_rb, KB, TM, TN, n_out, s)
      : launch<float>(x, tiles, ids, cols, o, B, n_cols, n_rb, KB, TM, TN, n_out, s);
  return static_cast<int>(err);
}

const char* block_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
