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
// so the least traffic is one read of the period's tile set plus x and the
// f32 output; the work is 2*TM*TN FLOPs per non-zero slot, rep and image.
// For the keyed VGG-16 conv1_2 core of the Givens recipe (P = 784, KB = 19,
// R = 31) that is ~0.22 ms of f32 FMAs at B = 1 and ~7 ms at B = 32 at the
// H100 SXM data-sheet rate (67 TFLOP/s without tensor cores), above the
// bytes of the tiles: operations bound it.  f32 tiles stay IEEE (the keyed
// == source contract), so the FMA pipes are the ceiling.  The earlier
// kernel ran a 64-row tile of (rep, image) pairs whatever R*B was (31 live
// rows of 64 at B = 1, 7 at conv3_x), loaded its panels synchronously with
// transposing scalar stores, and reached ~37% of the FMA rate at B = 32.
//
// What the design does about it.  block_ell_core.cuh: a block owns one
// period row rho, one 128-wide chunk of its TM columns and BT consecutive
// (rep, image) pairs q = j*B + b, BT in {8, ..., 128} the least that holds
// R*B (capped at 128; ops/block_ell.launch_plan chooses it), so conv1_2 at
// B = 1 runs a 32-row tile and conv3_x (R = 7) an 8-row one.  Each pair row
// reads its own x block at a slot, col_blk[s+rho+j*P, k]: those offsets are
// computed one non-zero slot ahead into shared memory (two buffers), so the
// gather of the next slot's x panels and its tile panels are in the cp.async
// ring while this slot multiplies.  8 x 8 accumulators a thread, 16-byte
// conflict-free reads out of shared memory.  Blocks of one period row sit
// next to each other on grid.x, so the tiles they share come from L2.  Each
// output is written once, with no atomics: results are run-to-run
// deterministic.
//
// bf16 tiles run on the tensor cores, as the Pallas kernel's bf16 dot runs
// on the matrix unit (block_ell_wgmma.cuh): the same walk, grid, row tile
// and offset buffers, the panels staged at 128-byte-swizzled addresses and
// multiplied by wgmma.  At conv1_2 and B = 32 the operations bound falls from
// 7.04 ms of f32 FMAs to 0.48 ms at 989 TFLOP/s, beside 0.2 ms for the bytes
// it must move; what it stages is more, since every block reads its slot's
// tile panel and gathers its x rows again (L2 serves most of it).
//
// f32 tiles under PRECISION='default' run the same wgmma walk as tf32 x tf32
// products (the Pallas dot at Precision.DEFAULT, :566-569; four m64nBTk8
// steps a 128-wide slot, 13 low mantissa bits of each operand dropped,
// block_ell_wgmma.cuh): at conv1_2 and B = 32 the operations bound is
// 0.95 ms at 494.7 TFLOP/s dense TF32, beside 0.4 ms for its f32 bytes.

#include "block_ell_core.cuh"
#include "block_ell_wgmma.cuh"

namespace {

using namespace bc;

template <class C>
__host__ __device__ constexpr size_t xoff_bytes() {
  return 2 * C::BT * sizeof(long long);  // two slots' row offsets
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT, 1) periodic_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int KB, int TM, int TN,
    int s, int P, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* xoff = reinterpret_cast<long long*>(smem_raw);  // [2][BT], -1 = none
  unsigned char* ring = smem_raw + xoff_bytes<C>();
  T* smem = reinterpret_cast<T*>(ring);

  const int tid = threadIdx.x;
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  const long long q0 = (long long)blockIdx.x * C::BT;  // first (rep, image) pair
  const long long n_pairs = (long long)R * B;
  const int per_row = TM / BM;
  const int rho = blockIdx.y / per_row;               // period row
  const int m0 = (blockIdx.y % per_row) * BM;         // first tile row of the chunk

  // thread tid < BT owns pair row tid's offsets: its image's x row and its
  // rep's column-block row
  long long xrow = -1;
  const int* cbrow = col_blk;
  if (tid < C::BT && q0 + tid < n_pairs) {
    const long long q = q0 + tid;
    const int j = (int)(q / B), b = (int)(q % B);
    xrow = (long long)b * n_cols;
    cbrow = col_blk + ((size_t)s + rho + (size_t)j * P) * KB;
  }
  const int* ids = tile_ids + (size_t)(s + rho) * KB;
  auto next_nz = [&](int k) {
    do ++k; while (k < KB && ids[k] <= 0);
    return k;
  };
  auto fill = [&](int buf, int k) {  // row offsets of slot k into buffer buf
    if (tid < C::BT && k < KB)
      xoff[buf * C::BT + tid] = xrow >= 0 ? xrow + (long long)cbrow[k] * TN : -1;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  int nz = 0;
  for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
  const int per_slot = TN / C::BK;  // steps a slot: >= STAGES - 1 (below)
  static_assert(128 / C::BK >= STAGES - 1, "a 128-wide slot has STAGES - 1 steps");

  // producer cursor: slot pk (its n-th non-zero slot, offsets in buffer
  // n & 1), column chunk pc of the next step.  The first step of slot n
  // (n >= 1) fills slot n + 1's offsets into the other buffer.  Since
  // per_slot >= STAGES - 1, that step is loaded in the ring's main loop,
  // behind a __syncthreads that ended every read of slot n - 1's offsets
  // (the buffer it overwrites), and slot n + 1's first step comes per_slot
  // steps, and as many barriers, later.  Slots 0 and 1 are filled first.
  int pk = next_nz(-1), pc = 0, n = 0;
  fill(0, pk);
  fill(1, next_nz(pk));
  __syncthreads();
  run_ring<C>(smem, nz * per_slot, tid, tx, r, kg, acc, [&](T* st) {
    if (pc == 0 && n > 0) fill((n + 1) & 1, next_nz(pk));
    const int col = pc * C::BK;
    stage_tile<C>(st + C::X, tiles + ((size_t)ids[pk] * TM + m0) * TN + col, (size_t)TN, tid);
    const long long* off = xoff + (n & 1) * C::BT;
    stage_x<C>(st, x + col, [&](int row) { return off[row]; }, tid);
    if (++pc == per_slot) {
      pc = 0;
      pk = next_nz(pk);
      ++n;
    }
  });

  // pair row q (rep j, image b) -> out[b, (j*P + rho)*TM + m0 + c]
  const size_t n_out = (size_t)P * R * TM;
  fold_and_store<C>(acc, ring, tid, BM, [&](int row) -> float* {
    const long long q = q0 + row;
    if (q >= n_pairs) return nullptr;
    const int j = (int)(q / B), b = (int)(q % B);
    return out + (size_t)b * n_out + ((size_t)j * P + rho) * TM + m0;
  });
}

// The tensor-core instantiations, bf16 and tf32: the same walk on wgmma
// (block_ell_wgmma.cuh); the x offsets sit before the 1024-byte-aligned ring.
template <class C>
__global__ void __launch_bounds__(C::NT, 2) periodic_wgmma(
    const typename C::T* __restrict__ x, const typename C::T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int KB, int TM, int TN,
    int s, int P, int R) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* xoff = reinterpret_cast<long long*>(smem_raw);  // [2][BT], -1 = none
  unsigned char* ring = align1024(smem_raw + xoff_bytes<C>());

  const int tid = threadIdx.x;
  const long long q0 = (long long)blockIdx.x * C::BT;  // first (rep, image) pair
  const long long n_pairs = (long long)R * B;
  const int per_row = TM / BM;
  const int rho = blockIdx.y / per_row;               // period row
  const int m0 = (blockIdx.y % per_row) * BM;         // first tile row of the chunk

  long long xrow = -1;
  const int* cbrow = col_blk;
  if (tid < C::BT && q0 + tid < n_pairs) {
    const long long q = q0 + tid;
    const int j = (int)(q / B), b = (int)(q % B);
    xrow = (long long)b * n_cols;
    cbrow = col_blk + ((size_t)s + rho + (size_t)j * P) * KB;
  }
  const int* ids = tile_ids + (size_t)(s + rho) * KB;
  auto next_nz = [&](int k) {
    do ++k; while (k < KB && ids[k] <= 0);
    return k;
  };
  auto fill = [&](int buf, int k) {  // row offsets of slot k into buffer buf
    if (tid < C::BT && k < KB)
      xoff[buf * C::BT + tid] = xrow >= 0 ? xrow + (long long)cbrow[k] * TN : -1;
  };

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  int nz = 0;
  for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
  const int per_slot = TN / C::BK;  // steps a slot: >= STAGES - 1 (below)
  static_assert(128 / C::BK >= STAGES - 1, "a 128-wide slot has STAGES - 1 steps");

  // the producer cursor and the offsets' double buffer of periodic_kernel
  int pk = next_nz(-1), pc = 0, n = 0;
  fill(0, pk);
  fill(1, next_nz(pk));
  __syncthreads();
  bw::run_ring<C>(ring, nz * per_slot, tid / 128, acc, [&](unsigned char* st) {
    if (pc == 0 && n > 0) fill((n + 1) & 1, next_nz(pk));
    const int col = pc * C::BK;
    bw::stage_tile<C>(st + C::X_BYTES, tiles + ((size_t)ids[pk] * TM + m0) * TN + col,
                      (size_t)TN, tid);
    const long long* off = xoff + (n & 1) * C::BT;
    bw::stage_x<C>(st, x + col, [&](int row) { return off[row]; }, tid);
    if (++pc == per_slot) {
      pc = 0;
      pk = next_nz(pk);
      ++n;
    }
  });

  // pair row q (rep j, image b) -> out[b, (j*P + rho)*TM + m0 + c]
  const size_t n_out = (size_t)P * R * TM;
  bw::store<C>(acc, tid, BM, [&](int row) -> float* {
    const long long q = q0 + row;
    if (q >= n_pairs) return nullptr;
    const int j = (int)(q / B), b = (int)(q % B);
    return out + (size_t)b * n_out + ((size_t)j * P + rho) * TM + m0;
  });
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int KB,
                   int TM, int TN, int s, int P, int R, int BT, size_t bytes,
                   cudaStream_t stream) {
  return with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < xoff_bytes<C>() + ring_smem<C>()) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(periodic_kernel<C, T>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const long long n_pairs = (long long)R * B;
    const dim3 grid((unsigned)((n_pairs + C::BT - 1) / C::BT), (unsigned)(P * (TM / BM)));
    periodic_kernel<C, T><<<grid, C::NT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
        B, n_cols, KB, TM, TN, s, P, R);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* tiles, const int* ids, const int* cols,
                         float* out, int B, int n_cols, int KB, int TM, int TN, int s, int P,
                         int R, int BT, size_t bytes, cudaStream_t stream) {
  return bw::with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < xoff_bytes<C>() + C::SMEM) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(periodic_wgmma<C>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const long long n_pairs = (long long)R * B;
    const dim3 grid((unsigned)((n_pairs + C::BT - 1) / C::BT), (unsigned)(P * (TM / BM)));
    periodic_wgmma<C><<<grid, C::NT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out, B, n_cols,
        KB, TM, TN, s, P, R);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN), both 16-byte aligned, and the
// product, as ops/block_ell.py's KIND numbers it: f32 on the IEEE FMA core
// (kind = 0), bf16 x bf16 on the tensor cores (1), or f32 operands as
// tf32 x tf32 on the tensor cores (2); tile_ids/col_blk: (n_rb, KB) int32
// with s + P*R <= n_rb; out: (B, P*R*TM) f32.  TM and TN are multiples of
// 128; all arrays contiguous.  BT (8, 16, 32, 64 or 128) is the row tile
// over the R*B (rep, image) pairs and smem the dynamic shared memory of a
// block, as ops/block_ell.launch_plan chooses them; fewer bytes than BT's
// layout needs are refused.
int periodic_block_ell(const void* x, const void* tiles, const void* tile_ids,
                       const void* col_blk, void* out, int B, int n_cols,
                       int KB, int TM, int TN, int s, int P, int R, int kind,
                       int BT, int smem, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || P <= 0 || R <= 0 || s < 0 || smem <= 0 ||
      kind < 0 || kind > 2 || (long long)P * (TM / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kind == 1 ? launch_wgmma<__nv_bfloat16>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN, s,
                                              P, R, BT, smem, st)
      : kind == 2 ? launch_wgmma<float>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN, s, P, R,
                                        BT, smem, st)
      : launch<float>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN, s, P, R, BT, smem, st);
  return static_cast<int>(err);
}

const char* periodic_block_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
