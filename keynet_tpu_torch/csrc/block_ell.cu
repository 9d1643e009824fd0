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
// What bounds it on this card.  Per row a non-zero slot costs 2*TM*TN FLOPs;
// the least bytes are the distinct tiles once, x and the f32 output.  f32
// tiles must stay IEEE (the keyed == source contract), so the ceiling is the
// f32 FMA rate without tensor cores (67 TFLOP/s on the H100 SXM data sheet)
// or 3.35 TB/s.  With few rows (the head and tail row-blocks of the VGG
// periodic cores at B = 1: one live row) each staged tile element feeds a
// handful of FMAs and the tile bytes bound it; at AllConvNet conv1, B = 64,
// the FMAs do (~0.2 ms).  The earlier kernel ran a 64-row tile whatever B
// was (at B = 1, 63 of 64 rows were padding) with synchronous loads that
// were transposed by scalar stores and overlapped no FMA.
//
// What the design does about it.  block_ell_core.cuh: the row tile BT in
// {8, 16, 32, 64, 128} is the least that holds B (capped at 128; the wrapper
// chooses it, ops/block_ell.launch_plan), so the padded FMAs follow B; tile
// and x panels stream through a cp.async ring across slot boundaries, so the
// next slot's tile arrives while this slot's FMAs run; reads out of shared
// memory are 16 bytes and free of bank conflicts; 8 x 8 accumulators a
// thread.  The grid is (ceil(B / BT), 128-wide output chunks); batch tiles
// of one chunk sit next to each other on grid.x and share its tiles in L2.
// A block walks its row-block's KB slots and skips a slot whose tile id is 0
// (its tile is zeros).  The output is written once, with no atomics, so
// results are run-to-run deterministic.
//
// bf16 tiles.  The Pallas kernels run a bf16 x bf16 -> f32 dot on the
// matrix unit; so does the bf16 instantiation here, on the tensor cores
// (block_ell_wgmma.cuh): the same walk, grid and row tile, its panels staged
// by cp.async at 128-byte-swizzled addresses and multiplied by wgmma, two
// warpgroups a block.  Its ceiling is 989 TFLOP/s (H100 SXM data sheet)
// where the FMA pipes give 67, so its bound is 15x lower wherever operations
// bound the FMA version (AllConvNet conv1 at B = 1024: 3.445 ms of f32
// FMAs, 0.233 ms at the bf16 rate).
//
// f32 tiles under PRECISION='default'.  The Pallas kernels' f32 dot then
// runs one reduced-precision pass (Precision.DEFAULT, :107-110, :301-304,
// :403-406); here the same wgmma walk takes the f32 panels as tf32 x tf32
// products (m64nBTk8, four a 128-byte step; the tensor cores drop each
// operand's 13 low mantissa bits, block_ell_wgmma.cuh).  Its ceiling is the
// data sheet's 494.7 TFLOP/s dense TF32, 7.4x the FMA pipes'; bytes are
// the f32 ones.  'highest' and 'high' keep the FMA core below, unchanged.

#include "block_ell_core.cuh"
#include "block_ell_wgmma.cuh"

namespace {

using namespace bc;

template <class C, typename T>
__global__ void __launch_bounds__(C::NT, 1) slot_walk_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int n_rb, int KB, int TM,
    int TN, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  const int b0 = blockIdx.x * C::BT;
  const int chunk = blockIdx.y;
  const int per_rb = TM / BM;
  const int rb = chunk / per_rb;          // row-block
  const int m0 = (chunk % per_rb) * BM;   // first tile row of this chunk
  const int c0 = chunk * BM;              // first output column

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (rb < n_rb) {
    const int* ids = tile_ids + (size_t)rb * KB;
    const int* cbs = col_blk + (size_t)rb * KB;
    const int per_slot = TN / C::BK;
    int nz = 0;
    for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
    const int valid = min(B - b0, C::BT);
    const T* xrow = x + (size_t)b0 * n_cols;

    // producer cursor: slot pk (non-zero), column chunk pc of the next step
    int pk = 0, pc = 0;
    while (pk < KB && ids[pk] <= 0) ++pk;
    run_ring<C>(smem, nz * per_slot, tid, tx, r, kg, acc, [&](T* st) {
      const int col = pc * C::BK;
      stage_tile<C>(st + C::X, tiles + ((size_t)ids[pk] * TM + m0) * TN + col, (size_t)TN, tid);
      const T* xs = xrow + (size_t)cbs[pk] * TN + col;
      stage_x<C>(st, xs, [&](int row) -> long long {
        return row < valid ? (long long)row * n_cols : -1;
      }, tid);
      if (++pc == per_slot) {
        pc = 0;
        do ++pk; while (pk < KB && ids[pk] <= 0);
      }
    });
  }
  fold_and_store<C>(acc, smem_raw, tid, n_out - c0, [&](int row) -> float* {
    return b0 + row < B ? out + (size_t)(b0 + row) * n_out + c0 : nullptr;
  });
}

// The tensor-core instantiations, bf16 and tf32: the same walk on wgmma
// (block_ell_wgmma.cuh).
template <class C>
__global__ void __launch_bounds__(C::NT, 2) slot_walk_wgmma(
    const typename C::T* __restrict__ x, const typename C::T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int n_rb, int KB, int TM,
    int TN, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * C::BT;
  const int chunk = blockIdx.y;
  const int per_rb = TM / BM;
  const int rb = chunk / per_rb;          // row-block
  const int m0 = (chunk % per_rb) * BM;   // first tile row of this chunk
  const int c0 = chunk * BM;              // first output column

  float acc[C::ACC];
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

  if (rb < n_rb) {
    const int* ids = tile_ids + (size_t)rb * KB;
    const int* cbs = col_blk + (size_t)rb * KB;
    const int per_slot = TN / C::BK;
    int nz = 0;
    for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
    const int valid = min(B - b0, C::BT);
    const typename C::T* xrow = x + (size_t)b0 * n_cols;

    // producer cursor: slot pk (non-zero), column chunk pc of the next step
    int pk = 0, pc = 0;
    while (pk < KB && ids[pk] <= 0) ++pk;
    bw::run_ring<C>(ring, nz * per_slot, tid / 128, acc, [&](unsigned char* st) {
      const int col = pc * C::BK;
      bw::stage_tile<C>(st + C::X_BYTES, tiles + ((size_t)ids[pk] * TM + m0) * TN + col,
                        (size_t)TN, tid);
      const typename C::T* xs = xrow + (size_t)cbs[pk] * TN + col;
      bw::stage_x<C>(st, xs, [&](int row) -> long long {
        return row < valid ? (long long)row * n_cols : -1;
      }, tid);
      if (++pc == per_slot) {
        pc = 0;
        do ++pk; while (pk < KB && ids[pk] <= 0);
      }
    });
  }
  bw::store<C>(acc, tid, n_out - c0, [&](int row) -> float* {
    return b0 + row < B ? out + (size_t)(b0 + row) * n_out + c0 : nullptr;
  });
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, int BT, size_t bytes,
                   cudaStream_t stream) {
  return with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < ring_smem<C>()) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(slot_walk_kernel<C, T>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + C::BT - 1) / C::BT, (n_out + BM - 1) / BM);
    slot_walk_kernel<C, T><<<grid, C::NT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
        B, n_cols, n_rb, KB, TM, TN, n_out);
    return cudaGetLastError();
  });
}

template <typename T>
cudaError_t launch_wgmma(const void* x, const void* tiles, const int* ids, const int* cols,
                         float* out, int B, int n_cols, int n_rb, int KB, int TM, int TN,
                         int n_out, int BT, size_t bytes, cudaStream_t stream) {
  return bw::with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < C::SMEM) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(slot_walk_wgmma<C>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + C::BT - 1) / C::BT, (n_out + BM - 1) / BM);
    slot_walk_wgmma<C><<<grid, C::NT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out, B, n_cols,
        n_rb, KB, TM, TN, n_out);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN), both 16-byte aligned, and the
// product, as ops/block_ell.py's KIND numbers it: f32 on the IEEE FMA core
// (kind = 0), bf16 x bf16 on the tensor cores (1), or f32 operands as
// tf32 x tf32 on the tensor cores (2); tile_ids/col_blk: (n_rb, KB) int32;
// out: (B, n_out) f32.  TM and TN are multiples of 128; all arrays
// contiguous.  BT (8, 16, 32, 64 or 128) is the row tile and smem the
// dynamic shared memory of a block, as ops/block_ell.launch_plan chooses
// them; fewer bytes than BT's layout needs are refused.
int block_ell_slot_walk(const void* x, const void* tiles, const void* tile_ids,
                        const void* col_blk, void* out, int B, int n_cols,
                        int n_rb, int KB, int TM, int TN, int n_out, int kind,
                        int BT, int smem, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || n_out <= 0 || smem <= 0 || kind < 0 ||
      kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kind == 1 ? launch_wgmma<__nv_bfloat16>(x, tiles, ids, cols, o, B, n_cols, n_rb, KB, TM,
                                              TN, n_out, BT, smem, s)
      : kind == 2 ? launch_wgmma<float>(x, tiles, ids, cols, o, B, n_cols, n_rb, KB, TM, TN,
                                        n_out, BT, smem, s)
      : launch<float>(x, tiles, ids, cols, o, B, n_cols, n_rb, KB, TM, TN, n_out, BT, smem, s);
  return static_cast<int>(err);
}

const char* block_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
