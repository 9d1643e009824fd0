// Block-ELL slot walk that keeps a staged tile across repeated ids, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel block_ell_matmul_grid of
// keynet_tpu/ops/pallas_kernels.py (:448-484, body _kernel_grid :429-445),
// with the shared contract: y[:, r*TM:(r+1)*TM] = sum_k x[:, col_blk[r,k]*TN
// : +TN] @ tiles[tile_ids[r,k]]^T, f32 accumulation and output, a slot with
// tile id 0 skipped (as _kernel_grid skips it, :440).
//
// On the TPU the grid is (n_rb, KB), one step per slot, and Mosaic's
// pipeline skips the tile copy when consecutive steps name the same tile:
// free dedup for periodic or grouped layers.  The dedup is a schedule, not a
// result, and this kernel counts nothing on the device.
//
// What bounds it on this card: as block_ell_xres.cu (2*TM*TN FLOPs per
// non-zero slot and image against the distinct tiles, x and the output; f32
// tiles stay IEEE, so the FMA pipes are the ceiling).
//
// What the design does about it.  The grid is (batch tile, 128-wide output
// chunk of a row-block), as in block_ell.cu.  For each non-zero slot a block
// stages the whole BM x TN slice of the slot's tile (64 KB in f32 at
// TN = 128, 128 KB at TN = 256: dynamic shared memory, opted into) and the
// BT x TN x block, with cp.async, and multiplies them from a 64 x 128
// register tile.  It keeps the staged slice when the next non-zero slot has
// the same tile id and re-stages it otherwise; id-0 slots are skipped before
// they reach the staged id, so a run a, 0, a keeps the slice.  A block owns
// one row-block, so the Pallas kernel's dedup across rows, from slot
// (r, KB-1) to (r+1, 0), is lost: acceptable, since rows are independent
// blocks here that run in no order.  One stage, no pipelining yet: a simple
// kernel that is right comes first.  Shared memory: (BM + BT) x (TN + pad)
// elements, 199,680 bytes in f32 at TN = 256, inside the 227 KB a block may
// use; larger TN is refused.

#include "block_ell_stage.cuh"

namespace {

using namespace be;

constexpr size_t MAX_SMEM = 232448;  // a block's shared memory on sm_90

template <typename T>
size_t smem_bytes(int TN) {
  return (size_t)(BM + BT) * stride<T>(TN) * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(NT) grid_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int n_rb, int KB, int TM,
    int TN, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S = stride<T>(TN);
  T* ts = reinterpret_cast<T*>(smem_raw);  // BM x TN tile slice
  T* xs = ts + (size_t)BM * S;             // BT x TN x block

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
    int staged = 0;  // tile id of the slice in ts; 0 = none (id 0 is never staged)
    for (int k = 0; k < KB; ++k) {
      const int t = ids[k];
      if (t <= 0) continue;  // the zero tile: the staged slice stays
      __syncthreads();       // every thread is done with the previous slot
      if (t != staged) {
        stage_rows(ts, S, tiles + ((size_t)t * TM + m0) * TN, (size_t)TN, BM, BM, TN, tid);
        staged = t;
      }
      stage_rows(xs, S, x + (size_t)b0 * n_cols + (size_t)cbs[k] * TN, (size_t)n_cols,
                 BT, B - b0, TN, tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      fma_panel(xs, S, ts, S, TN, tx, ty, acc);
    }
  }
  store_tile(out, acc, b0, c0, B, n_out, tx, ty);
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(TN);
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(grid_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, (n_out + BM - 1) / BM);
  grid_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
      B, n_cols, n_rb, KB, TM, TN, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok),
// or cudaErrorInvalidValue when the staged slices would not fit a block's
// shared memory (TN > 256 in f32, > 512 in bf16; the wrapper checks first).  x: (B, n_cols) and tiles:
// (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16 (bf16 = 1), both 16-byte
// aligned; tile_ids/col_blk: (n_rb, KB) int32; out: (B, n_out) f32.  TM and
// TN are multiples of 128; all arrays contiguous.
int block_ell_grid(const void* x, const void* tiles, const void* tile_ids,
                   const void* col_blk, void* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, int bf16, void* stream) {
  if (TM % BM != 0 || TN % 16 != 0 || B <= 0 || n_out <= 0)
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

const char* block_ell_grid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
