// Block-ELL slot walk with a cp.async tile ring, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel block_ell_matmul_xres of
// keynet_tpu/ops/pallas_kernels.py (:185-222, body _kernel_xres :133-182),
// with the shared contract: y[:, r*TM:(r+1)*TM] = sum_k x[:, col_blk[r,k]*TN
// : +TN] @ tiles[tile_ids[r,k]]^T, f32 accumulation and output, a slot with
// tile id 0 skipped (as _kernel_xres skips it, :171-172).
//
// On the TPU, x lives whole in VMEM and the tiles stream through an NBUF = 8
// ring of DMAs, one tile copy per slot, so slot k+1's tile is in flight
// while slot k runs on the MXU.  Here x is read in place from global memory,
// with no copy made of it: at the bench shapes it sits in L2 (x at B = 128 of
// the 128-row-block bench operand is 8.4 MB in f32; L2 holds 50 MB), L2 being
// this card's counterpart of VMEM residency.  The tile panels, and the x
// panels each slot reads, stream through a NSTAGE-deep cp.async ring in
// shared memory (commit_group / wait_group).
//
// What bounds it on this card.  A non-zero slot costs 2*TM*TN FLOPs per
// image; the least bytes are the distinct tiles once, x once and the f32
// output once.  At the H100 SXM data-sheet rates (67 TFLOP/s f32 without
// tensor cores, 3.35 TB/s) the 128 x 9 bench operand is bound by bytes at
// B = 8 (~8 us) and by operations at B = 128 (~72 us); the 784 x 40 one by
// bytes at B = 1 and 8 and by operations at B = 128.  f32 tiles stay IEEE
// (the exact keyed == source contract), so the FMA pipes are the ceiling.
//
// What the design does about it.  The grid is (batch tile, 128-wide output
// chunk of a row-block), as in block_ell.cu.  A block walks the non-zero
// slots of its row-block as one sequence of steps, BK contraction columns
// each: a step stages the BM x BK panel of the slot's tile and the BT x BK
// panel of its x block.  NSTAGE - 1 steps are in flight while one is
// multiplied, so the next slot's tile panel arrives while the FMAs of the
// current slot run, across slot boundaries.  Each staged element feeds BT
// (tile) or BM (x) FMAs from a 64 x 128 register tile.  The output is
// written once, with no atomics: results are run-to-run deterministic.

#include "block_ell_stage.cuh"

namespace {

using namespace be;

constexpr int BK = 16;      // contraction columns per step
constexpr int NSTAGE = 4;   // steps in the ring

template <typename T>
struct Ring {
  static constexpr int S = stride<T>(BK);     // row stride of a staged panel
  static constexpr int X = BT * S;            // x panel elements
  static constexpr int STAGE = X + BM * S;    // x panel + tile panel
  static constexpr size_t BYTES = (size_t)NSTAGE * STAGE * sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(NT) xres_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int n_rb, int KB, int TM,
    int TN, int n_out) {
  using RG = Ring<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

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
    const int per_slot = TN / BK;
    int nz = 0;
    for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
    const int steps = nz * per_slot;

    // producer cursor: slot pk (non-zero), column chunk pc of the next step
    int pk = 0, pc = 0;
    while (pk < KB && ids[pk] <= 0) ++pk;
    auto load_step = [&](int stage) {
      T* xs = smem + (size_t)stage * RG::STAGE;
      T* ts = xs + RG::X;
      const int t = ids[pk];
      stage_rows(ts, RG::S, tiles + ((size_t)t * TM + m0) * TN + pc * BK, (size_t)TN,
                 BM, BM, BK, tid);
      stage_rows(xs, RG::S, x + (size_t)b0 * n_cols + (size_t)cbs[pk] * TN + pc * BK,
                 (size_t)n_cols, BT, B - b0, BK, tid);
      if (++pc == per_slot) {
        pc = 0;
        do ++pk; while (pk < KB && ids[pk] <= 0);
      }
    };

    // prologue: NSTAGE - 1 steps in flight (a group is committed even when
    // empty, so wait_group counts steps)
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < steps) load_step(s);
      cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      cp_async_wait<NSTAGE - 2>();  // this step's copies have landed ...
      __syncthreads();              // ... for every thread, and step - 1 is done
      if (step + NSTAGE - 1 < steps) load_step((step + NSTAGE - 1) % NSTAGE);
      cp_async_commit();
      const T* xs = smem + (size_t)(step % NSTAGE) * RG::STAGE;
      fma_panel(xs, RG::S, xs + RG::X, RG::S, BK, tx, ty, acc);
    }
    cp_async_wait<0>();
  }
  store_tile(out, acc, b0, c0, B, n_out, tx, ty);
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* ids,
                   const int* cols, float* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, cudaStream_t stream) {
  const size_t bytes = Ring<T>::BYTES;
  cudaError_t err = allow_smem(xres_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + BT - 1) / BT, (n_out + BM - 1) / BM);
  xres_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(tiles), ids, cols, out,
      B, n_cols, n_rb, KB, TM, TN, n_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16
// (bf16 = 1), both 16-byte aligned; tile_ids/col_blk: (n_rb, KB) int32;
// out: (B, n_out) f32.  TM and TN are multiples of 128; all arrays
// contiguous.
int block_ell_xres(const void* x, const void* tiles, const void* tile_ids,
                   const void* col_blk, void* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, int bf16, void* stream) {
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

const char* block_ell_xres_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
