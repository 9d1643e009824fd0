// Block-ELL slot walk with a TMA tile ring, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel block_ell_matmul_xres of
// keynet_tpu/ops/pallas_kernels.py (:186-222, body _kernel_xres :133-182),
// with the shared contract: y[:, r*TM:(r+1)*TM] = sum_k x[:, col_blk[r,k]*TN
// : +TN] @ tiles[tile_ids[r,k]]^T, f32 accumulation and output, a slot with
// tile id 0 skipped (as _kernel_xres skips it, :171-172).
//
// On the TPU, x lives whole in VMEM and each slot's tile arrives by one DMA
// through an NBUF = 8 ring, so slot k+1's tile is in flight while slot k runs
// on the MXU.  Here each ring step's copies are TMA bulk tensor copies: one
// thread issues the 128 x 128-byte panel of the slot's tile and the BT x
// 128-byte panel of its x rows, each as one cp.async.bulk.tensor.2d onto the
// stage's mbarrier (expect_tx: both boxes in full, rows of x past B included,
// which TMA fills with zeros).  The hardware computes the addresses, so the
// copies take two instructions a step where the cp.async ring of the slot
// walk spends (128 + BT) * 8, each with its own address arithmetic, beside
// the FMAs.
//
// What bounds it on this card.  A non-zero slot costs 2*TM*TN FLOPs per
// image; the least bytes are the distinct tiles once, x once and the f32
// output once.  At the H100 SXM data-sheet rates (67 TFLOP/s f32 without
// tensor cores, 3.35 TB/s) the 784 x 40 depth-bench operand is bound by
// bytes at B = 1 and 8 and by operations at B = 128; AllConvNet conv1 at
// B = 1024 by operations.  f32 tiles stay IEEE (the exact keyed == source
// contract), so the FMA pipes are the ceiling.
//
// What the design does about it.  block_ell_core.cuh's register tiling: the
// row tile BT in {8, ..., 128} from ops/block_ell.launch_plan, 8 x 8
// accumulators a thread, k groups folded in a fixed order for BT <= 32.  The
// grid is (ceil(B / BT), 128-wide output chunks), as in the slot walk.  A
// block walks the non-zero slots of its row-block (id-0 slots are skipped
// before any copy is issued) through a STAGES-deep ring; a stage is refilled
// behind the ring's __syncthreads, when every thread is done with it.  TMA
// cannot pad rows as the cp.async ring does, so panels are swizzled
// (CU_TENSOR_MAP_SWIZZLE_128B, 1024-byte-aligned stages) and read through
// bc::Swizzle128.  The tensor maps are built on the host for each call's
// pointers (cached); a map that cannot be built is an error, with no other
// path.  Each output is written once, with no atomics: results are run-to-run
// deterministic.

#include <climits>

#include "block_ell_core.cuh"

namespace {

using namespace bc;

// Shared memory of a launch: 1024 bytes of alignment slack, STAGES stages of
// (x panel, tile panel) and one mbarrier a stage; the k groups' fold reuses
// the ring.
template <class C>
constexpr size_t xres_smem() {
  static_assert(C::FOLD_BYTES <= (size_t)STAGES * (C::X_BYTES + C::PANEL_BYTES), "fold");
  return 1024 + (size_t)STAGES * (C::X_BYTES + C::PANEL_BYTES) + STAGES * sizeof(uint64_t);
}

template <class C, typename T>
__global__ void __launch_bounds__(C::NT, 1) xres_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap tmap,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_rb, int KB, int TM, int TN, int n_out) {
  constexpr int STAGE = C::XT + C::PANEL;  // elements of a stage: x panel, tile panel
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  T* ring = reinterpret_cast<T*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)STAGES * STAGE * sizeof(T));

  const int tid = threadIdx.x;
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  const int b0 = blockIdx.x * C::BT;
  const int chunk = blockIdx.y;
  const int per_rb = TM / BM;
  const int rb = chunk / per_rb;          // row-block
  const int m0 = (chunk % per_rb) * BM;   // first tile row of this chunk
  const int c0 = chunk * BM;              // first output column

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) be::mbar_init(full + s, 1);
    be::fence_barrier_init();
  }
  __syncthreads();

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

    // thread 0's copy cursor: slot pk (non-zero), column chunk pc of the next step
    int pk = 0, pc = 0;
    if (tid == 0)
      while (pk < KB && ids[pk] <= 0) ++pk;
    ring_steps<C, Swizzle128>(
        ring, STAGE, C::XT, nz * per_slot, tx, r, kg, acc,
        [&](int s, bool live) {
          if (!live || tid != 0) return;
          T* xs = ring + (size_t)s * STAGE;
          be::mbar_expect_tx(full + s, C::X_BYTES + C::PANEL_BYTES);
          be::tma_load_2d(xs + C::XT, &tmap, pc * C::BK, ids[pk] * TM + m0, full + s);
          be::tma_load_2d(xs, &xmap, cbs[pk] * TN + pc * C::BK, b0, full + s);
          if (++pc == per_slot) {
            pc = 0;
            do ++pk; while (pk < KB && ids[pk] <= 0);
          }
        },
        // the stage's n-th fill completes its phase n, of parity n & 1
        [&](int step, int s) { be::mbar_wait(full + s, (step / STAGES) & 1); });
  }
  fold_and_store<C>(acc, base, tid, n_out - c0, [&](int row) -> float* {
    return b0 + row < B ? out + (size_t)(b0 + row) * n_out + c0 : nullptr;
  });
}

template <typename T>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& tmap, const int* ids,
                   const int* cols, float* out, int B, int n_rb, int KB, int TM, int TN,
                   int n_out, int BT, size_t bytes, cudaStream_t stream) {
  return with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < xres_smem<C>()) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(xres_kernel<C, T>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((B + C::BT - 1) / C::BT, (n_out + BM - 1) / BM);
    xres_kernel<C, T><<<grid, C::NT, bytes, stream>>>(xmap, tmap, ids, cols, out, B, n_rb, KB,
                                                      TM, TN, n_out);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0, cudaGetLastError() after the launch, or a
// tensor-map error (block_ell_xres_error_string names each).  x: (B,
// n_cols) and tiles: (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16 (bf16 = 1),
// both 16-byte aligned; tile_ids/col_blk: (n_rb, KB) int32; out: (B, n_out)
// f32.  TM and TN are multiples of 128; all arrays contiguous.  BT (8, 16,
// 32, 64 or 128) is the row tile and smem the dynamic shared memory of a
// block, as ops/block_ell.launch_plan chooses them; fewer bytes than BT's
// layout needs are refused.
int block_ell_xres(const void* x, const void* tiles, const void* tile_ids,
                   const void* col_blk, void* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, int bf16, int n_uniq, int BT,
                   int smem, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || n_out <= 0 || n_uniq <= 0 || smem <= 0 ||
      (long long)n_uniq * TM > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, tmap;
  int err = tensor_map(&xmap, x, B, n_cols, BT, bf16);
  if (err == 0) err = tensor_map(&tmap, tiles, (uint64_t)n_uniq * TM, TN, BM, bf16);
  if (err != 0) return err;
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(xmap, tmap, ids, cols, o, B, n_rb, KB, TM, TN, n_out, BT,
                                   smem, s)
           : launch<float>(xmap, tmap, ids, cols, o, B, n_rb, KB, TM, TN, n_out, BT, smem, s));
}

const char* block_ell_xres_error_string(int err) { return error_string(err); }

}  // extern "C"
