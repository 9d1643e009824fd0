// Block-ELL slot walk that keeps a staged tile across repeated ids, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel block_ell_matmul_grid of
// keynet_tpu/ops/pallas_kernels.py (:449-484, body _kernel_grid :429-445),
// with the shared contract: y[:, r*TM:(r+1)*TM] = sum_k x[:, col_blk[r,k]*TN
// : +TN] @ tiles[tile_ids[r,k]]^T, f32 accumulation and output, a slot with
// tile id 0 skipped (as _kernel_grid skips it, :440); width n_rb*TM.
//
// On the TPU the grid is (n_rb, KB), one step per slot in row-major order,
// and Mosaic's pipeline skips the tile copy when consecutive steps name the
// same tile (:451-458), the step from (r, KB-1) to (r+1, 0) included: free
// dedup for periodic or grouped layers.
//
// What bounds it on this card: as block_ell_xres.cu (2*TM*TN FLOPs per
// non-zero slot and image against the distinct tiles, x and the output; f32
// tiles stay IEEE, so the FMA pipes are the ceiling).  At few images a slot
// walk that reads a tile a slot moves many times the distinct tiles' bytes;
// the copies this kernel skips are the bytes it saves.
//
// What the design does about it.  block_ell_core.cuh's register tiling (row
// tile BT in {8, ..., 128} from ops/block_ell.launch_plan, 8 x 8
// accumulators a thread, k groups folded in a fixed order).  A block owns one
// batch tile and one 128-wide output chunk of a run of G consecutive
// row-blocks (launch_plan picks G), and walks their slots (r, k) in row-major
// order, as the Pallas grid does.  One producer warp (one lane) issues every
// copy as a TMA tensor copy onto mbarriers (at BT = 128 a producer
// warpgroup, whose registers go to the consumers); the consumer warps run
// the FMAs and release each buffer through an empty barrier, one arrival a
// warp.
//  - Keep mode, where two 128 x TN tile slices and the x ring fit a block's
//    shared memory (f32 TN = 128, bf16 TN <= 256): a slice is copied whole,
//    in 128 x 128-byte panels, only when a non-zero slot's id differs from
//    the last staged non-zero id, so a, 0, a runs and runs across a row
//    boundary keep it; the next slice fills the other buffer while the
//    current one is read.  x panels stream through a STAGES-deep ring.
//  - Stream mode, for wider slices: every step's x panel and tile panel
//    stream through the ring, as in block_ell_xres.cu (no dedup, the same
//    result), so every TN that is a multiple of 128 is taken.
// When a row-block's last slot is done, the consumers fold its k groups
// (a named barrier among them), store its BT x 128 outputs and start afresh.
// The producer adds the tile copies it issued (slices, or slots in stream
// mode) to a device counter when one is given; the outputs are written once,
// with no atomics, so results are run-to-run deterministic.  Panels are
// swizzled (CU_TENSOR_MAP_SWIZZLE_128B) and read through bc::Swizzle128.

#include <climits>

#include "block_ell_core.cuh"

namespace {

using namespace bc;

constexpr int NBAR = 2 * STAGES + 4;  // full[STAGES], empty[STAGES], slice full[2], empty[2]

// Consumer threads: keep mode leaves room for one block an SM, so every row
// tile runs 8 consumer warps (k groups added, Cfg's MIN_NT), 4 at BT = 8 (one
// 16-byte chunk a k group).  The producer: one warp beside 4 consumer warps,
// a warpgroup beside 8.  Nine warps would put three on one of the SM's four
// schedulers and cap every thread at 168 registers (the consumers spilled);
// with twelve the producer warpgroup gives its registers to the consumers
// (setmaxnreg: 40 and 232 a thread).
constexpr int CONSUMERS = 256;
template <class C>
__host__ __device__ constexpr int producer_threads() {
  return C::NT >= 256 ? 128 : 32;
}
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared memory (bytes) of a launch: 1024 bytes of alignment slack; in keep
// mode two 128 x TN tile slices and STAGES x panels, in stream mode STAGES
// (x panel, tile panel) stages; then the k groups' fold and the mbarriers.
template <class C>
size_t grid_smem(int TN, bool keep) {
  const size_t slice = keep ? (size_t)BM * TN * sizeof(typename C::Elem) : 0;
  const size_t stage = C::X_BYTES + (keep ? 0 : C::PANEL_BYTES);
  return 1024 + 2 * slice + STAGES * stage + C::FOLD_BYTES + NBAR * sizeof(uint64_t);
}

template <class C, bool KEEP>
__global__ void __launch_bounds__(C::NT + producer_threads<C>(), 1) grid_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap tmap,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, unsigned long long* __restrict__ copies, int B, int n_rb, int KB,
    int TM, int TN, int n_out, int G) {
  using T = typename C::Elem;
  constexpr int XSTAGE = C::XT + (KEEP ? 0 : C::PANEL);  // elements of a ring stage
  constexpr int WARPS = C::NT / 32;                       // consumer warps
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  const int per_slot = TN / C::BK;           // 128-byte panels of a slot
  const int slice = KEEP ? BM * TN : 0;      // elements of a kept tile slice
  T* slices = reinterpret_cast<T*>(base);
  T* ring = slices + 2 * (size_t)slice;
  float* red = reinterpret_cast<float*>(ring + (size_t)STAGES * XSTAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(red) +
                                               C::FOLD_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* slice_full = full + 2 * STAGES;
  uint64_t* slice_empty = slice_full + 2;

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * C::BT;
  const int per_rb = TM / BM;
  const int rb0 = (blockIdx.y / per_rb) * G;
  const int rb1 = min(rb0 + G, n_rb);
  const int m0 = (blockIdx.y % per_rb) * BM;  // first tile row of this chunk

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      be::mbar_init(full + s, 1);
      be::mbar_init(empty + s, WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      be::mbar_init(slice_full + s, 1);
      be::mbar_init(slice_empty + s, WARPS);
    }
    be::fence_barrier_init();
  }
  __syncthreads();  // the last block-wide barrier: the roles split below

  // Both roles walk the same non-zero slots in the same order; slice n (the
  // n-th distinct run of ids) sits in buffer n & 1, at its (n >> 1)-th use.
  constexpr bool REGS = producer_threads<C>() == 128;
  if (tid >= C::NT) {  // the producer: its first lane issues every copy
    if constexpr (REGS) be::max_regs_dec<PRODUCER_REGS>();
    if (tid != C::NT) return;
    int st = 0, n = -1, last = 0;
    unsigned ph = 0;
    unsigned long long issued = 0;
    for (int rb = rb0; rb < rb1; ++rb) {
      const int* ids = tile_ids + (size_t)rb * KB;
      const int* cbs = col_blk + (size_t)rb * KB;
      for (int k = 0; k < KB; ++k) {
        const int t = ids[k];
        if (t <= 0) continue;
        const int trow = t * TM + m0;
        if (!KEEP) {
          ++issued;
        } else if (t != last) {
          ++n;
          last = t;
          ++issued;
          const int sb = n & 1;
          be::mbar_wait(slice_empty + sb, ((n >> 1) & 1) ^ 1);  // use n-2 released
          be::mbar_expect_tx(slice_full + sb, per_slot * C::PANEL_BYTES);
          for (int p = 0; p < per_slot; ++p)
            be::tma_load_2d(slices + (size_t)sb * slice + p * C::PANEL, &tmap, p * C::BK, trow,
                            slice_full + sb);
        }
        const int xc = cbs[k] * TN;
        for (int p = 0; p < per_slot; ++p) {
          be::mbar_wait(empty + st, ph ^ 1);  // the stage's last round released
          T* xs = ring + (size_t)st * XSTAGE;
          be::mbar_expect_tx(full + st, C::X_BYTES + (KEEP ? 0 : C::PANEL_BYTES));
          be::tma_load_2d(xs, &xmap, xc + p * C::BK, b0, full + st);
          if (!KEEP) be::tma_load_2d(xs + C::XT, &tmap, p * C::BK, trow, full + st);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    if (copies != nullptr) atomicAdd(copies, issued);
    return;
  }

  // the consumer warps
  if constexpr (REGS) be::max_regs_inc<CONSUMER_REGS>();
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  auto release = [&](uint64_t* bar) {  // this warp is done reading the buffer
    __syncwarp();
    if (tid % 32 == 0) be::mbar_arrive(bar);
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int st = 0, n = -1, last = 0;
  unsigned ph = 0;
  for (int rb = rb0; rb < rb1; ++rb) {
    const int* ids = tile_ids + (size_t)rb * KB;
    for (int k = 0; k < KB; ++k) {
      const int t = ids[k];
      if (t <= 0) continue;
      const T* ts = nullptr;
      if constexpr (KEEP) {
        if (t != last) {
          if (n >= 0) release(slice_empty + (n & 1));
          ++n;
          last = t;
          be::mbar_wait(slice_full + (n & 1), (n >> 1) & 1);
        }
        ts = slices + (size_t)(n & 1) * slice;
      }
      for (int p = 0; p < per_slot; ++p) {
        be::mbar_wait(full + st, ph);
        const T* xs = ring + (size_t)st * XSTAGE;
        fma_step<C, Swizzle128>(xs, KEEP ? ts + p * C::PANEL : xs + C::XT, tx, r, kg, acc);
        release(empty + st);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    // row-block rb is done: fold, store its BT x 128 outputs, start afresh
    const int c0 = rb * TM + m0;
    if (fold<C>(acc, red, tid, [] { be::named_sync(1, C::NT); }))
      store<C>(acc, tid, n_out - c0, [&](int row) -> float* {
        return b0 + row < B ? out + (size_t)(b0 + row) * n_out + c0 : nullptr;
      });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

template <class C, bool KEEP>
cudaError_t go(const CUtensorMap& xmap, const CUtensorMap& tmap, const int* ids,
               const int* cols, float* out, unsigned long long* copies, int B, int n_rb,
               int KB, int TM, int TN, int n_out, int G, size_t bytes, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const cudaError_t err = allow_smem_once(grid_kernel<C, KEEP>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + C::BT - 1) / C::BT, ((n_rb + G - 1) / G) * (TM / BM));
  grid_kernel<C, KEEP><<<grid, C::NT + producer_threads<C>(), bytes, stream>>>(
      xmap, tmap, ids, cols, out, copies, B, n_rb, KB, TM, TN, n_out, G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& tmap, const int* ids,
                   const int* cols, float* out, unsigned long long* copies, int B, int n_rb,
                   int KB, int TM, int TN, int n_out, int BT, size_t bytes, int G, bool keep,
                   cudaStream_t stream) {
  return with_tile<T, CONSUMERS>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < grid_smem<C>(TN, keep)) return cudaErrorInvalidValue;
    return keep ? go<C, true>(xmap, tmap, ids, cols, out, copies, B, n_rb, KB, TM, TN, n_out,
                              G, bytes, stream)
                : go<C, false>(xmap, tmap, ids, cols, out, copies, B, n_rb, KB, TM, TN, n_out,
                               G, bytes, stream);
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns 0, cudaGetLastError() after the launch, or a
// tensor-map error (block_ell_grid_error_string names each).  x: (B, n_cols)
// and tiles: (n_uniq, TM, TN) in f32 (bf16 = 0) or bf16 (bf16 = 1), both
// 16-byte aligned; tile_ids/col_blk: (n_rb, KB) int32; out: (B, n_out) f32
// with n_out <= n_rb*TM.  TM and TN are multiples of 128; all arrays
// contiguous.  BT (8, 16, 32, 64 or 128), smem, G (row-blocks a block) and
// keep (1: keep mode) as ops/block_ell.launch_plan chooses them; fewer bytes
// than the layout needs are refused.  copies: a device counter the tile
// copies issued are added to, or null.
int block_ell_grid(const void* x, const void* tiles, const void* tile_ids,
                   const void* col_blk, void* out, int B, int n_cols, int n_rb,
                   int KB, int TM, int TN, int n_out, int bf16, int n_uniq, int BT,
                   int smem, int G, int keep, void* copies, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || n_out <= 0 || n_uniq <= 0 || smem <= 0 ||
      G <= 0 || (long long)n_uniq * TM > INT_MAX || (long long)n_rb * TM < n_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_rows = (n_out + TM - 1) / TM;  // row-blocks with output columns
  if ((long long)((n_rows + G - 1) / G) * (TM / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, tmap;
  int err = tensor_map(&xmap, x, B, n_cols, BT, bf16);
  if (err == 0) err = tensor_map(&tmap, tiles, (uint64_t)n_uniq * TM, TN, BM, bf16);
  if (err != 0) return err;
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  auto* cnt = static_cast<unsigned long long*>(copies);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(xmap, tmap, ids, cols, o, cnt, B, n_rows, KB, TM, TN, n_out,
                                   BT, smem, G, keep != 0, s)
           : launch<float>(xmap, tmap, ids, cols, o, cnt, B, n_rows, KB, TM, TN, n_out, BT,
                           smem, G, keep != 0, s));
}

const char* block_ell_grid_error_string(int err) { return error_string(err); }

}  // extern "C"
