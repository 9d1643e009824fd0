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
// B = 1 runs a 32-row tile and conv3_x (R = 7) an 8-row one.  8 x 8
// accumulators a thread, 16-byte conflict-free reads out of shared memory.
// Blocks of one period row sit next to each other on grid.x, so the tiles
// they share come from L2.  Each output is written once, with no atomics:
// results are run-to-run deterministic.
//
// The f32 walk's feed.  A ring step multiplies 128 bytes of contraction:
// the slot's 128 x 128-byte tile panel, the same for every pair row, and the
// BT x 128-byte x panel, each pair row from its own x block,
// col_blk[s+rho+j*P, k].  The tile panel arrives as one TMA box
// (CU_TENSOR_MAP_SWIZZLE_128B, 1024-byte-aligned stage) onto the stage's
// full mbarrier, issued by thread 0.  The x rows are copied by the threads
// that read them: the 16 threads that read rows r*8 .. r*8 + 7 in their k
// group's chunks issue those chunks' cp.async (CPK / 2, 1 to 4 a thread a
// step) to the addresses Swizzle128 reads, a thread one row, so a rep
// boundary anywhere in the tile (B = 24, 33, 100) only changes a row's
// offset, and no stage row is written twice.  A thread waits for its own
// copies (one cp.async group a step) and its warp's (__syncwarp), every warp
// for the tile on full, and each warp releases the stage on its empty
// mbarrier; thread 0 refills a stage two steps after its use, once every
// warp has released it, S - 2 steps ahead.  No block-wide barrier runs in
// the walk.  S, as many stages as keep the blocks an SM that the registers
// allow (fma_stages): BT 8: 4 stages, 70,720 bytes (3 blocks an SM); 16: 6,
// 111,712 (2); 32: 5, 103,504 (2); 64: 4, 99,392 (2); 128: 7, 230,512 (1).
//
// Measured (H100 80GB HBM3, 700 W; an operand of conv1_2's shape, P = 784,
// R = 31, KB = 19 with one zero slot, B = 32): 57-58% of the FMA bound,
// against 52-53% on the cp.async ring whose every thread copied 8 chunks a
// step and met a block barrier every step.  The same FMA core with no copies
// and no waits reaches 66-67%, which bounds any feed of this core; what the
// feed still costs is its copies, not its waits: waiting on the
// barriers a step earlier, refilling a stage three steps after its use, or
// copying whole 128-byte rows an instruction (row pointers shuffled across
// the half-warp) each moved it by 1% or less; TMA boxes for x (gcd(B, BT)
// rows of one rep a box, from warp 0, where B is a multiple of 8) were
// slower: 54.9% at B = 32, 49.6% at B = 8 (16 boxes a step).

// bf16 tiles run on the tensor cores, as the Pallas kernel's bf16 dot runs
// on the matrix unit (block_ell_wgmma.cuh): the same walk, grid and row
// tile on the cp.async ring, each pair row's x offset computed one non-zero
// slot ahead into shared memory (offset buffers, two), the panels staged at
// 128-byte-swizzled addresses and multiplied by wgmma.  At conv1_2 and B = 32 the operations bound falls from
// 7.04 ms of f32 FMAs to 0.48 ms at 989 TFLOP/s, beside 0.2 ms for the bytes
// it must move; what it stages is more, since every block reads its slot's
// tile panel and gathers its x rows again (L2 serves most of it).
//
// f32 tiles under PRECISION='default' run the same wgmma walk as tf32 x tf32
// products (the Pallas dot at Precision.DEFAULT, :566-569; four m64nBTk8
// steps a 128-wide slot, 13 low mantissa bits of each operand dropped,
// block_ell_wgmma.cuh): at conv1_2 and B = 32 the operations bound is
// 0.95 ms at 494.7 TFLOP/s dense TF32, beside 0.4 ms for its f32 bytes.

#include <climits>

#include "block_ell_core.cuh"
#include "block_ell_wgmma.cuh"

namespace {

using namespace bc;

template <class C>
__host__ __device__ constexpr size_t xoff_bytes() {
  return 2 * C::BT * sizeof(long long);  // two slots' row offsets
}

// The f32 kernel's ring depth at each row tile: the most stages that keep
// as many blocks an SM as its registers allow (one at BT = 128, two at 16 to
// 64), three at BT = 8 as before.  A stage is refilled S - 2 steps ahead.
template <int BT>
__host__ __device__ constexpr int fma_stages() {
  return BT == 128 ? 7 : BT == 64 ? 4 : BT == 32 ? 5 : BT == 16 ? 6 : 4;
}

// Shared memory of the f32 kernel: 1024 bytes of alignment slack, S stages of
// (x panel, tile panel), then a full and an empty mbarrier a stage; the k
// groups' fold reuses the ring.
template <class C>
__host__ __device__ constexpr size_t fma_smem() {
  constexpr int S = fma_stages<C::BT>();
  static_assert(C::FOLD_BYTES <= (size_t)S * (C::X_BYTES + C::PANEL_BYTES), "fold");
  return 1024 + (size_t)S * (C::X_BYTES + C::PANEL_BYTES) + 2 * S * sizeof(uint64_t);
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1) periodic_kernel(
    const __grid_constant__ CUtensorMap tmap, const float* __restrict__ x,
    const int* __restrict__ tile_ids, const int* __restrict__ col_blk,
    float* __restrict__ out, int B, int n_cols, int KB, int TM, int TN,
    int s, int P, int R) {
  constexpr int S = fma_stages<C::BT>();
  constexpr int AHEAD = S - 2;              // steps in flight beyond the one multiplied
  constexpr int STAGE = C::XT + C::PANEL;   // floats of a stage: x panel, tile panel
  static_assert(AHEAD >= 1 && C::CPK % 2 == 0, "ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  float* ring = reinterpret_cast<float*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + (size_t)S * STAGE * sizeof(float));
  uint64_t* empty = full + S;

  const int tid = threadIdx.x;
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  const long long q0 = (long long)blockIdx.x * C::BT;  // first (rep, image) pair
  const long long n_pairs = (long long)R * B;
  const int per_row = TM / BM;
  const int rho = blockIdx.y / per_row;               // period row
  const int m0 = (blockIdx.y % per_row) * BM;         // first tile row of the chunk

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      be::mbar_init(full + i, 1);
      be::mbar_init(empty + i, C::NT / 32);
    }
    be::fence_barrier_init();
  }
  __syncthreads();  // the last block-wide barrier before the fold

  // The 16 threads (tx, r, kg) read rows r*8 .. r*8 + 7 of the x panel, in
  // chunks kg*CPK .. + CPK - 1, and nobody else reads them: they copy them
  // too, thread tx row xm, chunks kg*CPK + tx/8 + 2u, to the addresses
  // Swizzle128 reads (xdst).  Pair row xm is rep j, image b: its x row and
  // its rep's column-block row; a pair past the last is zero-filled.
  const int xm = r * 8 + (tx & 7);
  const int q1 = kg * C::CPK + (tx >> 3);
  int xdst[C::CPK / 2];
#pragma unroll
  for (int u = 0; u < C::CPK / 2; ++u) xdst[u] = Swizzle128::at<C>(xm, q1 + 2 * u);
  const bool live = q0 + xm < n_pairs;
  const float* xrow = x + q1 * C::V;
  const int* cbrow = col_blk;
  if (live) {
    const long long q = q0 + xm;
    const int j = (int)(q / B), b = (int)(q % B);
    xrow += (size_t)b * n_cols;
    cbrow = col_blk + ((size_t)s + rho + (size_t)j * P) * KB;
  }
  const int* ids = tile_ids + (size_t)(s + rho) * KB;
  auto next_nz = [&](int k) {
    do ++k; while (k < KB && ids[k] <= 0);
    return k;
  };
  int nz = 0;
  for (int k = 0; k < KB; ++k) nz += ids[k] > 0;
  const int per_slot = TN / C::BK;
  const int steps = nz * per_slot;

  // The copy cursor: column chunk pc of non-zero slot pk, whose tile rows
  // start at trow and this thread's x chunks at xsrc (x itself for a dead
  // pair); the next non-zero slot nk's tile id and column block are read a
  // slot ahead.
  int pk = next_nz(-1), pc = 0;
  int trow = pk < KB ? ids[pk] * TM + m0 : 0;
  const float* xsrc = live && pk < KB ? xrow + (size_t)cbrow[pk] * TN : x;
  int nk = pk < KB ? next_nz(pk) : KB;
  int nid = nk < KB ? ids[nk] : 0, ncb = nk < KB && live ? cbrow[nk] : 0;
  // The copies of the cursor's step into stage st: the tile panel as one TMA
  // box onto full[st] (thread 0), this thread's x chunks by cp.async.
  auto issue = [&](int st) {
    float* xs = ring + (size_t)st * STAGE;
    if (tid == 0) {
      be::mbar_expect_tx(full + st, C::PANEL_BYTES);
      be::tma_load_2d(xs + C::XT, &tmap, pc * C::BK, trow, full + st);
    }
    const float* src = xsrc + pc * C::BK;
#pragma unroll
    for (int u = 0; u < C::CPK / 2; ++u) be::cp_async16(xs + xdst[u], src + 2 * u * C::V, live);
    if (++pc == per_slot) {
      pc = 0;
      pk = nk;
      trow = nid * TM + m0;
      xsrc = live ? xrow + (size_t)ncb * TN : x;
      if (pk < KB) {
        nk = next_nz(pk);
        if (nk < KB) {
          nid = ids[nk];
          if (live) ncb = cbrow[nk];
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // Step t sits in stage t % S, its (t / S)-th fill.  At step t every
  // thread starts step t + AHEAD's copies into the stage step t - 2 used
  // (fs, its fill of parity fph): its own x chunks (its half-warp is done
  // with them), and thread 0 the tile panel once every warp has released
  // that stage on empty.  A thread waits for its own x copies (cp.async
  // groups, one a step) and its warp's (__syncwarp), and for the tile on
  // full[st] (parity ph); its warp then releases the stage.
#pragma unroll
  for (int t = 0; t < AHEAD; ++t) {
    if (t < steps) issue(t);
    be::cp_async_commit();
  }
  int st = 0, fs = AHEAD;
  unsigned ph = 0, fph = 0;
  for (int t = 0; t < steps; ++t) {
    if (t + AHEAD < steps) {
      if (tid == 0 && t >= S - AHEAD) be::mbar_wait(empty + fs, fph ^ 1);
      issue(fs);
    }
    be::cp_async_commit();
    be::cp_async_wait<AHEAD>();
    __syncwarp();
    be::mbar_wait(full + st, ph);
    const float* xs = ring + (size_t)st * STAGE;
    fma_step<C, Swizzle128>(xs, xs + C::XT, tx, r, kg, acc);
    __syncwarp();
    if ((tid & 31) == 0) be::mbar_arrive(empty + st);
    if (++st == S) {
      st = 0;
      ph ^= 1;
    }
    if (++fs == S) {
      fs = 0;
      fph ^= 1;
    }
  }

  // pair row q (rep j, image b) -> out[b, (j*P + rho)*TM + m0 + c]
  const size_t n_out = (size_t)P * R * TM;
  fold_and_store<C>(acc, base, tid, BM, [&](int row) -> float* {
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

cudaError_t launch(const CUtensorMap& tmap, const float* x, const int* ids, const int* cols,
                   float* out, int B, int n_cols, int KB, int TM, int TN, int s, int P, int R,
                   int BT, size_t bytes, cudaStream_t stream) {
  return with_tile<float>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < fma_smem<C>()) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(periodic_kernel<C>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const long long n_pairs = (long long)R * B;
    const dim3 grid((unsigned)((n_pairs + C::BT - 1) / C::BT), (unsigned)(P * (TM / BM)));
    periodic_kernel<C><<<grid, C::NT, bytes, stream>>>(tmap, x, ids, cols, out, B, n_cols, KB,
                                                       TM, TN, s, P, R);
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

// Launch on `stream`; returns 0, cudaGetLastError() after the launch, or a
// tensor-map error (periodic_block_ell_error_string names each).  x: (B,
// n_cols) and tiles: (n_uniq, TM, TN), both 16-byte aligned, and the
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
                       int BT, int smem, int n_uniq, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || P <= 0 || R <= 0 || s < 0 || smem <= 0 ||
      kind < 0 || kind > 2 || n_uniq <= 0 || (long long)n_uniq * TM > INT_MAX ||
      (long long)P * (TM / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* ids = static_cast<const int*>(tile_ids);
  const int* cols = static_cast<const int*>(col_blk);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1)
    return static_cast<int>(launch_wgmma<__nv_bfloat16>(x, tiles, ids, cols, o, B, n_cols, KB,
                                                         TM, TN, s, P, R, BT, smem, st));
  if (kind == 2)
    return static_cast<int>(launch_wgmma<float>(x, tiles, ids, cols, o, B, n_cols, KB, TM, TN,
                                                s, P, R, BT, smem, st));
  CUtensorMap tmap;
  const int err = tensor_map(&tmap, tiles, (uint64_t)n_uniq * TM, TN, BM, false);
  if (err != 0) return err;
  return static_cast<int>(launch(tmap, static_cast<const float*>(x), ids, cols, o, B, n_cols,
                                 KB, TM, TN, s, P, R, BT, smem, st));
}

const char* periodic_block_ell_error_string(int err) { return error_string(err); }

}  // extern "C"
