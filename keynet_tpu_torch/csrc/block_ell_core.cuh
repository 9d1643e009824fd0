// The register-tiled FMA core of the slot walk (block_ell.cu) and the
// periodic kernel (periodic_block_ell.cu): a cp.async ring of 128-byte-wide
// panels, with the row tile BT a template parameter.
//
// A block computes a BT x 128 output tile: BT rows (images, or (rep, image)
// pairs) by 128 output columns (rows of a tile).  Each step stages a panel of
// 128 bytes of contraction (BK = 32 f32 or 64 bf16 columns, one full 128-byte
// line of each tile row): the 128 x BK panel of the slot's tile and the
// BT x BK panel of the x rows, both row-major with a row stride of BK + one
// 16-byte vector (block_ell_stage.cuh's layout: an odd number of 16-byte
// units, so the eight threads of a quarter-warp that read tile rows
// tx + 16*j hit eight bank groups, and x rows are broadcast).  STAGES - 1
// steps are in flight while one is multiplied, across slot boundaries, so
// the next slot's tile arrives while this slot's FMAs run.
//
// Threads.  Thread (tx, r, kg) owns rows r*8 + i (i < 8) and columns
// tx + 16*j (j < 8): 8 x 8 accumulators.  RT = BT / 8 row groups cover the
// tile; where that leaves fewer than 128 threads (BT = 8, 16, 32), KS k
// groups split each panel's four 16-byte chunks between them and their
// partial sums are folded in a fixed order at the end, so every tile element
// staged is still read by few threads and the block keeps enough warps.
//
//   BT    threads  RT  KS   ring (STAGES = 3)
//   8     64       1   4    58,752 B
//   16    128      2   4    62,208 B
//   32    128      4   2    69,120 B
//   64    128      8   1    82,944 B
//   128   256      16  1    110,592 B
//
// The kernels ask for one block an SM (__launch_bounds__(NT, 1)), which
// leaves ptxas free to keep the next chunk's shared-memory reads in flight:
// left to its default it gave the periodic 128-row tile 129 registers and
// ran it 32% slower.  On the H100 80GB HBM3 a cap that held 256-thread
// blocks at two an SM (it spilled), a 64-byte panel, four stages and a
// rolled chunk loop all measured within a few percent of this shape or
// slower (PERF.md, kernel findings).
//
// Numbers.  bf16 is widened to f32 as it is read out of shared memory
// (exact), products and sums are IEEE f32 fmaf on the FMA pipes (no TF32),
// and each output is written once with no atomics: results are run-to-run
// deterministic.  ops/block_ell.launch_plan computes the ring's bytes of the
// table above and passes them to the launch, which refuses fewer than the
// row tile's layout needs.

#pragma once

#include "block_ell_stage.cuh"

namespace bc {

using be::cp_async16;
using be::cp_async_commit;
using be::widen;

constexpr int BM = 128;       // output columns per block (rows of a tile panel)
constexpr int CHUNKS = 8;     // 16-byte chunks of contraction a ring step stages
constexpr int STAGES = 3;     // ring depth

template <typename T, int BT_>
struct Cfg {
  static constexpr int BT = BT_;
  static constexpr int RB = 8;                         // rows per thread
  static constexpr int RT = BT / RB;                   // row groups
  static constexpr int KS = RT >= 8 ? 1 : (RT >= 4 ? 2 : 4);  // k groups
  static constexpr int GT = 16 * RT;                   // threads of one k group
  static constexpr int NT = GT * KS;                   // threads per block
  static constexpr int V = be::Vec<T>::N;              // elements in 16 bytes
  static constexpr int BK = CHUNKS * V;                // contraction columns a step
  static constexpr int CPK = CHUNKS / KS;              // 16-byte chunks per k group
  static constexpr int S = BK + V;                     // panel row stride
  static constexpr int X = BT * S;                     // x panel elements
  static constexpr int STAGE = X + BM * S;             // x panel + tile panel
  static_assert(BT % RB == 0 && CHUNKS % KS == 0, "row tile");

  static constexpr size_t RING_BYTES = (size_t)STAGES * STAGE * sizeof(T);
};

// Dynamic shared memory of the ring; the fold of the KS - 1 upper k groups'
// partial sums reuses it.
template <class C>
constexpr size_t ring_smem() {
  constexpr size_t fold = (size_t)(C::KS - 1) * C::GT * 64 * sizeof(float);
  return C::RING_BYTES > fold ? C::RING_BYTES : fold;
}

// Start the copies of the BM x BK tile panel at src (row stride src_stride).
template <class C, typename T>
__device__ __forceinline__ void stage_tile(T* ts, const T* src, size_t src_stride, int tid) {
#pragma unroll
  for (int i = tid; i < BM * CHUNKS; i += C::NT) {
    const int m = i / CHUNKS, q = (i % CHUNKS) * C::V;
    cp_async16(ts + m * C::S + q, src + (size_t)m * src_stride + q, true);
  }
}

// Start the copies of the BT x BK x panel whose row `row` starts at
// src + off(row), or is zero-filled where off(row) < 0.
template <class C, typename T, class Off>
__device__ __forceinline__ void stage_x(T* xs, const T* src, Off off, int tid) {
#pragma unroll
  for (int i = tid; i < C::BT * CHUNKS; i += C::NT) {
    const int r = i / CHUNKS, q = (i % CHUNKS) * C::V;
    const long long o = off(r);
    cp_async16(xs + r * C::S + q, o >= 0 ? src + o + q : src, o >= 0);
  }
}

// acc[i][j] += sum over this thread's chunks of one staged step: per
// 16-byte chunk, 8 x reads (broadcast) and 8 tile reads feed 64*V FMAs.
template <class C, typename T>
__device__ __forceinline__ void fma_step(const T* xs, const T* ts, int tx, int r, int kg,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int cc = 0; cc < C::CPK; ++cc) {
    const int c = (kg * C::CPK + cc) * C::V;
    float a[8][C::V];
#pragma unroll
    for (int i = 0; i < 8; ++i) widen(xs + (r * 8 + i) * C::S + c, a[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[C::V];
      widen(ts + (tx + 16 * j) * C::S + c, w);
#pragma unroll
      for (int v = 0; v < C::V; ++v)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i][v], w[v], acc[i][j]);
    }
  }
}

// The ring: run `steps` steps; load(stage_ptr) starts the copies of the next
// step (every thread calls it), and the FMAs run on each landed stage.
template <class C, typename T, class Load>
__device__ __forceinline__ void run_ring(T* smem, int steps, int tid, int tx, int r, int kg,
                                         float (&acc)[8][8], Load load) {
  // prologue: STAGES - 1 steps in flight (a group is committed even when
  // empty, so wait_group counts steps)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(smem + (size_t)s * C::STAGE);
    cp_async_commit();
  }
  int cur = 0, nxt = STAGES - 1;  // ring slots of this step and of the step loaded now
  for (int step = 0; step < steps; ++step) {
    be::cp_async_wait<STAGES - 2>();  // this step's copies have landed ...
    __syncthreads();                  // ... for every thread, and step - 1 is done
    if (step + STAGES - 1 < steps) load(smem + (size_t)nxt * C::STAGE);
    cp_async_commit();
    const T* xs = smem + (size_t)cur * C::STAGE;
    fma_step<C>(xs, xs + C::X, tx, r, kg, acc);
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
  be::cp_async_wait<0>();
}

// Fold the k groups' partial sums (fixed order: group 0, 1, ...) through the
// ring's shared memory, then store: row_ptr(row) is the output row of tile
// row `row` (nullptr: none), columns tx + 16*j below cols_valid are written.
template <class C, class RowPtr>
__device__ __forceinline__ void fold_and_store(float (&acc)[8][8], void* smem, int tid,
                                               int cols_valid, RowPtr row_ptr) {
  const int g = tid % C::GT, kg = tid / C::GT;
  if constexpr (C::KS > 1) {
    float* red = static_cast<float*>(smem);
    __syncthreads();  // every thread is done reading the ring
    if (kg > 0) {
#pragma unroll
      for (int e = 0; e < 64; ++e) red[((kg - 1) * 64 + e) * C::GT + g] = acc[e / 8][e % 8];
    }
    __syncthreads();
    if (kg > 0) return;
#pragma unroll
    for (int k = 1; k < C::KS; ++k)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e / 8][e % 8] += red[((k - 1) * 64 + e) * C::GT + g];
  }
  const int tx = g % 16, r = g / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = row_ptr(r * 8 + i);
    if (o == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c < cols_valid) o[c] = acc[i][j];
    }
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` once per instantiation.
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = be::allow_smem(kernel, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Dispatch a functor over the instantiated row tiles: f(Cfg<T, BT>{}) for the
// run-time BT; returns cudaErrorInvalidValue for any other BT.
template <typename T, class F>
cudaError_t with_tile(int BT, F f) {
  switch (BT) {
    case 8: return f(Cfg<T, 8>{});
    case 16: return f(Cfg<T, 16>{});
    case 32: return f(Cfg<T, 32>{});
    case 64: return f(Cfg<T, 64>{});
    case 128: return f(Cfg<T, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bc
