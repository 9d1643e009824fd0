// The register-tiled FMA core of the Block-ELL kernels: the slot walk
// (block_ell.cu) on a cp.async ring, the periodic kernel's f32 walk
// (periodic_block_ell.cu) on TMA tile copies and cp.async x copies, xres
// (block_ell_xres.cu) and grid (block_ell_grid.cu) on TMA copies;
// 128-byte-wide panels, with the row tile BT a template parameter.
//
// A block computes a BT x 128 output tile: BT rows (images, or (rep, image)
// pairs) by 128 output columns (rows of a tile).  Each step multiplies a
// panel of 128 bytes of contraction (BK = 32 f32 or 64 bf16 columns, one
// full 128-byte line of each tile row): the 128 x BK panel of the slot's
// tile and the BT x BK panel of the x rows, both row-major.  Two layouts of
// a staged panel (Padded, Swizzle128 below) keep the reads free of bank
// conflicts: the eight threads of a quarter-warp that read tile rows
// tx + 16*j hit eight bank groups, and x rows are broadcast.  STAGES - 1
// steps are in flight while one is multiplied, across slot boundaries, so
// the next slot's tile arrives while this slot's FMAs run.
//
// Threads.  Thread (tx, r, kg) owns rows r*8 + i (i < 8) and columns
// tx + 16*j (j < 8): 8 x 8 accumulators.  RT = BT / 8 row groups cover the
// tile; where that leaves fewer than 128 threads (BT = 8, 16, 32), KS k
// groups split each panel's eight 16-byte chunks between them and their
// partial sums are folded in a fixed order at the end, so every tile element
// staged is still read by few threads and the block keeps enough warps.
//
//   BT    threads  RT  KS   cp.async ring (STAGES = 3)
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
// deterministic.  ops/block_ell.launch_plan computes each kernel's shared
// memory and passes it to the launch, which refuses fewer bytes than the
// row tile's layout needs.

#pragma once

#include <cstdio>
#include <mutex>

#include "block_ell_stage.cuh"

namespace bc {

using be::cp_async16;
using be::cp_async_commit;
using be::widen;

constexpr int BM = 128;       // output columns per block (rows of a tile panel)
constexpr int CHUNKS = 8;     // 16-byte chunks of contraction a ring step stages
constexpr int STAGES = 3;     // ring depth

// MIN_NT: more k groups (at most one 16-byte chunk each) until the block
// has that many threads, for a kernel that runs one block an SM.
template <typename T, int BT_, int MIN_NT = 0>
struct Cfg {
  using Elem = T;
  static constexpr int BT = BT_;
  static constexpr int RB = 8;                         // rows per thread
  static constexpr int RT = BT / RB;                   // row groups
  static constexpr int GT = 16 * RT;                   // threads of one k group
  static constexpr int KS0 = RT >= 8 ? 1 : (RT >= 4 ? 2 : 4);
  static constexpr int KS_MIN = MIN_NT / GT < CHUNKS ? MIN_NT / GT : CHUNKS;
  static constexpr int KS = KS_MIN > KS0 ? KS_MIN : KS0;   // k groups
  static constexpr int NT = GT * KS;                   // threads per block
  static constexpr int V = be::Vec<T>::N;              // elements in 16 bytes
  static constexpr int BK = CHUNKS * V;                // contraction columns a step
  static constexpr int CPK = CHUNKS / KS;              // 16-byte chunks per k group
  static constexpr int S = BK + V;                     // padded panel row stride
  static constexpr int X = BT * S;                     // padded x panel elements
  static constexpr int STAGE = X + BM * S;             // padded x panel + tile panel
  static constexpr int XT = BT * BK;                   // swizzled x panel elements
  static constexpr int PANEL = BM * BK;                // swizzled tile panel elements
  static_assert(BT % RB == 0 && CHUNKS % KS == 0, "row tile");

  static constexpr size_t RING_BYTES = (size_t)STAGES * STAGE * sizeof(T);
  static constexpr unsigned X_BYTES = XT * sizeof(T);        // one TMA x box: BT x 128 B
  static constexpr unsigned PANEL_BYTES = PANEL * sizeof(T);  // one TMA tile box: 16 KB
  static constexpr size_t FOLD_BYTES = (size_t)(KS - 1) * GT * 64 * sizeof(float);
};

// Where 16-byte chunk q of row m of a staged panel lies, in elements from the
// panel's start.  Padded: cp.async copies, rows BK + V apart (an odd number
// of 16-byte units).  Swizzle128: TMA copies with CU_TENSOR_MAP_SWIZZLE_128B
// into a 1024-byte-aligned panel, rows BK apart (128 bytes), chunk q of row m
// at unit q ^ (m & 7); tile rows tx + 16*j of a quarter-warp have eight
// values of m & 7, so their reads stay conflict-free.
struct Padded {
  template <class C>
  __device__ static __forceinline__ int at(int m, int q) { return m * C::S + q * C::V; }
};

struct Swizzle128 {
  template <class C>
  __device__ static __forceinline__ int at(int m, int q) {
    return m * C::BK + ((q ^ (m & 7)) * C::V);
  }
};

// Round a shared-memory pointer up to 1024 bytes (swizzled TMA destinations);
// the kernels that use it ask for 1024 bytes of slack.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const unsigned s = be::smem_addr(p);
  return p + ((1024u - (s & 1023u)) & 1023u);
}

// Dynamic shared memory of the ring; the fold of the KS - 1 upper k groups'
// partial sums reuses it.
template <class C>
constexpr size_t ring_smem() {
  return C::RING_BYTES > C::FOLD_BYTES ? C::RING_BYTES : C::FOLD_BYTES;
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

// acc[i][j] += sum over this thread's chunks of one staged step, panels laid
// out as L says: per 16-byte chunk, 8 x reads (broadcast) and 8 tile reads
// feed 64*V FMAs.
template <class C, class L, typename T>
__device__ __forceinline__ void fma_step(const T* xs, const T* ts, int tx, int r, int kg,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int cc = 0; cc < C::CPK; ++cc) {
    const int q = kg * C::CPK + cc;
    float a[8][C::V];
#pragma unroll
    for (int i = 0; i < 8; ++i) widen(xs + L::template at<C>(r * 8 + i, q), a[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[C::V];
      widen(ts + L::template at<C>(tx + 16 * j, q), w);
#pragma unroll
      for (int v = 0; v < C::V; ++v)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i][v], w[v], acc[i][j]);
    }
  }
}

// The consumer side of a ring whose stages are refilled behind a block
// barrier: run `steps` steps of `stage` elements each (x panel, then tile
// panel at x_elems), laid out as L says.  refill(s, live) starts the copies
// of the next step into stage s, if live (every thread calls it);
// land(step, s) waits until step's copies into stage s are visible to this
// thread.  Step s + STAGES - 1 is refilled into the stage that step s - 1
// used, after a __syncthreads has ended every read of it.
template <class C, class L, typename T, class Refill, class Land>
__device__ __forceinline__ void ring_steps(T* smem, int stage, int x_elems, int steps, int tx,
                                           int r, int kg, float (&acc)[8][8], Refill refill,
                                           Land land) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) refill(s, s < steps);
  int cur = 0, nxt = STAGES - 1;  // ring slots of this step and of the step loaded now
  for (int step = 0; step < steps; ++step) {
    land(step, cur);  // this step's copies have landed ...
    __syncthreads();  // ... for every thread, and step - 1 is done
    refill(nxt, step + STAGES - 1 < steps);
    const T* xs = smem + (size_t)cur * stage;
    fma_step<C, L>(xs, xs + x_elems, tx, r, kg, acc);
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
}

// The cp.async ring: run `steps` steps; load(stage_ptr) starts the copies of
// the next step (every thread calls it), and the FMAs run on each landed
// stage.  A group is committed even when empty, so wait_group counts steps.
template <class C, typename T, class Load>
__device__ __forceinline__ void run_ring(T* smem, int steps, int tid, int tx, int r, int kg,
                                         float (&acc)[8][8], Load load) {
  ring_steps<C, Padded>(
      smem, C::STAGE, C::X, steps, tx, r, kg, acc,
      [&](int s, bool live) {
        if (live) load(smem + (size_t)s * C::STAGE);
        cp_async_commit();
      },
      [](int, int) { be::cp_async_wait<STAGES - 2>(); });
  be::cp_async_wait<0>();
}

// Fold the k groups' partial sums (fixed order: group 0, 1, ...) through
// `red` ((KS - 1) * GT * 64 floats); sync() is a barrier of every thread
// that takes part.  Returns whether this thread holds the folded sums (k
// group 0); the others' acc are left as they were.
template <class C, class Sync>
__device__ __forceinline__ bool fold(float (&acc)[8][8], float* red, int tid, Sync sync) {
  const int g = tid % C::GT, kg = tid / C::GT;
  if constexpr (C::KS > 1) {
    sync();  // every thread is done with what red overlaps, and with the last fold
    if (kg > 0) {
#pragma unroll
      for (int e = 0; e < 64; ++e) red[((kg - 1) * 64 + e) * C::GT + g] = acc[e / 8][e % 8];
    }
    sync();
    if (kg > 0) return false;
#pragma unroll
    for (int k = 1; k < C::KS; ++k)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e / 8][e % 8] += red[((k - 1) * 64 + e) * C::GT + g];
  }
  return true;
}

// Store k group 0's sums: row_ptr(row) is the output row of tile row `row`
// (nullptr: none), columns tx + 16*j below cols_valid are written.
template <class C, class RowPtr>
__device__ __forceinline__ void store(const float (&acc)[8][8], int tid, int cols_valid,
                                      RowPtr row_ptr) {
  const int g = tid % C::GT;
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

// fold through the ring's shared memory (every thread of the block is done
// with it after the first __syncthreads), then store.
template <class C, class RowPtr>
__device__ __forceinline__ void fold_and_store(float (&acc)[8][8], void* smem, int tid,
                                               int cols_valid, RowPtr row_ptr) {
  if (fold<C>(acc, static_cast<float*>(smem), tid, [] { __syncthreads(); }))
    store<C>(acc, tid, cols_valid, row_ptr);
}

// Allow `bytes` of dynamic shared memory for `kernel` once per instantiation.
template <typename K>
cudaError_t allow_smem_once(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = be::allow_smem(kernel, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// ---------------------------------------------------------------- host: TMA
// Error codes past the CUDA runtime's, for a tensor map that was not built.
constexpr int ERR_NO_ENCODE = 19999;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 20000;     // + the CUresult of a failed encode

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query
// (no -lcuda).
inline EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// *map = the tensor map of a row-major (rows, cols) array of f32 or bf16 at
// ptr, box box_rows x 128 bytes, CU_TENSOR_MAP_SWIZZLE_128B, rows past
// `rows` read as zeros.  Maps are cached on (ptr, rows, cols, box_rows,
// dtype): a map holds nothing else.  Returns 0, or ERR_NO_ENCODE /
// ERR_ENCODE + CUresult.
inline int tensor_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
                      unsigned box_rows, bool bf16) {
  struct Entry {
    const void* ptr;
    uint64_t rows, cols;
    unsigned box_rows;
    bool bf16, used;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[16] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.used && e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows &&
        e.bf16 == bf16) {
      *map = e.map;
      return 0;
    }
  }
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const unsigned item = bf16 ? 2 : 4;
  const cuuint64_t dim[2] = {cols, rows};
  const cuuint64_t stride[1] = {cols * item};
  const cuuint32_t box[2] = {128 / item, box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult res = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
      const_cast<void*>(ptr), dim, stride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ERR_ENCODE + static_cast<int>(res);
  cache[next] = Entry{ptr, rows, cols, box_rows, bf16, true, *map};
  next = (next + 1) % 16;
  return 0;
}

// The message of a launch's return code (a CUDA error or a map error above).
inline const char* error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (err >= ERR_ENCODE) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", err - ERR_ENCODE);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dispatch a functor over the instantiated row tiles: f(Cfg<T, BT, MIN_NT>{})
// for the run-time BT; returns cudaErrorInvalidValue for any other BT.
template <typename T, int MIN_NT = 0, class F>
cudaError_t with_tile(int BT, F f) {
  switch (BT) {
    case 8: return f(Cfg<T, 8, MIN_NT>{});
    case 16: return f(Cfg<T, 16, MIN_NT>{});
    case 32: return f(Cfg<T, 32, MIN_NT>{});
    case 64: return f(Cfg<T, 64, MIN_NT>{});
    case 128: return f(Cfg<T, 128, MIN_NT>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bc
