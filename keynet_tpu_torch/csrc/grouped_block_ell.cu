// Grouped-row Block-ELL apply for Hopper (sm_90a).
//
// The grouped-row plan of a Block-ELL core (ops/operators.find_row_groups)
// sorts its row-blocks into groups that share one tile_ids row, a pattern:
// bucket by bucket, G patterns each shared by m row-blocks, the rows of
// group g at rows[g*m .. g*m + m).  Contract, for each group and each of
// its rows r = rows[g*m + i]:
//   out[:, r*TM + t] = sum_k x[:, col_blk[r, k]*TN : +TN] . tiles[patterns[g, k]][t, :]
// f32 accumulation and output, a slot whose pattern id is 0 (the zero tile)
// skipped.  Every row-block lies in one group, so every output is written.
//
// What bounds it on this card.  A pattern's tiles serve its m rows for
// every image, so the least traffic is one read of the distinct tiles, the
// x blocks the non-zero slots name and the f32 output; the work is
// 2*TM*TN FLOPs per non-zero slot, row and image.  At the stochastic
// VGG-16's conv1_1 and conv2_1 cores and B = 32 that is 0.93 TFLOP, 13.9 ms
// of IEEE f32 FMAs at the H100 SXM data-sheet rate (67 TFLOP/s without
// tensor cores), far above the bytes: operations bound it.  The gather +
// einsum it replaces copied every pattern's tiles and every row's x blocks
// into fresh tensors, multiplied the padding slots too, and put the rows
// back in order with a cat and a take: 19% of this bound.
//
// What the design does about it.  The walk is the periodic kernel's
// (periodic_block_ell.cu) on block_ell_core.cuh, with the m rows of a group
// in place of the R reps of a period row: a block owns one group, one
// 128-wide chunk of its TM columns and BT consecutive (row, image) pairs
// q = i*B + b, BT in {8, ..., 128} the least that holds m*B (capped at 128).
// Pair row (i, b) reads its own x block at slot k,
// b*n_cols + col_blk[rows[g*m + i], k]*TN, computed one non-zero slot ahead
// into shared memory (two buffers), so the next slot's x and tile panels
// are in the cp.async ring while this slot multiplies.  The blocks come
// from a table built once per batch size with the plan (ops/block_ell.
// grouped_tables): one launch for every bucket of one row tile, its blocks
// a group's pair chunks side by side (they share the group's tiles in L2),
// the groups with the most non-zero slots first.  Each output is written
// once, in place, with no atomics: results are run-to-run deterministic.
//
// bf16 tiles run the same walk on the FMA core (widened to f32 as they are
// read out of shared memory); f32 tiles multiply as IEEE f32 (no TF32).

#include "block_ell_core.cuh"

namespace {

using namespace bc;

template <class C>
__host__ __device__ constexpr size_t xoff_bytes() {
  return 2 * C::BT * sizeof(long long);  // two slots' row offsets
}

// table[blockIdx.x] = {pattern, its first row in rows, m, first pair}
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, 1) grouped_kernel(
    const T* __restrict__ x, const T* __restrict__ tiles,
    const int* __restrict__ patterns, const int* __restrict__ rows,
    const int* __restrict__ col_blk, const int4* __restrict__ table,
    float* __restrict__ out, int B, int n_cols, int KB, int TM, int TN, long long n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* xoff = reinterpret_cast<long long*>(smem_raw);  // [2][BT], -1 = none
  unsigned char* ring = smem_raw + xoff_bytes<C>();
  T* smem = reinterpret_cast<T*>(ring);

  const int tid = threadIdx.x;
  const int g = tid % C::GT, kg = tid / C::GT;
  const int tx = g % 16, r = g / 16;
  const int4 e = table[blockIdx.x];
  const int* grows = rows + e.y;                      // the group's m rows
  const long long n_pairs = (long long)e.z * B;
  const long long q0 = e.w;                           // first (row, image) pair
  const int m0 = blockIdx.y * BM;                     // first tile row of the chunk

  // thread tid < BT owns pair row tid's offsets: its image's x row and its
  // row-block's column blocks
  long long xrow = -1;
  const int* cbrow = col_blk;
  if (tid < C::BT && q0 + tid < n_pairs) {
    const long long q = q0 + tid;
    const int i = (int)(q / B), b = (int)(q % B);
    xrow = (long long)b * n_cols;
    cbrow = col_blk + (size_t)grows[i] * KB;
  }
  const int* ids = patterns + (size_t)e.x * KB;
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

  // the producer cursor and the offsets' double buffer of periodic_kernel:
  // the first step of non-zero slot n (n >= 1) fills slot n + 1's offsets,
  // behind a barrier that ended every read of slot n - 1's
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

  // pair row q (row i of the group, image b) -> out[b, rows[i]*TM + m0 + c]
  fold_and_store<C>(acc, ring, tid, BM, [&](int row) -> float* {
    const long long q = q0 + row;
    if (q >= n_pairs) return nullptr;
    const int i = (int)(q / B), b = (int)(q % B);
    return out + (size_t)b * n_out + (size_t)grows[i] * TM + m0;
  });
}

template <typename T>
cudaError_t launch(const void* x, const void* tiles, const int* patterns, const int* rows,
                   const int* cols, const int4* table, float* out, int B, int n_cols, int KB,
                   int TM, int TN, long long n_out, int n_blocks, int BT, size_t bytes,
                   cudaStream_t stream) {
  return with_tile<T>(BT, [&](auto c) {
    using C = decltype(c);
    if (bytes < xoff_bytes<C>() + ring_smem<C>()) return cudaErrorInvalidValue;
    static size_t allowed = 48 * 1024;
    cudaError_t err = allow_smem_once(grouped_kernel<C, T>, bytes, allowed);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)n_blocks, (unsigned)(TM / BM));
    grouped_kernel<C, T><<<grid, C::NT, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(tiles), patterns, rows, cols, table,
        out, B, n_cols, KB, TM, TN, n_out);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// x: (B, n_cols) and tiles: (n_uniq, TM, TN), both 16-byte aligned, f32
// (kind = 0) or bf16 (kind = 1), multiplied on the FMA core either way;
// patterns: (n_patterns, KB) int32 tile ids; rows: (n_rb,) int32 row-blocks,
// group by group; col_blk: (n_rb, KB) int32; table: (n_blocks, 4) int32,
// each {pattern, its first row in rows, m, first pair}, every pair chunk of
// the launch's groups once; out: (B, n_rb*TM) f32.  TM and TN are multiples
// of 128; all arrays contiguous.  BT (8, 16, 32, 64 or 128) is the row tile
// over each group's m*B (row, image) pairs and smem the dynamic shared
// memory of a block, as ops/block_ell.launch_plan chooses them; fewer bytes
// than BT's layout needs are refused.
int grouped_block_ell(const void* x, const void* tiles, const void* patterns, const void* rows,
                      const void* col_blk, const void* table, void* out, int B, int n_cols,
                      int KB, int TM, int TN, int n_rb, int n_blocks, int kind, int BT,
                      int smem, void* stream) {
  if (TM % BM != 0 || TN % 128 != 0 || B <= 0 || KB <= 0 || n_rb <= 0 || n_blocks <= 0 ||
      smem <= 0 || kind < 0 || kind > 1 || TM / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(patterns);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(col_blk);
  const int4* t = static_cast<const int4*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)n_rb * TM;
  const cudaError_t err =
      kind == 1 ? launch<__nv_bfloat16>(x, tiles, p, r, c, t, o, B, n_cols, KB, TM, TN, n_out,
                                        n_blocks, BT, smem, st)
                : launch<float>(x, tiles, p, r, c, t, o, B, n_cols, KB, TM, TN, n_out, n_blocks,
                                BT, smem, st);
  return static_cast<int>(err);
}

const char* grouped_block_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
