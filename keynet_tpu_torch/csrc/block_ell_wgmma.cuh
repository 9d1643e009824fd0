// The tensor-core step of the slot walk (block_ell.cu) and the periodic
// kernel (periodic_block_ell.cu) on Hopper's warpgroup MMA (wgmma), f32
// accumulation, for two operand types:
//   bf16 tiles: bf16 x bf16 products, the dot the Pallas kernels run on the
//     TPU's matrix unit with bf16 tiles (keynet_tpu/ops/pallas_kernels.py:
//     x cast to the tile dtype, :129, :323, :425, :592;
//     preferred_element_type=f32, :86, :282, :382, :547), in every mode;
//   f32 tiles under PRECISION='default': tf32 x tf32 products, the
//     counterpart of the Pallas dot at Precision.DEFAULT (one reduced-
//     precision pass, :107-110, :301-304, :403-406, :566-569) and the
//     rounding precision('default') gives cuBLAS and cuDNN on this card.
// f32 tiles under 'highest' and 'high' stay on block_ell_core.cuh's IEEE
// FMA core (ops/block_ell.launch_plan and globals.kernel_precision choose).
//
// TF32 rounding.  wgmma reads the f32 operands out of shared memory as they
// were staged, unconverted: the tensor cores use the sign, the 8 exponent
// bits and the upper 10 mantissa bits of each and ignore the low 13, i.e.
// they truncate toward zero (not cvt.rna.tf32.f32's round to nearest).
// ops/block_ell.round_tf32 models that in the plain version, and the
// rounding pin of chip_smoke.py's [parity] and tests/test_torch_card.py
// holds it on the card.  A tf32 x tf32 product is exact in f32.
//
// A block computes a BT x 128 output tile, as the FMA core does.  For one
// step of 128 bytes of contraction (64 bf16 or 32 f32 columns: one 128-byte
// line of each panel row) the wgmma operands are
//   A = the 128 x BK tile panel (tile rows, K contiguous: K-major),
//   B = the BT x BK x panel (x rows, K contiguous: K-major, as .tf32 needs),
// so D[m][n] = sum_k tile[m][k] * x[n][k], the output column c0 + m of x row
// b0 + n: the transpose of the FMA core's acc, written once, with no
// atomics (run-to-run deterministic).  Two warpgroups each own 64 tile rows
// and issue four m64nBTk16 (bf16) or m64nBTk8 (tf32) instructions a step,
// one a 32-byte slice, BT/2 accumulators a thread.  A 128-wide f32 slot
// is four steps, a bf16 one two.
//
// Staging.  The cp.async ring of block_ell_core.cuh stays (the periodic
// kernel gathers each (rep, image) row from its own column block, which no
// TMA box can do), but its copies land at the 128-byte-swizzled addresses
// wgmma reads (bc::Swizzle128's pattern, the one TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes: chunk q of row m at 16-byte unit
// q ^ (m & 7), rows 128 bytes apart) in 1024-byte-aligned panels, and the
// shared-memory descriptors name that swizzle.  STAGES - 1 steps are in
// flight while one multiplies; a step's wgmmas run while the threads wait
// for the next step's copies, and are waited for before the block barrier
// that lets their stage be refilled.  Two blocks an SM at every row tile
// (__launch_bounds__(256, 2): at most 128 registers a thread).  No k-group
// split or fold: each warpgroup owns the whole 128-byte step.  The bytes a
// stage holds do not depend on the type, so both share one plan.
//
// Id-0 slots are skipped before any copy (the walks below never stage
// them): on tensor cores a zero tile times an inf x block is NaN, so this is
// a rule of the contract, not a speed-up.

#pragma once

#include "block_ell_core.cuh"

namespace bw {

using bc::BM;
using bc::STAGES;
using bf16 = __nv_bfloat16;

// T: the operand type, bf16 (bf16 products) or float (tf32 products).
template <int BT_, typename T_>
struct Cfg {
  using T = T_;
  static constexpr int BT = BT_;                // x rows a block: the wgmma's N
  static constexpr int NT = 256;                // two warpgroups of 64 tile rows
  static constexpr int V = 16 / sizeof(T);      // elements in 16 bytes
  static constexpr int BK = 8 * V;              // contraction columns a step (128 bytes)
  static constexpr int ACC = BT / 2;            // f32 accumulators a thread
  static constexpr int X_BYTES = BT * 128;      // swizzled x panel
  static constexpr int STAGE = X_BYTES + BM * 128;  // + the 16 KB tile panel
  // the ring, after up to 1024 bytes of slack that align it
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE;
  static_assert(BT % 8 == 0 && BT >= 8 && BT <= 128, "wgmma N: a multiple of 8");
  static_assert(X_BYTES % 1024 == 0, "panels stay 1024-byte aligned");
};

// Byte offset of 16-byte chunk q of row m in a swizzled panel of 128-byte rows.
__device__ __forceinline__ int sw128(int m, int q) { return m * 128 + ((q ^ (m & 7)) << 4); }

// Start the copies of the 128 x BK tile panel at src (row stride src_stride).
template <class C>
__device__ __forceinline__ void stage_tile(unsigned char* ts, const typename C::T* src,
                                           size_t src_stride, int tid) {
#pragma unroll
  for (int i = tid; i < BM * 8; i += C::NT) {
    const int m = i >> 3, q = i & 7;
    be::cp_async16(ts + sw128(m, q), src + (size_t)m * src_stride + q * C::V, true);
  }
}

// Start the copies of the BT x BK x panel whose row `row` starts at
// src + off(row), or is zero-filled where off(row) < 0.
template <class C, class Off>
__device__ __forceinline__ void stage_x(unsigned char* xs, const typename C::T* src, Off off,
                                        int tid) {
#pragma unroll
  for (int i = tid; i < C::BT * 8; i += C::NT) {
    const int r = i >> 3, q = i & 7;
    const long long o = off(r);
    be::cp_async16(xs + sw128(r, q), o >= 0 ? src + o + q * C::V : src, o >= 0);
  }
}

// The shared-memory descriptor of a K-major operand in 128-byte-swizzled
// 8-row groups: start address >> 4 (bits 0-13), leading offset 1 (unused
// for a swizzled K-major operand, bits 16-29), 1024 bytes between 8-row
// groups (bits 32-45), base offset 0 (the panels are 1024-byte aligned),
// layout SWIZZLE_128B (1 in bits 62-63).  The k-th 32-byte slice of a step
// (16 bf16 or 8 tf32 columns) starts 32 bytes further: the descriptor + 2k.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((be::smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x K, desc a) * B (K x N, desc b), f32 accumulators; K = 32
// bytes of contraction: m64nNk16 bf16 x bf16, or m64nNk8 tf32 x tf32 for
// f32 operands (which takes no transpose flags: K-major only).  Both share
// the register layout: d[4j + 2h + c] is row 16*warp + lane/4 + 8h, column
// 8j + 2*(lane%4) + c of the warpgroup's 64 x N tile.  P is the operand
// number of the scale-d predicate (always 1: accumulate).
#define BW_WGMMA(N, TYPES, TAIL, REGS, A, B, P)                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n" #N TYPES " {" REGS "}, %" A ", %" B    \
  ", p" TAIL ";\n}\n"
#define BW_MMA(N, REGS, A, B, P, ...)                                         \
  template <class T>                                                          \
  __device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) { \
    if constexpr (sizeof(T) == 2)                                             \
      asm volatile(BW_WGMMA(N, "k16.f32.bf16.bf16", ", 1, 1, 0, 0", REGS, A, B, P) \
                   : __VA_ARGS__ : "l"(a), "l"(b), "r"(1));                   \
    else                                                                      \
      asm volatile(BW_WGMMA(N, "k8.f32.tf32.tf32", ", 1, 1", REGS, A, B, P)   \
                   : __VA_ARGS__ : "l"(a), "l"(b), "r"(1));                   \
  }

BW_MMA(8, "%0, %1, %2, %3", "4", "5", "6",
       "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]))

BW_MMA(16, "%0, %1, %2, %3, %4, %5, %6, %7", "8", "9", "10",
       "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]))

BW_MMA(32,
       "%0, %1, %2, %3, %4, %5, %6, %7, "
       "%8, %9, %10, %11, %12, %13, %14, %15", "16", "17", "18",
       "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]))

BW_MMA(64,
       "%0, %1, %2, %3, %4, %5, %6, %7, "
       "%8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, "
       "%24, %25, %26, %27, %28, %29, %30, %31", "32", "33", "34",
       "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]))

BW_MMA(128,
       "%0, %1, %2, %3, %4, %5, %6, %7, "
       "%8, %9, %10, %11, %12, %13, %14, %15, "
       "%16, %17, %18, %19, %20, %21, %22, %23, "
       "%24, %25, %26, %27, %28, %29, %30, %31, "
       "%32, %33, %34, %35, %36, %37, %38, %39, "
       "%40, %41, %42, %43, %44, %45, %46, %47, "
       "%48, %49, %50, %51, %52, %53, %54, %55, "
       "%56, %57, %58, %59, %60, %61, %62, %63", "64", "65", "66",
       "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
       "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
       "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
       "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
       "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
       "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
       "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
       "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
       "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
       "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
       "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
       "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
       "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
       "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
       "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
       "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]))

#undef BW_MMA
#undef BW_WGMMA

// Wait until this warpgroup's issued MMAs are done; the accumulators are
// then readable.
template <int N>
__device__ __forceinline__ void mma_wait(float (&acc)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// Issue one staged step: the four 32-byte slices (k16 bf16 or k8 tf32) of
// this warpgroup's 64 tile rows against the x panel, committed as one group
// and not waited for.
template <class C>
__device__ __forceinline__ void mma_step(const unsigned char* st, int wg, float (&acc)[C::ACC]) {
  const uint64_t b = desc_sw128(st);
  const uint64_t a = desc_sw128(st + C::X_BYTES + wg * 64 * 128);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma<typename C::T>(acc, a + 2 * k, b + 2 * k);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The cp.async ring on tensor cores: run `steps` steps of C::STAGE bytes
// each (x panel, then tile panel at C::X_BYTES); load(stage) starts the
// copies of the next step (every thread calls it).  A group is committed
// even when empty, so wait_group counts steps.  Each thread's landed copies
// are fenced into the async proxy, which wgmma reads through, before the
// block barrier.  A step's MMAs run while the threads wait for the next
// step's copies; each warpgroup waits for them before that barrier, after
// which step s + STAGES - 1 refills the stage they read.
template <class C, class Load>
__device__ __forceinline__ void run_ring(unsigned char* ring, int steps, int wg,
                                         float (&acc)[C::ACC], Load load) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(ring + (size_t)s * C::STAGE);
    be::cp_async_commit();
  }
  int cur = 0, nxt = STAGES - 1;  // ring slots of this step and of the step loaded now
  for (int step = 0; step < steps; ++step) {
    be::cp_async_wait<STAGES - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mma_wait(acc);    // step - 1's MMAs, which read the stage refilled below
    __syncthreads();
    if (step + STAGES - 1 < steps) load(ring + (size_t)nxt * C::STAGE);
    be::cp_async_commit();
    mma_step<C>(ring + (size_t)cur * C::STAGE, wg, acc);
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
  mma_wait(acc);
  be::cp_async_wait<0>();
}

// Store the accumulators: row_ptr(n) is the output row of x row n (nullptr:
// none); tile row m goes to column m, below cols_valid.  Warp w holds tile
// rows 16w + lane/4 and 16w + lane/4 + 8.
template <class C, class RowPtr>
__device__ __forceinline__ void store(const float (&acc)[C::ACC], int tid, int cols_valid,
                                      RowPtr row_ptr) {
  const int lane = tid & 31;
  const int m = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < C::BT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float* o = row_ptr(8 * j + 2 * (lane & 3) + c);
      if (o == nullptr) continue;
      if (m < cols_valid) o[m] = acc[4 * j + c];
      if (m + 8 < cols_valid) o[m + 8] = acc[4 * j + 2 + c];
    }
}

// Dispatch a functor over the instantiated row tiles: f(Cfg<BT, T>{}) for
// the run-time BT; returns cudaErrorInvalidValue for any other BT.
template <typename T, class F>
cudaError_t with_tile(int BT, F f) {
  switch (BT) {
    case 8: return f(Cfg<8, T>{});
    case 16: return f(Cfg<16, T>{});
    case 32: return f(Cfg<32, T>{});
    case 64: return f(Cfg<64, T>{});
    case 128: return f(Cfg<128, T>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bw
