// The tensor-core step of the bf16 slot walk (block_ell.cu) and periodic
// kernel (periodic_block_ell.cu): bf16 x bf16 products with f32
// accumulation on Hopper's warpgroup MMA (wgmma), which is the dot the
// Pallas kernels run on the TPU's matrix unit with bf16 tiles
// (keynet_tpu/ops/pallas_kernels.py: x cast to the tile dtype, :129, :323,
// :425, :592; preferred_element_type=f32, :86, :282, :382, :547).  The f32
// instantiations stay on block_ell_core.cuh's IEEE FMA core.
//
// A block computes a BT x 128 output tile, as the FMA core does.  For one
// step of 64 bf16 columns of contraction (one 128-byte line of each panel
// row) the wgmma operands are
//   A = the 128 x 64 tile panel (tile rows, K contiguous: K-major),
//   B = the BT x 64 x panel (x rows, K contiguous: K-major),
// so D[m][n] = sum_k tile[m][k] * x[n][k], the output column c0 + m of x row
// b0 + n: the transpose of the FMA core's acc, written once, with no
// atomics (run-to-run deterministic).  Two warpgroups each own 64 tile rows
// and issue four m64nBTk16 instructions a step, BT/2 accumulators a thread.
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
// split or fold: each warpgroup owns the whole 64-column step.
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

template <int BT_>
struct Cfg {
  static constexpr int BT = BT_;                // x rows a block: the wgmma's N
  static constexpr int NT = 256;                // two warpgroups of 64 tile rows
  static constexpr int BK = 64;                 // contraction columns a step (128 bytes)
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

// Start the copies of the 128 x 64 tile panel at src (row stride src_stride).
template <class C>
__device__ __forceinline__ void stage_tile(unsigned char* ts, const bf16* src, size_t src_stride,
                                           int tid) {
#pragma unroll
  for (int i = tid; i < BM * 8; i += C::NT) {
    const int m = i >> 3, q = i & 7;
    be::cp_async16(ts + sw128(m, q), src + (size_t)m * src_stride + q * 8, true);
  }
}

// Start the copies of the BT x 64 x panel whose row `row` starts at
// src + off(row), or is zero-filled where off(row) < 0.
template <class C, class Off>
__device__ __forceinline__ void stage_x(unsigned char* xs, const bf16* src, Off off, int tid) {
#pragma unroll
  for (int i = tid; i < C::BT * 8; i += C::NT) {
    const int r = i >> 3, q = i & 7;
    const long long o = off(r);
    be::cp_async16(xs + sw128(r, q), o >= 0 ? src + o + q * 8 : src, o >= 0);
  }
}

// The shared-memory descriptor of a K-major operand in 128-byte-swizzled
// 8-row groups: start address >> 4 (bits 0-13), leading offset 1 (unused
// for a swizzled K-major operand, bits 16-29), 1024 bytes between 8-row
// groups (bits 32-45), base offset 0 (the panels are 1024-byte aligned),
// layout SWIZZLE_128B (1 in bits 62-63).  The k-th 16-column slice of a
// step starts 32 bytes further: the descriptor + 2k.
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

// d += A (64 x 16, desc a) * B (16 x N, desc b), bf16 in, f32 accumulators
// (the m64nNk16 register layout: d[4j + 2h + c] is row 16*warp + lane/4 +
// 8h, column 8j + 2*(lane%4) + c of the warpgroup's 64 x N tile).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// Wait until this warpgroup's issued MMAs are done; the accumulators are
// then readable.
template <int N>
__device__ __forceinline__ void mma_wait(float (&acc)[N]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

// Issue one staged step: the four k16 slices of this warpgroup's 64 tile
// rows against the x panel, committed as one group and not waited for.
template <class C>
__device__ __forceinline__ void mma_step(const unsigned char* st, int wg, float (&acc)[C::ACC]) {
  const uint64_t b = desc_sw128(st);
  const uint64_t a = desc_sw128(st + C::X_BYTES + wg * 64 * 128);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma<C::BT>(acc, a + 2 * k, b + 2 * k);
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

// Dispatch a functor over the instantiated row tiles: f(Cfg<BT>{}) for the
// run-time BT; returns cudaErrorInvalidValue for any other BT.
template <class F>
cudaError_t with_tile(int BT, F f) {
  switch (BT) {
    case 8: return f(Cfg<8>{});
    case 16: return f(Cfg<16>{});
    case 32: return f(Cfg<32>{});
    case 64: return f(Cfg<64>{});
    case 128: return f(Cfg<128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bw
