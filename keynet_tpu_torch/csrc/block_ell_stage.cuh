// Copy and barrier primitives of the Block-ELL kernels (block_ell_core.cuh):
// cp.async copies into shared memory, TMA tensor copies onto mbarriers, the
// 16-byte widening read, and the opt-in above 48 KB of shared memory.  All
// inline PTX for sm_90a; no CUTLASS.  bf16 is widened to f32 as it is read
// out of shared memory (exact: a bf16 is the top half of an f32).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <cuda_bf16.h>

namespace be {

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = smem_addr(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// mbarrier with `count` arrivals a phase; one thread initialises, then
// fence_barrier_init() and a block barrier before any use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts as having completed the phase of parity 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of a 2-D tensor map at (c0 = column, c1 = row) -> dst, completing
// its bytes on `bar`.  `map` lives in kernel parameter space
// (__grid_constant__).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// Barrier `id` (1..15) among the first `n` threads of the block (a multiple
// of 32), leaving other warps free.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Give up (dec) or take (inc) registers: every thread of a warpgroup sets
// its limit to N (a multiple of 8 in [24, 256]).
template <int N>
__device__ __forceinline__ void max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 16 bytes of shared memory -> f32
__device__ __forceinline__ void widen(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);             // element 2i: low half
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);  // element 2i+1
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB it must be
// opted into per function).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace be
