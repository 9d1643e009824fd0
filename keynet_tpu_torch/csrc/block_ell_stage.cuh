// Shared pieces of the staged Block-ELL kernels (block_ell_xres.cu,
// block_ell_grid.cu): cp.async copies into shared memory, the 16-byte
// widening read, and the 64 x 128 register tile both kernels accumulate in.
//
// Layout.  A staged panel keeps the row-major layout of its source (cp.async
// copies 16 bytes as they are, it cannot transpose), with a row stride of
// width + 16 bytes.  When width*sizeof(T) is an even number of 16-byte units
// (every width used here: 16 columns, or TN a multiple of 128), a row is an
// odd number of 16-byte units, so the eight threads of a quarter-warp that
// read rows tx + 16*j at the same column hit eight different 16-byte bank
// groups.  x rows are read by all threads of one ty at once (a broadcast).
// bf16 is widened to f32 as it is read out of shared memory (exact: a bf16
// is the top half of an f32), so products and sums are f32 as in
// block_ell.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <cuda_bf16.h>

namespace be {

constexpr int BM = 128;      // output columns per block (rows of a tile panel)
constexpr int BT = 64;       // batch rows per block
constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int RB = BT / 16;  // batch rows per thread

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));
};

// row stride (elements) of a staged panel `width` elements wide
template <typename T>
__host__ __device__ constexpr int stride(int width) {
  return width + Vec<T>::N;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred (src is
// then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
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

// Start the copies of rows [0, rows) x columns [0, len) of a source with row
// stride src_stride into dst (row stride dst_stride); rows >= valid are
// zero-filled.  len is a multiple of Vec<T>::N; every thread of the block
// calls it.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride, const T* src,
                                           size_t src_stride, int rows, int valid,
                                           int len, int tid) {
  constexpr int V = Vec<T>::N;
  const int per_row = len / V;
  for (int i = tid; i < rows * per_row; i += NT) {
    const int r = i / per_row, q = (i % per_row) * V;
    const bool ok = r < valid;
    cp_async16(dst + (size_t)r * dst_stride + q, ok ? src + (size_t)r * src_stride + q : src, ok);
  }
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

// acc[i][j] += sum_{kk < len} xs[(ty*RB + i)*sx + kk] * ts[(tx + 16*j)*st + kk]:
// thread (tx, ty) owns batch rows ty*RB + i and output columns tx + 16*j.
template <typename T>
__device__ __forceinline__ void fma_panel(const T* xs, int sx, const T* ts, int st,
                                          int len, int tx, int ty, float (&acc)[RB][8]) {
  constexpr int V = Vec<T>::N;
#pragma unroll 2
  for (int kk = 0; kk < len; kk += V) {
    float a[RB][V];
#pragma unroll
    for (int i = 0; i < RB; ++i) widen(xs + (size_t)(ty * RB + i) * sx + kk, a[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[V];
      widen(ts + (size_t)(tx + 16 * j) * st + kk, w);
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int i = 0; i < RB; ++i) acc[i][j] = fmaf(a[i][v], w[v], acc[i][j]);
    }
  }
}

// out[b0 + ty*RB + i, c0 + tx + 16*j] = acc[i][j], masked to (B, n_out)
__device__ __forceinline__ void store_tile(float* out, const float (&acc)[RB][8], int b0,
                                           int c0, int B, int n_out, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int b = b0 + ty * RB + i;
    if (b >= B) continue;
    float* o = out + (size_t)b * n_out;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < n_out) o[c] = acc[i][j];
    }
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
