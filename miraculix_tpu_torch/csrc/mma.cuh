// The tensor-core products (int8 and bf16 mma.sync), the cp.async copies of
// packed rows and the promotion of short bf16 mma sums into f32 totals,
// shared by the packed-product kernels.
#pragma once

#include <stdint.h>

namespace mx {

// 16 bytes global -> shared, L2 only; `bytes` < 16 zero-fills the rest
// (0: the whole chunk, and nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared; `bytes` 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Words [w0, w0 + KS) of the rows [r0, r0 + ROWS) of zq [rows, kw] -> zs
// (rows of ZS words), zero past `rows` and past kw, by the block's THREADS
// threads: 16-byte copies where `vec` (kw % 4 == 0 and zq 16-byte aligned,
// so that a chunk is all in or all out), else one word a copy.
template <int ROWS, int KS, int ZS, int THREADS>
__device__ __forceinline__ void copy_rows(const uint32_t* __restrict__ zq,
                                          int rows, int kw, int r0, int w0,
                                          bool vec, uint32_t* zs) {
  static_assert(KS % 4 == 0 && ROWS * KS / 4 % THREADS == 0,
                "whole 16-byte copies a thread");
  if (vec) {
#pragma unroll
    for (int i = 0; i < ROWS * KS / 4 / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / (KS / 4), q = idx % (KS / 4);
      const bool ok = r0 + r < rows && w0 + 4 * q < kw;
      cp_async16(zs + r * ZS + 4 * q,
                 ok ? zq + (long long)(r0 + r) * kw + w0 + 4 * q : zq,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * KS / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / KS, w = idx % KS;
      const bool ok = r0 + r < rows && w0 + w < kw;
      cp_async4(zs + r * ZS + w,
                ok ? zq + (long long)(r0 + r) * kw + w0 + w : zq,
                ok ? 4 : 0);
    }
  }
}

// c += a . b over one m16n8k32 step, int8 x int8 with s32 sums (exact: the
// integer mma does not round, and without .satfinite it wraps only past
// 2^31).  Fragments of lane (g = lane >> 2, t = lane & 3), PTX ISA:
//   a[0] row g, k 4t..4t+3; a[1] row g+8, same k; a[2], a[3] the same rows
//   at k 16+4t..16+4t+3 (byte j of a register is k + j);
//   b[0] column g, k 4t..4t+3; b[1] column g, k 16+4t..16+4t+3;
//   c[e] row g + 8 (e >> 1), column 2t + (e & 1).
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b over one m16n8k16 step, bf16 x bf16 with f32 sums (each
// product exact; the sum truncates addends below the largest's window, so
// callers start a short sum from zero and add it to f32 registers).
// Fragments of lane (g = lane >> 2, t = lane & 3), PTX ISA:
//   a[0] row g, k 2t, 2t+1 (low half first); a[1] row g+8, same k; a[2],
//   a[3] the same rows at k 2t+8, 2t+9;
//   b.x column g, k 2t, 2t+1; b.y column g, k 2t+8, 2t+9;
//   c[e] row g + 8 (e >> 1), column 2t + (e & 1).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}
// the same from zero
__device__ __forceinline__ void mma_bf16_zero(float* c, const uint32_t* a,
                                              uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y),
        "f"(0.f));
}

// acc += the P parts' (or digits') short mma sums d, smallest part first
// (d[P - 1] + ... + d[0]), each add rounded to nearest
template <int P, int MI, int NT>
__device__ __forceinline__ void promote(float (&acc)[MI][NT][4],
                                        float (&d)[P][MI][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = d[P - 1][mi][u][e];
#pragma unroll
        for (int p = P - 2; p >= 0; --p) sum += d[p][mi][u][e];
        acc[mi][u][e] += sum;
      }
}

}  // namespace mx
