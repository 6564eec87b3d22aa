// The int8 tensor-core product and the cp.async copies shared by the
// integer kernels (crossprod.cu, matmul_int8.cu).
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

}  // namespace mx
