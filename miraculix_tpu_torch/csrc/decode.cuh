// Genotype decode (to bf16 mma fragments or to int8 quads), the
// split reduction and the upper tile-pair walk shared by the packed-product
// kernels.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mx {

// the upper tile pair (bi <= bj) of linear index p = bj*(bj+1)/2 + bi
__device__ __forceinline__ void upper_pair(long long p, int& bi, int& bj) {
  bj = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while ((long long)bj * (bj + 1) / 2 > p) --bj;
  while ((long long)(bj + 1) * (bj + 2) / 2 <= p) ++bj;
  bi = (int)(p - (long long)bj * (bj + 1) / 2);
}

// The bf16 pair of one plane of two packed words, from ``pair`` = their
// low (or high) 16-bit halves side by side (word s in bits 0-15, word s+1
// in bits 16-31) and the plane's bit offset ``shift`` within the half:
// ((pair >> shift) & 0x00030003) | 0x43004300 is the pair (128 + g0,
// 128 + g1), exact since the bf16 ulp on [128, 256) is 1, and one bf16x2
// subtraction of 128 leaves the codes 0..3.  No int->float convert.
__device__ __forceinline__ uint32_t plane_pair_bf16(uint32_t pair,
                                                    int shift) {
  uint32_t v = ((pair >> shift) & 0x00030003u) | 0x43004300u;
  const __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of mma.m16n8k16 (bf16, row-major 16 x 16) whose row m is
// plane m of one packed word and whose column k is contraction row k: lane
// (g, t) passes the word of rows 2t, 2t+1, 2t+8, 2t+9 as w0..w3 and
// shift = 2g, and gets planes g (a[0], a[2]) and g + 8 (a[1], a[3]).
__device__ __forceinline__ void a_fragment(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           int shift, uint32_t* a) {
  a[0] = plane_pair_bf16(__byte_perm(w0, w1, 0x5410), shift);
  a[1] = plane_pair_bf16(__byte_perm(w0, w1, 0x7632), shift);
  a[2] = plane_pair_bf16(__byte_perm(w2, w3, 0x5410), shift);
  a[3] = plane_pair_bf16(__byte_perm(w2, w3, 0x7632), shift);
}

// One packed word as 16 int8 contraction values, for the int8 mma:
// register q = (w >> 2q) & 0x03030303 holds planes q, q+4, q+8, q+12 in
// bytes 0..3, so the word's 16 bytes r0 | r1 | r2 | r3 put plane 4b + q at
// byte k = 4q + b.  An m16n8k32 A register (row-major) and B register
// (.col) each hold four consecutive k of one row, and both operands of a
// crossproduct are rows with the same word -> SNP map: any k order shared
// by the two sides gives the full contraction, so no shuffle is needed.
__device__ __forceinline__ uint4 int8_quads(uint32_t w) {
  return make_uint4(w & 0x03030303u, (w >> 2) & 0x03030303u,
                    (w >> 4) & 0x03030303u, (w >> 6) & 0x03030303u);
}

namespace {  // one copy per translation unit: both kernels' sources use it

// out[i] = sum over splits of part[s][i], in split order; with vpart, the
// first n threads do the same for the center partials vpart[s][i]
__global__ void reduce_splits(const float* __restrict__ part, int splits,
                              long long len, float* __restrict__ out,
                              const float* __restrict__ vpart, int n,
                              float* __restrict__ vout) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < len) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[s * len + i];
    out[i] = acc;
  }
  if (vpart != nullptr && i < n) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += vpart[(long long)s * n + i];
    vout[i] = acc;
  }
}

}  // namespace

}  // namespace mx
