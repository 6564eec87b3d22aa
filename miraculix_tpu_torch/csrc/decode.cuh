// Genotype decode, RHS rounding, the split reduction and the upper tile-pair
// walk shared by the packed-product kernels.
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

// (w >> 2m) & 3 as an exact float: 2^23 + g has the bit pattern
// 0x4B000000 | g, so subtracting 2^23 leaves g (no int->float convert)
__device__ __forceinline__ float geno(uint32_t w, int m) {
  return __int_as_float(((w >> (2 * m)) & 3u) | 0x4B000000u) - 8388608.0f;
}

// x rounded once to bf16, to nearest even, and widened back
__device__ __forceinline__ float bf16_rne(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The RHS value each product uses, by precision:
//   RHS_F32  -- B as given (the fast and f32 tiers: f32 FMA, exact products);
//   RHS_BF16 -- bf16(B), rounded to nearest even (the bf16 tier);
//   RHS_HILO -- hi + lo with hi = bf16(B), lo = bf16(B - hi) (the split
//               tier's two bf16 halves; their sum has at most 17
//               significant bits, so it is exact in f32 and one FMA does
//               the work of the two bf16 passes).
enum Rhs { RHS_F32 = 0, RHS_BF16 = 1, RHS_HILO = 2 };

template <int RHS>
__device__ __forceinline__ float rhs_value(float b) {
  if (RHS == RHS_F32) return b;
  const float hi = bf16_rne(b);
  if (RHS == RHS_BF16) return hi;
  return hi + bf16_rne(b - hi);
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
    for (int s = 0; s < splits; ++s) acc += vpart[s * n + i];
    vout[i] = acc;
  }
}

}  // namespace

}  // namespace mx
