// Weighted crossproduct W = decode(zq) diag(w) decode(zq)^T at f32 grade.
//
// Replaces miraculix_tpu/ops/grm.py:_crossprod_weighted_kernel (with
// _plane_prod_weighted and the wrapped-pair triangle grid of _wrap_pair):
// the GCTA GRM's numerator (grm_yang) and the per-pair denominators.
//
// zq: int32 planar16 words [rows, kw]; w: f32 [16, kw], plane-major (decoded
// column m*kw + k is SNP m*kw + k and has weight w[m][k]); out: f32
// [rows, rows], every entry written.  Words past kw read as 0.
//
// Grade: z is 0, 1 or 2, so w*z_j and z_i*(w*z_j) are exact in f32 -- the
// reference splits w*z into three bf16 digits so that its MXU passes are
// exact, and one f32 FMA per product does the same work here.  Only the sum
// rounds: each thread sums the 16*KW products of a step in f32 and adds that
// partial to an f64 total, so the 65,536-term sums of a GRM row do not drift
// as one long f32 sum of positive terms would (~1e-5 relative); the f64 adds
// are one per 16*KW FMAs.
//
// Bound on H100: the f32 FMA rate of the CUDA cores (16*kw FMAs per output
// pair); the tensor-core form, three bf16 passes, is later work.  Design:
// 64 x 64 output tiles as K3's (crossprod.cu); the blocks walk the upper
// tile pairs and mirror in the kernel, or the full grid when `full` is set.
// Per step each thread loads two words of each side and expands their 16
// genotypes into shared memory as floats, the partner side times its
// weight.  128 threads with 4 x 8 outputs each: per product step a warp
// reads one float4 of its rows and two of its columns (the 8 columns are two
// runs of 4, 32 apart, so each read is one shared-memory wavefront) for 32
// FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int TILE = 64;        // output tile edge
constexpr int KW = 4;           // packed words per shared-memory step
constexpr int KS = 16 * KW;     // products per output per step
constexpr int THREADS = 128;    // 16 x 8 threads; TILE * KW / 2 words a side

__global__ void __launch_bounds__(THREADS)
crossprod_weighted_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                          const float* __restrict__ w, int full,
                          float* __restrict__ out) {
  __shared__ __align__(16) float as[KS][TILE];
  __shared__ __align__(16) float bs[KS][TILE];
  int bi, bj;
  if (full) {
    bi = blockIdx.y;
    bj = blockIdx.x;
  } else {
    mx::upper_pair(blockIdx.x, bi, bj);
  }
  const bool mirror = !full && bi != bj;
  const int row0 = bi * TILE, col0 = bj * TILE;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int lr = threadIdx.x % TILE, lk = threadIdx.x / TILE;  // lk: 0, 1

  double acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;

  for (int k0 = 0; k0 < kw; k0 += KW) {
#pragma unroll
    for (int h = 0; h < KW; h += 2) {      // words lk and lk + 2 of the step
      const int kk = lk + h, k = k0 + kk;
      const bool kin = k < kw;
      const uint32_t wa =
          (kin && row0 + lr < rows) ? __ldg(zq + (long long)(row0 + lr) * kw + k)
                                    : 0u;
      const uint32_t wb =
          (kin && col0 + lr < rows) ? __ldg(zq + (long long)(col0 + lr) * kw + k)
                                    : 0u;
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        const float wt = kin ? __ldg(w + (long long)m * kw + k) : 0.f;
        as[m * KW + kk][lr] = mx::geno(wa, m);
        bs[m * KW + kk][lr] = mx::geno(wb, m) * wt;
      }
    }
    __syncthreads();
    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int s = 0; s < KS; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(&as[s][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][32 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += (double)part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? 0 : 28) + tx * 4 + j;
      if (r < rows && c < rows) {
        const float v = (float)acc[i][j];
        out[(long long)r * rows + c] = v;
        if (mirror) out[(long long)c * rows + r] = v;
      }
    }
  }
}

}  // namespace

// out: f32 [rows, rows]; full != 0 walks every tile, otherwise the upper
// tile pairs with their mirror.  Returns the cudaError_t of the launch.
extern "C" int mx_crossprod_weighted(const void* zq, int rows, int kw,
                                     const void* w, int full, void* out,
                                     void* stream) {
  if (rows < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (rows + TILE - 1) / TILE;
  dim3 grid;
  if (full) {
    if (nt > 65535) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)nt, (unsigned)nt);
  } else {
    const long long pairs = nt * (nt + 1) / 2;
    if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)pairs);
  }
  crossprod_weighted_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)zq, rows, kw, (const float*)w, full, (float*)out);
  return (int)cudaGetLastError();
}
