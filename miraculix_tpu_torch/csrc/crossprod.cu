// Exact integer crossproduct M = decode(zq) decode(zq)^T (the GRM core).
//
// Replaces miraculix_tpu/ops/grm.py:_crossprod_diag_kernel (diagonal tiles)
// and miraculix_tpu/ops/grm.py:_crossprod_wrap_kernel (off-diagonal upper
// blocks on the exact-cover grid, mirrored by the launcher) with ONE kernel.
//
// zq: int32 planar16 words [rows, kw]; out: int32 [rows, rows], every entry
// written.  Exact: each product is <= 4 and the caller guarantees
// 4 * 16 * kw < 2^31, so the int32 sums equal the reference's bit for bit.
//
// Bound on H100: integer dot-product issue (IDP4A) -- 16*kw products per
// output pair; the packed operand is tiny in comparison.  Design:
//   - a word's 16 genotypes become four int8x4 registers with one shift and
//     one mask each: r_q = (w >> 2q) & 0x03030303 holds planes q, q+4, q+8,
//     q+12.  Rows i and j share the word -> SNP map, so
//     sum_w sum_q dp4a(r_q(i), r_q(j)) is the full contraction;
//   - 64 x 64 output tiles, 256 threads with 4 x 4 outputs each; words are
//     expanded once into shared memory per KT-word step and reused by 64
//     rows of the partner tile;
//   - blocks walk only the upper tile pairs (bi <= bj): block p decodes
//     its pair from the triangular number of p.  A diagonal tile loads and
//     expands its words once and uses them on both sides; an off-diagonal
//     tile writes its result and its mirror.
// int8 tensor-core (mma / wgmma s8) versions are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;        // output tile edge
constexpr int KT = 16;          // packed words per shared-memory step
constexpr int PAD = TILE + 4;   // row stride: keeps int4 alignment, eases banks
constexpr int THREADS = 256;

__device__ __forceinline__ void load_expand(const uint32_t* __restrict__ zq,
                                            int rows, int kw, int row0, int k0,
                                            int (*dst)[KT][PAD]) {
  for (int i = threadIdx.x; i < TILE * KT; i += THREADS) {
    const int r = i / KT, k = i % KT;
    const uint32_t w = (row0 + r < rows && k0 + k < kw)
                           ? __ldg(zq + (long long)(row0 + r) * kw + k0 + k)
                           : 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q][k][r] = (int)((w >> (2 * q)) & 0x03030303u);
  }
}

__global__ void __launch_bounds__(THREADS)
crossprod_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                 int* __restrict__ out) {
  __shared__ __align__(16) int as[4][KT][PAD];
  __shared__ __align__(16) int bs[4][KT][PAD];

  // upper tile pair (bi <= bj) of linear index p = bj*(bj+1)/2 + bi
  const long long p = blockIdx.x;
  int bj = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while ((long long)bj * (bj + 1) / 2 > p) --bj;
  while ((long long)(bj + 1) * (bj + 2) / 2 <= p) ++bj;
  const int bi = (int)(p - (long long)bj * (bj + 1) / 2);
  const bool diag = bi == bj;
  const int row0 = bi * TILE, col0 = bj * TILE;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int (*other)[KT][PAD] = diag ? as : bs;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kw; k0 += KT) {
    load_expand(zq, rows, kw, row0, k0, as);
    if (!diag) load_expand(zq, rows, kw, col0, k0, bs);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 a = *reinterpret_cast<const int4*>(&as[q][k][ty * 4]);
        const int4 b = *reinterpret_cast<const int4*>(&other[q][k][tx * 4]);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (r < rows && c < rows) {
        out[(long long)r * rows + c] = acc[i][j];
        if (!diag) out[(long long)c * rows + r] = acc[i][j];
      }
    }
  }
}

}  // namespace

// out: int32 [rows, rows].  Returns the cudaError_t of the launch.
extern "C" int mx_crossprod(const void* zq, int rows, int kw, void* out,
                            void* stream) {
  if (rows < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (rows + TILE - 1) / TILE;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  crossprod_kernel<<<(unsigned)pairs, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)zq, rows, kw, (int*)out);
  return (int)cudaGetLastError();
}
