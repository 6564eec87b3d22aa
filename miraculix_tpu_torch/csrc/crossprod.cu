// Exact integer crossproducts decode(za) decode(zb)^T (the GRM and LD core).
//
// One 64 x 64 dp4a tile product, launched three ways:
//   - K3, crossprod_kernel: M = decode(zq) decode(zq)^T on the upper tile
//     pairs, mirrored in the kernel.  Replaces
//     miraculix_tpu/ops/grm.py:_crossprod_diag_kernel (diagonal tiles) and
//     miraculix_tpu/ops/grm.py:_crossprod_wrap_kernel (off-diagonal upper
//     blocks on the exact-cover grid, mirrored by the launcher).
//   - crossprod_rect_kernel on the full grid: the rectangular
//     decode(za) decode(zb)^T [ra, rb].  Replaces
//     miraculix_tpu/ops/grm.py:_crossprod_kernel (packed_crossprod_rect, the
//     LD row blocks, grm_blocked/ld_blocked tiles, triangle=False).
//   - crossprod_rect_kernel with `upper` on (zq, zq): tiles wholly below the
//     diagonal return at once and write nothing; the caller merges the
//     mirror.  Replaces miraculix_tpu/ops/grm.py:_crossprod_tri_kernel (the
//     masked rectangular grid, wrap=False).
//
// Words: int32 planar16 [rows, kw]; outputs int32, every entry written except
// the skipped tiles of `upper`.  Exact: each product is <= 4 and the caller
// guarantees 4 * 16 * kw < 2^31, so the int32 sums equal the reference's bit
// for bit.  Rows past ra/rb and words past kw read as 0.
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
//   - K3's blocks walk only the upper tile pairs (bi <= bj): block p decodes
//     its pair from the triangular number of p.  A tile whose two row ranges
//     are the same rows of one operand loads and expands its words once and
//     uses them on both sides; K3's off-diagonal tiles write their result
//     and its mirror.
// int8 tensor-core (mma / wgmma s8) versions are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

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

// acc[i][j] = row row0 + ty*4 + i of decode(za) . row col0 + tx*4 + j of
// decode(zb).  `same`: both ranges are the same rows of one operand.
__device__ __forceinline__ void tile_product(
    const uint32_t* __restrict__ za, int ra, const uint32_t* __restrict__ zb,
    int rb, int kw, int row0, int col0, bool same, int (*as)[KT][PAD],
    int (*bs)[KT][PAD], int (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int (*other)[KT][PAD] = same ? as : bs;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < kw; k0 += KT) {
    load_expand(za, ra, kw, row0, k0, as);
    if (!same) load_expand(zb, rb, kw, col0, k0, bs);
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
}

__global__ void __launch_bounds__(THREADS)
crossprod_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                 int* __restrict__ out) {
  __shared__ __align__(16) int as[4][KT][PAD];
  __shared__ __align__(16) int bs[4][KT][PAD];
  int bi, bj;
  mx::upper_pair(blockIdx.x, bi, bj);
  const bool diag = bi == bj;
  const int row0 = bi * TILE, col0 = bj * TILE;
  int acc[4][4];
  tile_product(zq, rows, zq, rows, kw, row0, col0, diag, as, bs, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

// grid (tiles of rb, tiles of ra); `upper` requires za == zb, ra == rb
__global__ void __launch_bounds__(THREADS)
crossprod_rect_kernel(const uint32_t* __restrict__ za, int ra,
                      const uint32_t* __restrict__ zb, int rb, int kw,
                      int upper, int* __restrict__ out) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (upper && bj < bi) return;  // wholly below the diagonal: the mirror's
  __shared__ __align__(16) int as[4][KT][PAD];
  __shared__ __align__(16) int bs[4][KT][PAD];
  const int row0 = bi * TILE, col0 = bj * TILE;
  int acc[4][4];
  // one expansion serves both sides only where both ranges are the same rows
  // of one operand: two views of one buffer may end at different rows
  tile_product(za, ra, zb, rb, kw, row0, col0,
               za == zb && ra == rb && bi == bj, as, bs, acc);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (r < ra && c < rb) out[(long long)r * rb + c] = acc[i][j];
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

// out: int32 [ra, rb].  upper != 0: za == zb, ra == rb, and the tiles wholly
// below the diagonal are left unwritten.  Returns the cudaError_t.
extern "C" int mx_crossprod_rect(const void* za, int ra, const void* zb,
                                 int rb, int kw, int upper, void* out,
                                 void* stream) {
  if (ra < 1 || rb < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  if (upper && (za != zb || ra != rb)) return (int)cudaErrorInvalidValue;
  const int ta = (ra + TILE - 1) / TILE, tb = (rb + TILE - 1) / TILE;
  if (ta > 65535) return (int)cudaErrorInvalidValue;
  crossprod_rect_kernel<<<dim3(tb, ta), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)za, ra, (const uint32_t*)zb, rb, kw, upper, (int*)out);
  return (int)cudaGetLastError();
}
