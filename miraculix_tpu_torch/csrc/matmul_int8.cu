// Exact int8-digit product out = decode(zq) @ D (the f64 tier's digit pass).
//
// Replaces miraculix_tpu/ops/dgemm.py:_pmm_kernel_int8 (launched by
// packed_matmul_int8): out[r, j] = sum_c decode(zq)[r, c] * D[c, j] in int32,
// exactly.  Genotypes are 0..3 and the f64 tier's digits lie in [-64, 64], so
// each product is at most 192 in size and the caller guarantees
// 192 * 16 * kw < 2^31: the int32 sums are the reference's bit for bit.
//
// Operands:
//   - words: uint32 planar16 [rows, kw]; rows past `rows` and words past kw
//     read as 0;
//   - digit words dp: int32 [4][kw][n], re-laid by the launcher from the
//     int8 digits D [16*kw, n] (plane-major rows m*kw + w, zero past the
//     caller's rows): byte b of dp[q][w][j] is D[(4b + q)*kw + w, j], signed.
// A word's r_q = (w >> 2q) & 0x03030303 holds planes q, q+4, q+8 and q+12 as
// int8x4, so out[r, j] = sum_w sum_q dp4a(r_q(zq[r, w]), dp[q][w][j]) with
// the signed x signed dp4a.
//
// Bound on H100: integer dot-product issue (IDP4A), rows * 16*kw * n
// multiply-adds at four per dp4a; the words are read once per column tile.
// Design:
//   - BM x BN output tiles of 256 threads with 4 x 4 outputs each; per
//     KT-word step a block expands its rows' words once into shared memory
//     (reused by BN columns) and stages the matching digit words beside them;
//   - two tile shapes: 64 x 64 for wide digit RHS, and 256 x 16 for narrow
//     ones (a one-column f64 product has 8 digit columns); the launcher
//     picks one;
//   - a grid dimension over column tiles takes any n; the contraction splits
//     over gridDim.z where the row and column tiles alone would not fill the
//     card, and the splits add their int32 partials with atomicAdd (integer
//     addition: the same bits in every order).
// int8 tensor-core (mma / wgmma s8) versions are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int BM, int BN, int KT>
__global__ void __launch_bounds__(THREADS)
matmul_int8_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                   const int* __restrict__ dp, int n, int words_per_split,
                   int* __restrict__ out) {
  constexpr int TX = BN / 4;
  static_assert((BM / 4) * TX == THREADS, "4 x 4 outputs per thread");
  constexpr int APAD = BM + 4, BPAD = BN + 4;  // int4-aligned row strides
  __shared__ __align__(16) int as[4][KT][APAD];
  __shared__ __align__(16) int bs[4][KT][BPAD];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int w_begin = blockIdx.z * words_per_split;
  const int w_end = min(kw, w_begin + words_per_split);

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = w_begin; k0 < w_end; k0 += KT) {
    for (int i = threadIdx.x; i < BM * KT; i += THREADS) {
      const int r = i / KT, k = i % KT;
      const uint32_t w = (row0 + r < rows && k0 + k < w_end)
                             ? __ldg(zq + (long long)(row0 + r) * kw + k0 + k)
                             : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) as[q][k][r] = (int)((w >> (2 * q)) & 0x03030303u);
    }
    for (int i = threadIdx.x; i < 4 * KT * BN; i += THREADS) {
      const int c = i % BN, k = (i / BN) % KT, q = i / (BN * KT);
      bs[q][k][c] = (col0 + c < n && k0 + k < w_end)
                        ? __ldg(dp + ((long long)q * kw + k0 + k) * n + col0 + c)
                        : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KT; ++k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 a = *reinterpret_cast<const int4*>(&as[q][k][ty * 4]);
        const int4 b = *reinterpret_cast<const int4*>(&bs[q][k][tx * 4]);
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

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (r < rows && c < n) {
        int* o = out + (long long)r * n + c;
        if (split) atomicAdd(o, acc[i][j]);
        else *o = acc[i][j];
      }
    }
  }
}

template <int BM, int BN>
long long tiles(int rows, int n) {
  return (long long)((rows + BM - 1) / BM) * ((n + BN - 1) / BN);
}

}  // namespace

// Blocks of one contraction split for an [rows, n] output on the narrow
// (256 x 16) or the wide (64 x 64) tile.
extern "C" long long mx_matmul_int8_blocks(int rows, int n, int narrow) {
  return narrow ? tiles<256, 16>(rows, n) : tiles<64, 64>(rows, n);
}

// out: int32 [rows, n], zeroed by the caller when splits > 1.  Returns the
// cudaError_t of the launch.
extern "C" int mx_matmul_int8(const void* zq, int rows, int kw, const void* dp,
                              int n, int narrow, int splits, void* out,
                              void* stream) {
  if (rows < 1 || kw < 1 || n < 1 || splits < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int bm = narrow ? 256 : 64, bn = narrow ? 16 : 64;
  const int kt = narrow ? 8 : 16;
  // whole KT steps per split, so that no split starts mid-step
  int per = (kw + splits - 1) / splits;
  per = (per + kt - 1) / kt * kt;
  const dim3 grid((n + bn - 1) / bn, (rows + bm - 1) / bm,
                  (kw + per - 1) / per);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (narrow)
    matmul_int8_kernel<256, 16, 8><<<grid, THREADS, 0, s>>>(
        (const uint32_t*)zq, rows, kw, (const int*)dp, n, per, (int*)out);
  else
    matmul_int8_kernel<64, 64, 16><<<grid, THREADS, 0, s>>>(
        (const uint32_t*)zq, rows, kw, (const int*)dp, n, per, (int*)out);
  return (int)cudaGetLastError();
}
