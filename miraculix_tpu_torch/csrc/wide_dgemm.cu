// Wide packed product: C[rows, n] = decode(zq[rows, kw]) @ B[16*kw, n].
//
// Replaces, in miraculix_tpu/ops/dgemm.py (all launched by packed_matmul):
//   _pmm_kernel_split_wide_pp (B3) and _pmm_kernel_split_wide (B11), the
//     fast tier for n > 64 -- here RHS_F32 (f32 FMA on exact genotype
//     products: as accurate as their bf16 hi/lo split, or better);
//   _pmm_kernel_split (B4), the split tier for n <= 64 -- RHS_HILO;
//   _pmm_kernel_bf16 and _pmm_kernel_f32 (B5) -- RHS_BF16 and RHS_F32.
// The per-plane order of B3 and the 4^-m RHS scaling of _reorder_rhs are
// TPU scheduling devices; this kernel computes the function: decoded column
// m*kw + w is word w, plane m, and B rows at or past `cols` count as zero.
//
// Bound on H100: operations.  Each packed word feeds 16 genotypes times n
// columns, so at the GWAS shapes (n = 65: zq_n 16384 x 4096 words against
// B [65536, 65]) the work is 1.4e11 FLOP: 0.28 ms as the two bf16
// tensor-core passes of the split tier (0.14 ms bf16, 0.42 ms for the f32
// tier's three), against 0.09 ms for the 0.29 GB the call must move.  This
// design runs on the f32 FMA pipe instead (2.1 ms at its 67 TFLOP/s peak):
//   - a block owns 128 output rows and one column chunk (n is cut into
//     ceil(n / 64) chunks of equal width, so n = 65 runs as 33 + 32 and
//     not as 64 + 1); 256 threads, each 4 rows x RN columns of the chunk;
//   - per step of 4 packed words the block decodes its 128 x 64 genotypes
//     into shared memory once (shift, mask, OR into the mantissa of 2^23,
//     one FADD) and stages the matching 64 RHS rows, rounded for the tier;
//     the next step's words and RHS values are loaded into registers while
//     the current step computes, so no global load is waited on;
//     the inner loop is then a plain shared-memory SGEMM micro-tile: one
//     128-bit load of 4 genotypes and one or two of RN RHS values per
//     4*RN FMAs, every load a broadcast or one contiguous 128-byte line;
//   - narrow outputs (16384 rows) split the contraction over gridDim.z
//     into a workspace that a second kernel sums in split order: no
//     atomics, results repeat bit for bit.  Rows and words off the tile
//     are masked.
// Tensor cores (bf16 hi/lo wgmma) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int BM = 128;        // output rows per block
constexpr int TW = 4;          // packed words per contraction step
constexpr int BK = 16 * TW;    // decoded columns per step
constexpr int CG = 8;          // column groups per block
constexpr int RM = 4;          // rows per thread
constexpr int THREADS = 256;   // (BM / RM) row groups x CG column groups
constexpr int MAX_CHUNK = 64;  // widest column chunk of one block

static_assert((BM / RM) * CG == THREADS, "thread layout");
static_assert(THREADS == 2 * BM && TW % 2 == 0, "decode layout");

// shared-memory slot of RHS value (k, column group g, column t of the
// group): the groups' 4-wide slices of one k row are contiguous, so each
// 128-bit load of a warp reads one 128-byte line
template <int RNP>
__device__ __forceinline__ int bslot(int k, int g, int t) {
  return k * CG * RNP + (t / 4) * (CG * 4) + g * 4 + (t % 4);
}

template <int RHS, int RN>
__global__ void __launch_bounds__(THREADS, 2)
wide_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
            const float* __restrict__ b, long long cols, int n, int cw,
            int tiles_per_split, float* __restrict__ out) {
  constexpr int RNP = RN <= 4 ? 4 : 8;   // RN padded to whole 128-bit loads
  __shared__ __align__(16) float as[BK * BM];        // decoded [k][row]
  __shared__ __align__(16) float bs[BK * CG * RNP];  // RHS [k][group][t]

  const int tid = threadIdx.x;
  const int cgi = tid % CG, rg = tid / CG;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * cw;
  const int ncols = min(cw, n - c0);
  const int ntiles = (kw + TW - 1) / TW;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);

  // decode assignment: one row, two consecutive words of the step
  const int drow = tid % BM;
  const int dw = (tid / BM) * (TW / 2);
  const bool drow_ok = row0 + drow < rows;
  const uint32_t* zrow = zq + (long long)(row0 + drow) * kw;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int t = 0; t < RN; ++t) acc[i][t] = 0.f;

  // the next step's words and RHS values, loaded into registers while the
  // current step computes.  Thread tid stages column bj = tid % 64 of the
  // chunk for word bw = tid / 64 of the step: its slot m holds decoded
  // column m*kw + w0 + bw, so the 16 slots differ by a constant stride.
  static_assert(THREADS == MAX_CHUNK * TW, "RHS slab layout");
  const int bj = tid % MAX_CHUNK, bw = tid / MAX_CHUNK;
  const bool bj_staged = bj < CG * RN, bj_ok = bj < ncols;
  const int bg = bj / RN, bt = bj % RN;
  const long long plane_stride = (long long)kw * n;
  uint32_t wreg[TW / 2];
  float breg[16];
  auto fetch = [&](int tile) {
    const int w0 = tile * TW;
#pragma unroll
    for (int i = 0; i < TW / 2; ++i)
      wreg[i] = (drow_ok && w0 + dw + i < kw) ? __ldg(zrow + w0 + dw + i) : 0u;
    const bool ok = bj_ok && w0 + bw < kw;
    const long long left = cols - (w0 + bw);  // B rows from this word on
    const float* p = b + (long long)(w0 + bw) * n + c0 + bj;
#pragma unroll
    for (int m = 0; m < 16; ++m)
      breg[m] = (ok && (long long)m * kw < left) ? __ldg(p + m * plane_stride)
                                                 : 0.f;
  };
  if (t_begin < t_end) fetch(t_begin);

  for (int tile = t_begin; tile < t_end; ++tile) {
#pragma unroll
    for (int i = 0; i < TW / 2; ++i)
#pragma unroll
      for (int m = 0; m < 16; ++m)
        as[(m * TW + dw + i) * BM + drow] = mx::geno(wreg[i], m);
    if (bj_staged)
#pragma unroll
      for (int m = 0; m < 16; ++m)
        bs[bslot<RNP>(m * TW + bw, bg, bt)] = mx::rhs_value<RHS>(breg[m]);
    __syncthreads();
    if (tile + 1 < t_end) fetch(tile + 1);
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k * BM + rg * RM]);
      float bv[RNP];
#pragma unroll
      for (int q = 0; q < RNP / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(&bs[bslot<RNP>(k, cgi, 4 * q)]);
        bv[4 * q] = v.x;
        bv[4 * q + 1] = v.y;
        bv[4 * q + 2] = v.z;
        bv[4 * q + 3] = v.w;
      }
      const float av[RM] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int t = 0; t < RN; ++t) acc[i][t] = fmaf(av[i], bv[t], acc[i][t]);
    }
    __syncthreads();
  }

  float* dst = out + (long long)blockIdx.z * rows * n;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + rg * RM + i;
    if (r < rows) {
#pragma unroll
      for (int t = 0; t < RN; ++t) {
        const int j = cgi * RN + t;
        if (j < ncols) dst[(long long)r * n + c0 + j] = acc[i][t];
      }
    }
  }
}

template <int RHS>
void launch_rhs(int rn, dim3 grid, const uint32_t* zq, int rows, int kw,
                const float* b, long long cols, int n, int cw, int tps,
                float* part, cudaStream_t st) {
#define MX_WIDE(R)                                                         \
  case R:                                                                  \
    wide_kernel<RHS, R><<<grid, THREADS, 0, st>>>(zq, rows, kw, b, cols, n, \
                                                  cw, tps, part);          \
    break;
  switch (rn) {
    MX_WIDE(1) MX_WIDE(2) MX_WIDE(3) MX_WIDE(4)
    MX_WIDE(5) MX_WIDE(6) MX_WIDE(7) MX_WIDE(8)
  }
#undef MX_WIDE
}

}  // namespace

// Column chunks of an n-column RHS (the wrapper sizes its split count with
// the same rule).
extern "C" int mx_wide_chunks(int n) {
  return (n + MAX_CHUNK - 1) / MAX_CHUNK;
}

// zq: int32 words [rows, kw]; b: f32 [cols, n] with cols <= 16*kw; out:
// f32 [rows, n].  rhs: 0 = f32, 1 = bf16 (RNE), 2 = bf16 hi + lo.  With
// splits > 1, work: f32 [splits, rows, n] holds the split partials.
// Returns the cudaError_t of the launches.
extern "C" int mx_wide_dgemm(const void* zq, int rows, int kw, const void* b,
                             long long cols, int n, int rhs, void* out,
                             void* work, int splits, void* stream) {
  if (rows < 1 || kw < 1 || n < 1 || cols < 0 || cols > 16LL * kw ||
      splits < 1 || rhs < 0 || rhs > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunks = mx_wide_chunks(n);
  const int cw = (n + chunks - 1) / chunks;
  const int rn = (cw + CG - 1) / CG;
  const int ntiles = (kw + TW - 1) / TW;
  // a split left without tiles writes zeros, which the sum ignores
  const int tps = (ntiles + splits - 1) / splits;
  dim3 grid((rows + BM - 1) / BM, chunks, splits);
  float* part = splits == 1 ? (float*)out : (float*)work;
  const auto* z = (const uint32_t*)zq;
  const auto* bf = (const float*)b;
  switch (rhs) {
    case 0: launch_rhs<mx::RHS_F32>(rn, grid, z, rows, kw, bf, cols, n, cw, tps, part, st); break;
    case 1: launch_rhs<mx::RHS_BF16>(rn, grid, z, rows, kw, bf, cols, n, cw, tps, part, st); break;
    default: launch_rhs<mx::RHS_HILO>(rn, grid, z, rows, kw, bf, cols, n, cw, tps, part, st); break;
  }
  if (splits > 1) {
    const long long len = (long long)rows * n;
    const int threads = 256;
    mx::reduce_splits<<<(unsigned)((len + threads - 1) / threads), threads,
                        0, st>>>(part, splits, len, (float*)out, nullptr, 0,
                                 nullptr);
  }
  return (int)cudaGetLastError();
}
