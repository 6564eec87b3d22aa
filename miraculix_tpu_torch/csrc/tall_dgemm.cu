// Skinny packed product for narrow RHS (the "tall" schedule).
//
// Replaces miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel in its three modes
// (split, with _tall_split_rows; bf16; f32) and, when a center vector is
// given, miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel_cv.
//
// Computes, for zq_other int32 [spad, kwi] (planar16 over the output axis,
// packed rows = contraction axis) and B f32 [contract, n]:
//
//     C[r, j] = sum_{s < contract} decode(zq_other)[s, r] * B[s, j]
//     v[j]    = sum_{s < contract} cv[s] * B[s, j]          (if cv != null)
//
// with output row r = m*kwi + w (word w, plane m), written TRANSPOSED as
// ct[j, r] (the wrapper returns the [16*kwi, n] view).  Products are exact
// f32 (genotypes are 0/1/2) accumulated with f32 FMA: the same function as
// the TPU kernel at better precision than its bf16 hi/lo split (~3e-6).
// The split and f32 modes share this arithmetic; the bf16 mode rounds each
// B value once to bf16 (nearest even) as it is staged, as the TPU kernel's
// single bf16 pass does.  dgemm routes RHS of up to 64 columns here at the
// fast tier and up to 128 at the bf16 and f32 tiers; wider RHS run as
// column chunks of at most 64 over gridDim.z.
//
// Bound on H100: the larger of the bytes moved (the packed panel: 0.08 ms at
// 65,536 x 16,384) and the tier's bf16 tensor-core passes (one to three;
// 0.14 ms for the split tier at n = 32).  This design runs on the f32 FMA
// pipe instead: every packed word read feeds 16*n FMAs and 16 decodes, so
// at n >= 4 the CUDA cores, not HBM, set its time.  Design:
//   - one lane per packed word; each warp of the block owns JT RHS columns,
//     so a thread keeps 16*JT accumulators in registers and the genotype
//     decode (shift, mask, OR into the mantissa of 2^23, one FADD -- no
//     int->float convert) is amortised over JT FMAs;
//   - per S_TILE step the block stages its packed words (one coalesced
//     128-byte row per warp load), the B rows and cv in shared memory, so
//     the inner loop reads no global memory; B is read as warp-wide
//     broadcasts.  Shared memory is sized by the staged width, not by the
//     64-column maximum: a one-warp block at n = 1 needs 8.7 KB, so ~26
//     of them stay resident per SM instead of 9;
//   - the contraction is split over gridDim.y so that narrow outputs still
//     fill the card; split partials land in a workspace and a second kernel
//     sums them in a fixed order.  v is accumulated only by the blocks of
//     word tile 0 (the reference's i == 0 rule) and reduced the same way:
//     no atomics, results are run-to-run deterministic.
// Tensor-core (bf16 hi/lo wgmma) versions are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

constexpr int WORDS = 32;      // packed words (output word columns) per block
constexpr int S_TILE = 64;     // contraction rows staged per step
constexpr int MAX_CHUNK = 64;  // widest column chunk of one block

using mx::geno;

// column chunks of an n-column RHS and their (equal) width
__host__ __device__ inline int tall_chunks(int n) {
  return (n + MAX_CHUNK - 1) / MAX_CHUNK;
}
__host__ __device__ inline int chunk_width(int n) {
  return (n + tall_chunks(n) - 1) / tall_chunks(n);
}

template <int JT, int RHS>
__global__ void __launch_bounds__(256)
tall_kernel(const uint32_t* __restrict__ zq, int kwi,
            const float* __restrict__ b, long long contract, int n,
            const float* __restrict__ cv, long long rows_per_split,
            float* __restrict__ part, float* __restrict__ vpart) {
  extern __shared__ float smem[];
  const int width = blockDim.y * JT;          // staged (zero-padded) columns
  float* bs = smem;                                       // [S_TILE][width]
  uint32_t* zs = (uint32_t*)(bs + S_TILE * width);        // [S_TILE][WORDS]
  float* cvs = (float*)(zs + S_TILE * WORDS);             // [S_TILE]
  const int lane = threadIdx.x;
  const int grp = threadIdx.y;
  const int tid = grp * WORDS + lane;
  const int nthreads = blockDim.y * WORDS;
  const int w = blockIdx.x * WORDS + lane;
  const int split = blockIdx.y;
  const long long s_begin = (long long)split * rows_per_split;
  const long long s_end = min(contract, s_begin + rows_per_split);
  const int j0 = grp * JT;
  const int c0 = blockIdx.z * chunk_width(n);          // this chunk's columns
  const int ncols = min(chunk_width(n), n - c0);
  const bool do_v = cv != nullptr && blockIdx.x == 0;

  float acc[16][JT];
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int t = 0; t < JT; ++t) acc[m][t] = 0.f;
  float vacc = 0.f;

  for (long long s0 = s_begin; s0 < s_end; s0 += S_TILE) {
    const int rows = (int)min((long long)S_TILE, s_end - s0);
    for (int i = tid; i < S_TILE * width; i += nthreads) {
      const int r = i / width, j = i % width;
      bs[i] = (r < rows && j < ncols)
                  ? mx::rhs_value<RHS>(b[(s0 + r) * n + c0 + j]) : 0.f;
    }
#pragma unroll 8
    for (int r = grp; r < rows; r += blockDim.y)
      zs[r * WORDS + lane] = w < kwi ? __ldg(zq + (s0 + r) * kwi + w) : 0u;
    if (do_v)
      for (int r = tid; r < S_TILE; r += nthreads)
        cvs[r] = r < rows ? cv[s0 + r] : 0.f;
    __syncthreads();
    if (w < kwi) {
#pragma unroll 2
      for (int r = 0; r < rows; ++r) {
        const uint32_t word = zs[r * WORDS + lane];
        float bv[JT];
#pragma unroll
        for (int t = 0; t < JT; ++t) bv[t] = bs[r * width + j0 + t];
#pragma unroll
        for (int m = 0; m < 16; ++m) {
          const float g = geno(word, m);
#pragma unroll
          for (int t = 0; t < JT; ++t) acc[m][t] = fmaf(g, bv[t], acc[m][t]);
        }
      }
    }
    if (do_v && tid < ncols)
      for (int r = 0; r < rows; ++r) vacc = fmaf(cvs[r], bs[r * width + tid], vacc);
    __syncthreads();
  }

  const long long out_rows = 16LL * kwi;
  float* dst = part + (long long)split * n * out_rows;
  if (w < kwi) {
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = j0 + t;
      if (j < ncols) {
#pragma unroll
        for (int m = 0; m < 16; ++m)
          dst[(c0 + j) * out_rows + m * kwi + w] = acc[m][t];
      }
    }
  }
  if (do_v && tid < ncols) vpart[split * n + c0 + tid] = vacc;
}

template <int JT, int RHS>
void launch_tall(const uint32_t* zq, int kwi, const float* b,
                 long long contract, int n, const float* cv, long long rps,
                 int splits, float* part, float* vpart, cudaStream_t st) {
  dim3 block(WORDS, (chunk_width(n) + JT - 1) / JT);
  dim3 grid((kwi + WORDS - 1) / WORDS, splits, tall_chunks(n));
  const size_t smem =
      sizeof(float) * (S_TILE * block.y * JT + S_TILE * WORDS + S_TILE);
  tall_kernel<JT, RHS><<<grid, block, smem, st>>>(zq, kwi, b, contract, n, cv,
                                                  rps, part, vpart);
}

// JT (RHS columns per warp) for a column chunk of width cw.
// Measured on H100: 4 columns (126 registers) beats 8 (202 registers, half
// the resident warps) up to n = 32; n > 32 needs 8 to stay within 8 warps.
int cols_per_warp(int cw) {
  return cw <= 1 ? 1 : cw <= 2 ? 2 : cw <= 32 ? 4 : 8;
}

template <int RHS>
void launch_rhs(const uint32_t* z, int kwi, const float* bf, long long contract,
                int n, const float* c, long long rps, int splits, float* part,
                float* vpart, cudaStream_t st) {
  switch (cols_per_warp(chunk_width(n))) {
    case 1: launch_tall<1, RHS>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    case 2: launch_tall<2, RHS>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    case 4: launch_tall<4, RHS>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    default: launch_tall<8, RHS>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
  }
}

}  // namespace

// Warps launched per 32-word tile for an n-column RHS; the wrapper sizes
// its split count with the same rule.
extern "C" int mx_tall_warps_per_tile(int n) {
  const int jt = cols_per_warp(chunk_width(n));
  return tall_chunks(n) * ((chunk_width(n) + jt - 1) / jt);
}

// ct: f32 [n, 16*kwi]; vout: f32 [n] (only with cv).  rhs: 0 = B as
// given (split and f32 modes), 1 = bf16(B) (bf16 mode).  With splits > 1,
// work: f32 [splits, n, 16*kwi] and vwork: f32 [splits, n] hold the split
// partials.  Returns the cudaError_t of the launches.
extern "C" int mx_tall_dgemm(const void* zq, int kwi, const void* b,
                             long long contract, int n, const void* cv,
                             void* ct, void* vout, void* work, void* vwork,
                             int splits, int rhs, void* stream) {
  if (n < 1 || kwi < 1 || splits < 1 || contract < 0 || rhs < 0 || rhs > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rps = (contract + splits - 1) / splits;
  float* part = splits == 1 ? (float*)ct : (float*)work;
  float* vpart = cv == nullptr ? nullptr
                               : (splits == 1 ? (float*)vout : (float*)vwork);
  const auto* z = (const uint32_t*)zq;
  const auto* bf = (const float*)b;
  const auto* c = (const float*)cv;
  if (rhs == 0)
    launch_rhs<mx::RHS_F32>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st);
  else
    launch_rhs<mx::RHS_BF16>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st);
  if (splits > 1) {
    const long long len = 16LL * kwi * n;
    const int threads = 256;
    const long long blocks = (len + threads - 1) / threads;
    mx::reduce_splits<<<(unsigned)blocks, threads, 0, st>>>(
        part, splits, len, (float*)ct, vpart, n, (float*)vout);
  }
  return (int)cudaGetLastError();
}
