// Skinny packed product for RHS of at most 64 columns (the "tall" schedule).
//
// Replaces miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel (split mode, with
// _tall_split_rows) and, when a center vector is given,
// miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel_cv.
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
//
// Bound on H100: the FMA pipe.  Every packed word read feeds 16*n FMAs and
// 16 decodes, so at n >= 4 the CUDA cores, not HBM, set the time.  Design:
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

namespace {

constexpr int WORDS = 32;   // packed words (output word columns) per block
constexpr int S_TILE = 64;  // contraction rows staged per step
constexpr int MAX_N = 64;   // widest RHS this schedule takes

__device__ __forceinline__ float geno(uint32_t w, int m) {
  // (w >> 2m) & 3 as an exact float: 2^23 + g has the bit pattern
  // 0x4B000000 | g, so subtracting 2^23 leaves g
  return __int_as_float(((w >> (2 * m)) & 3u) | 0x4B000000u) - 8388608.0f;
}

template <int JT>
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
      bs[i] = (r < rows && j < n) ? b[(s0 + r) * n + j] : 0.f;
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
    if (do_v && tid < n)
      for (int r = 0; r < rows; ++r) vacc = fmaf(cvs[r], bs[r * width + tid], vacc);
    __syncthreads();
  }

  const long long out_rows = 16LL * kwi;
  float* dst = part + (long long)split * n * out_rows;
  if (w < kwi) {
#pragma unroll
    for (int t = 0; t < JT; ++t) {
      const int j = j0 + t;
      if (j < n) {
#pragma unroll
        for (int m = 0; m < 16; ++m) dst[j * out_rows + m * kwi + w] = acc[m][t];
      }
    }
  }
  if (do_v && tid < n) vpart[split * n + tid] = vacc;
}

// out[i] = sum over splits of part[s][i], in split order; the first n
// threads do the same for the center partials.
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

template <int JT>
void launch_tall(const uint32_t* zq, int kwi, const float* b,
                 long long contract, int n, const float* cv, long long rps,
                 int splits, float* part, float* vpart, cudaStream_t st) {
  dim3 block(WORDS, (n + JT - 1) / JT);
  dim3 grid((kwi + WORDS - 1) / WORDS, splits);
  const size_t smem =
      sizeof(float) * (S_TILE * block.y * JT + S_TILE * WORDS + S_TILE);
  tall_kernel<JT><<<grid, block, smem, st>>>(zq, kwi, b, contract, n, cv, rps,
                                             part, vpart);
}

}  // namespace

// JT (RHS columns per warp) for an n-column RHS; the wrapper sizes its
// split workspace with the same rule.
// Measured on H100: 4 columns (126 registers) beats 8 (202 registers, half
// the resident warps) up to n = 32; n > 32 needs 8 to stay within 8 warps.
extern "C" int mx_tall_cols_per_warp(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 32 ? 4 : 8;
}

// ct: f32 [n, 16*kwi]; vout: f32 [n] (only with cv).  With splits > 1,
// work: f32 [splits, n, 16*kwi] and vwork: f32 [splits, n] hold the split
// partials.  Returns the cudaError_t of the launches.
extern "C" int mx_tall_dgemm(const void* zq, int kwi, const void* b,
                             long long contract, int n, const void* cv,
                             void* ct, void* vout, void* work, void* vwork,
                             int splits, void* stream) {
  if (n < 1 || n > MAX_N || kwi < 1 || splits < 1 || contract < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rps = (contract + splits - 1) / splits;
  float* part = splits == 1 ? (float*)ct : (float*)work;
  float* vpart = cv == nullptr ? nullptr
                               : (splits == 1 ? (float*)vout : (float*)vwork);
  const auto* z = (const uint32_t*)zq;
  const auto* bf = (const float*)b;
  const auto* c = (const float*)cv;
  switch (mx_tall_cols_per_warp(n)) {
    case 1: launch_tall<1>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    case 2: launch_tall<2>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    case 4: launch_tall<4>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
    default: launch_tall<8>(z, kwi, bf, contract, n, c, rps, splits, part, vpart, st); break;
  }
  if (splits > 1) {
    const long long len = 16LL * kwi * n;
    const int threads = 256;
    const long long blocks = (len + threads - 1) / threads;
    reduce_splits<<<(unsigned)blocks, threads, 0, st>>>(
        part, splits, len, (float*)ct, vpart, n, (float*)vout);
  }
  return (int)cudaGetLastError();
}
