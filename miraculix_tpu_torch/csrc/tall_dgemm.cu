// Skinny packed product for narrow RHS (the "tall" schedule), on the
// tensor cores.
//
// Replaces miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel in its three modes
// (split, with _tall_split_rows; bf16; f32) and, when a center vector is
// given, miraculix_tpu/ops/dgemm.py:_pmm_tall_kernel_cv.
//
// Computes, for zq_other int32 [spad, kwi] (planar16 over the output axis,
// packed rows = contraction axis) and B f32 [contract, n]:
//
//     C[r, j] = sum_{s < contract} decode(zq_other)[s, r] * B'[s, j]
//     v[j]    = sum_{s < contract} cv[s] * B[s, j]          (if cv != null)
//
// with output row r = m*kwi + w (word w, plane m), written TRANSPOSED as
// ct[j, r] (the wrapper returns the [16*kwi, n] view).  B' is the sum of
// the mode's bf16 parts of B, each rounded to nearest even: hi (bf16
// mode), hi + lo with lo = bf16(B - hi) (split mode, the reference's two
// passes), hi + mid + lo with mid = bf16(B - hi), lo = bf16(B - hi - mid)
// (f32 mode: the three parts sum to B exactly, f32 subnormals aside).  The
// genotype codes 0..3 are exact in bf16, so every product is one bf16
// tensor-core pass per part, accumulated in f32.  v stays f32 (the
// reference computes it on the VPU from the f32 rows).
//
// Bound on H100: the larger of the bytes moved (the packed panel: 0.080 ms
// at 65,536 x 16,384) and the mode's bf16 tensor-core passes at 989 TFLOP/s
// (0.139 ms for the split mode at n = 32, 0.278 / 0.834 ms for bf16 / f32
// at n = 128).  Design:
//   - a pre-pass kernel splits B once into its 1-3 bf16 parts, laid out in
//     mma B-fragment order [chunk][16-row step][part][8-column tile][lane]
//     (one coalesced uint2 per lane and part), and, with cv, writes f32
//     partials of cv^T B per 128 rows, reduced in a fixed order;
//   - the main kernel runs warp-level mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  One M-tile is the 16 planes of one packed word, its K
//     axis 16 consecutive contraction rows: lane (g, t) takes planes g and
//     g+8 of the words of rows 2t, 2t+1, 2t+8, 2t+9 (decode.cuh's
//     a_fragment: __byte_perm pairs two words' halves, a shift, mask and OR
//     make the bf16 pair 128 + code, one bf16x2 subtraction leaves the
//     code; no convert).  The fragment rows land at ct[j, m*kwi + w], the
//     reference's plane-major order;
//   - each part's 16-row sum is one mma from zero; the parts' sums are
//     added smallest first, and the result to an f32 register total, by
//     round-to-nearest adds.  The tensor cores' f32 sums truncate addends
//     below the accumulator's window: accumulators that ran over a whole
//     contraction split drifted far past the 1e-5 limit on the H100 where
//     B is positive (its sums grow without cancelling);
//   - a block is 8 warps of 4 or 8 words (32 or 64 words) and one column
//     chunk (gridDim.z; at most 64 columns in one pass, 32 in two or three,
//     whose B fragments take two or three times the registers and shared
//     memory per column); a cp.async ring of 2 stages of 128 contraction
//     rows of words and B parts keeps the next stage's copies in flight
//     while one stage's mmas run, with one block barrier per stage (larger
//     stages measured faster: fewer barriers); the epilogue stores each
//     8-column tile through shared memory as rows of consecutive words;
//   - the contraction is split over gridDim.y to fill one wave of the
//     blocks the card holds at once; split partials land in a workspace
//     and reduce_splits sums them, and the cv partials, in a fixed order:
//     results are run-to-run deterministic.
// On the H100 it reaches about a fifth of its bound (0.65 ms at split 'n'
// 32): one block of 8 warps per SM at the widest instances (over 170
// registers), a decode of ~16 instructions per word and step, and four
// f32 adds per part, fragment and step.
// The Hopper route to the full tensor-core rate (wgmma with A from the
// decoded registers, B from shared memory, a warp-specialised TMA ring) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "mma.cuh"

namespace {

constexpr int K_STEP = 16;     // contraction rows of one mma
constexpr int KK = 8;          // mma steps per staged tile
constexpr int K_TILE = KK * K_STEP;
constexpr int STAGES = 2;      // cp.async ring depth
constexpr int WARPS = 8;       // warps of a main-kernel block
constexpr int THREADS = 32 * WARPS;
constexpr int V_ROWS = 128;    // contraction rows per cv partial
constexpr int MAX_PASSES = 3;

// Column chunks of an n-column RHS (gridDim.z) and their (equal) width:
// at most 64 columns for one pass, 32 for two or three.
inline int max_chunk(int passes) { return passes > 1 ? 32 : 64; }
inline int tall_chunks(int n, int passes) {
  return (n + max_chunk(passes) - 1) / max_chunk(passes);
}
inline int chunk_width(int n, int passes) {
  return (n + tall_chunks(n, passes) - 1) / tall_chunks(n, passes);
}
// 8-column mma tiles per chunk (5 to 7 round up to 8)
inline int n_tiles(int n, int passes) {
  const int t = (chunk_width(n, passes) + 7) / 8;
  return t <= 4 ? t : 8;
}
// mma steps of the padded contraction (a whole number of staged tiles)
inline long long k_steps(long long contract) {
  const long long tiles = contract <= 0 ? 1 : (contract + K_TILE - 1) / K_TILE;
  return tiles * KK;
}
// packed words per warp: 8 while the accumulators stay within 64 registers
__host__ __device__ constexpr int words_per_warp(int nt) {
  return nt <= 2 ? 8 : 4;
}

// ---------------------------------------------------------------------------
// Pre-pass: B -> bf16 parts in B-fragment order, and cv^T B partials.
// Grid (row blocks of V_ROWS, chunks * nt 8-column tiles), block 256: warp
// = one 16-row mma step of the row block, lane = its fragment lane (g, t),
// which holds column g of the tile at rows 2t, 2t+1 (.x) and 2t+8, 2t+9
// (.y), the lower row in the lower half.  Each lane writes one uint2 per
// part: a warp's stores are one coalesced 256-byte fragment.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
tall_parts(const float* __restrict__ b, long long contract, int n, int cw,
           int nt, long long ks_total, int passes,
           const float* __restrict__ cv, uint2* __restrict__ parts,
           float* __restrict__ vpre) {
  __shared__ float vs[8][8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y / nt, ntile = blockIdx.y % nt;
  const int q = ntile * 8 + g, j = c * cw + q;
  const bool col = q < cw && j < n;
  const long long ks = (long long)blockIdx.x * (V_ROWS / K_STEP) + warp;
  float vacc = 0.f;
  if (ks < ks_total) {
    uint32_t frag[MAX_PASSES][2] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {           // rows 2t, 2t+1, 2t+8, 2t+9
      const long long s = ks * K_STEP + 2 * t + (r & 1) + 8 * (r >> 1);
      const bool ok = col && s < contract;
      const float x = ok ? b[s * n + j] : 0.f;
      if (cv != nullptr && ok) vacc = fmaf(cv[s], x, vacc);
      // x = hi + mid + r2 exactly; each part is one bf16 rounding (split
      // mode's lo = bf16(x - hi) is mid)
      const __nv_bfloat16 hi = __float2bfloat16_rn(x);
      const float r1 = x - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const float r2 = r1 - __bfloat162float(mid);
      const uint32_t h[MAX_PASSES] = {__bfloat16_as_ushort(hi),
                                      __bfloat16_as_ushort(mid),
                                      __bfloat16_as_ushort(
                                          __float2bfloat16_rn(r2))};
#pragma unroll
      for (int pp = 0; pp < MAX_PASSES; ++pp)
        frag[pp][r >> 1] |= h[pp] << (16 * (r & 1));
    }
    for (int pp = 0; pp < passes; ++pp)
      parts[(((long long)c * ks_total + ks) * passes + pp) * nt * 32 +
            ntile * 32 + lane] = make_uint2(frag[pp][0], frag[pp][1]);
  }
  if (cv == nullptr) return;
  // the four rows-lanes of a column, then the 8 steps, in a fixed order
  vacc += __shfl_xor_sync(0xffffffffu, vacc, 1);
  vacc += __shfl_xor_sync(0xffffffffu, vacc, 2);
  if (t == 0) vs[warp][g] = vacc;
  __syncthreads();
  if (warp == 0 && t == 0 && col) {
    float acc = 0.f;
    for (int w = 0; w < 8; ++w) acc += vs[w][g];
    vpre[(long long)blockIdx.x * n + j] = acc;
  }
}

// ---------------------------------------------------------------------------
// Main kernel.
// ---------------------------------------------------------------------------
template <int NT, int P>
struct Tile {
  static constexpr int WPW = words_per_warp(NT);
  static constexpr int W_BLK = WARPS * WPW;          // words per block
  static constexpr int ZS = W_BLK + 4;               // padded smem row
  static constexpr int ZS_WORDS = K_TILE * ZS;       // per stage
  static constexpr int PS_U2 = KK * P * NT * 32;     // uint2 per stage
  static constexpr size_t RING =
      STAGES * (ZS_WORDS * sizeof(uint32_t) + PS_U2 * sizeof(uint2));
  // the epilogue stages one 8-column tile [8][16][W_BLK] f32 in the ring
  static constexpr size_t OUT = 8 * 16 * W_BLK * sizeof(float);
  static constexpr size_t SMEM = RING > OUT ? RING : OUT;
};

template <int NT, int P>
__global__ void __launch_bounds__(THREADS)
tall_mma(const uint32_t* __restrict__ zq, int kwi, long long contract,
         const uint2* __restrict__ parts, long long ks_total, int n, int cw,
         long long ks_per_split, int vec, float* __restrict__ part_out) {
  using T = Tile<NT, P>;
  constexpr int WPW = T::WPW, W_BLK = T::W_BLK, ZS = T::ZS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* zs = (uint32_t*)smem;                    // [STAGES][ZS_WORDS]
  uint2* ps = (uint2*)(smem + STAGES * T::ZS_WORDS * sizeof(uint32_t));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wb = blockIdx.x * W_BLK;
  const int chunk = blockIdx.z;
  const int c0 = chunk * cw, ncols = min(cw, n - c0);
  const long long ks_begin = (long long)blockIdx.y * ks_per_split;
  const long long ks_end = min(ks_total, ks_begin + ks_per_split);
  const int nst = ks_end > ks_begin ? (int)((ks_end - ks_begin) / KK) : 0;
  const uint4* pg =
      (const uint4*)(parts + (long long)chunk * ks_total * P * NT * 32);

  auto load = [&](int i, int buf) {
    const long long ks0 = ks_begin + (long long)i * KK;
    const long long row0 = ks0 * K_STEP;
    uint32_t* zd = zs + buf * T::ZS_WORDS;
    if (vec) {                      // 16-byte copies of 4 words
      for (int idx = tid; idx < K_TILE * (W_BLK / 4); idx += THREADS) {
        const int r = idx / (W_BLK / 4), cq = idx % (W_BLK / 4);
        const long long s = row0 + r;
        const int w = wb + cq * 4;
        const bool ok = s < contract && w < kwi;
        mx::cp_async16(zd + r * ZS + cq * 4, ok ? zq + s * kwi + w : zq,
                       ok ? 16 : 0);
      }
    } else {                        // rows not 16-byte aligned: one word
      for (int idx = tid; idx < K_TILE * W_BLK; idx += THREADS) {
        const int r = idx / W_BLK, c = idx % W_BLK;
        const long long s = row0 + r;
        const int w = wb + c;
        const bool ok = s < contract && w < kwi;
        mx::cp_async4(zd + r * ZS + c, ok ? zq + s * kwi + w : zq,
                      ok ? 4 : 0);
      }
    }
    uint4* pd = (uint4*)(ps + buf * T::PS_U2);
    const uint4* src = pg + ks0 * P * NT * 16;       // 16 uint4 per tile
    for (int idx = tid; idx < T::PS_U2 / 2; idx += THREADS)
      mx::cp_async16(pd + idx, src + idx, 16);
  };

  float acc[WPW][NT][4];
#pragma unroll
  for (int i = 0; i < WPW; ++i)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;

  const int sh = 2 * g;                              // planes g and g+8
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst) load(i, i);
    mx::cp_async_commit();
  }
  for (int i = 0; i < nst; ++i) {
    mx::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (i + STAGES - 1 < nst) load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    mx::cp_async_commit();
    const int buf = i % STAGES;
    const uint32_t* zb = zs + buf * T::ZS_WORDS + warp * WPW;
    const uint2* pb = ps + buf * T::PS_U2;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const uint32_t* zr = zb + kk * K_STEP * ZS;
      uint32_t a[WPW][4];
#pragma unroll
      for (int q = 0; q < WPW / 4; ++q) {
        const uint4 x0 = *(const uint4*)(zr + (2 * t) * ZS + 4 * q);
        const uint4 x1 = *(const uint4*)(zr + (2 * t + 1) * ZS + 4 * q);
        const uint4 x2 = *(const uint4*)(zr + (2 * t + 8) * ZS + 4 * q);
        const uint4 x3 = *(const uint4*)(zr + (2 * t + 9) * ZS + 4 * q);
        mx::a_fragment(x0.x, x1.x, x2.x, x3.x, sh, a[4 * q]);
        mx::a_fragment(x0.y, x1.y, x2.y, x3.y, sh, a[4 * q + 1]);
        mx::a_fragment(x0.z, x1.z, x2.z, x3.z, sh, a[4 * q + 2]);
        mx::a_fragment(x0.w, x1.w, x2.w, x3.w, sh, a[4 * q + 3]);
      }
      // each part's 16-row sum by an mma of its own from zero, then the
      // parts added smallest first and their sum added to the f32 total,
      // each rounded to nearest: an mma aligns its addends (C included) to
      // the largest and truncates below a fixed window, so a smaller
      // part's sum passed as C to a larger part's mma, or a sum run on in
      // a tensor-core accumulator, loses its low bits
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        float d[P][WPW][4] = {};
#pragma unroll
        for (int p = 0; p < P; ++p) {      // words innermost: independent
          const uint2 bb = pb[((kk * P + p) * NT + u) * 32 + lane];
#pragma unroll
          for (int w = 0; w < WPW; ++w) mx::mma_bf16(d[p][w], a[w], bb);
        }
#pragma unroll
        for (int w = 0; w < WPW; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float sum = d[P - 1][w][e];
#pragma unroll
            for (int p = P - 2; p >= 0; --p) sum += d[p][w][e];
            acc[w][u][e] += sum;
          }
      }
    }
  }
  mx::cp_async_wait<0>();

  // epilogue: one 8-column tile at a time through shared memory
  // [q][m][word], then rows of W_BLK consecutive words to global memory
  const long long out_rows = 16LL * kwi;
  float* dst = part_out + (long long)blockIdx.y * n * out_rows;
  float* os = (float*)smem;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    if (u * 8 >= ncols) break;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = 2 * t + (e & 1), m = g + 8 * (e >> 1);
        os[(q * 16 + m) * W_BLK + warp * WPW + i] = acc[i][u][e];
      }
    __syncthreads();
    for (int idx = tid; idx < 8 * 16 * W_BLK; idx += THREADS) {
      const int w = idx % W_BLK, qm = idx / W_BLK;
      const int q = u * 8 + qm / 16, m = qm % 16;
      if (q < ncols && wb + w < kwi)
        dst[(c0 + q) * out_rows + (long long)m * kwi + wb + w] = os[idx];
    }
  }
}

template <int NT, int P>
cudaError_t prepare(int* blocks_per_sm) {
  using T = Tile<NT, P>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tall_mma<NT, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)T::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  if (blocks_per_sm == nullptr) return cudaSuccess;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tall_mma<NT, P>, THREADS, T::SMEM);
}

struct Args {
  const uint32_t* zq;
  int kwi;
  long long contract;
  const uint2* parts;
  long long ks_total;
  int n;
  long long kps;
  int splits, vec;
  float* out;
  cudaStream_t st;
};

template <int NT, int P>
int launch_mma(const Args& a) {
  using T = Tile<NT, P>;
  const cudaError_t e = prepare<NT, P>(nullptr);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.kwi + T::W_BLK - 1) / T::W_BLK, a.splits,
            tall_chunks(a.n, P));
  tall_mma<NT, P><<<grid, THREADS, T::SMEM, a.st>>>(
      a.zq, a.kwi, a.contract, a.parts, a.ks_total, a.n, chunk_width(a.n, P),
      a.kps, a.vec, a.out);
  return 0;
}

// the instance for nt tiles and P passes: launch it, or with ``a`` null
// report its resident blocks per SM
template <int P>
int dispatch_nt(int nt, const Args* a, int* blocks_per_sm) {
  switch (nt) {
    case 1: return a ? launch_mma<1, P>(*a) : (int)prepare<1, P>(blocks_per_sm);
    case 2: return a ? launch_mma<2, P>(*a) : (int)prepare<2, P>(blocks_per_sm);
    case 3: return a ? launch_mma<3, P>(*a) : (int)prepare<3, P>(blocks_per_sm);
    case 4: return a ? launch_mma<4, P>(*a) : (int)prepare<4, P>(blocks_per_sm);
    default:                        // 8 tiles: one pass only (chunks of 64)
      if constexpr (P == 1)
        return a ? launch_mma<8, P>(*a) : (int)prepare<8, P>(blocks_per_sm);
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int passes, int nt, const Args* a, int* blocks_per_sm) {
  if (passes == 1) return dispatch_nt<1>(nt, a, blocks_per_sm);
  if (passes == 2) return dispatch_nt<2>(nt, a, blocks_per_sm);
  return dispatch_nt<3>(nt, a, blocks_per_sm);
}

}  // namespace

// Blocks of one contraction split for an n-column RHS over kwi words, and
// how many of them one SM holds at once (0 on error); the wrapper sizes
// its split count from the two.
extern "C" int mx_tall_tiles(int kwi, int n, int passes) {
  const int p = passes < 1 ? 1 : passes > MAX_PASSES ? MAX_PASSES : passes;
  const int wblk = WARPS * words_per_warp(n_tiles(n, p));
  return (kwi + wblk - 1) / wblk * tall_chunks(n, p);
}

extern "C" int mx_tall_blocks_per_sm(int n, int passes) {
  if (passes < 1 || passes > MAX_PASSES) return 0;
  int blocks = 0;
  return dispatch(passes, n_tiles(n, passes), nullptr, &blocks) == 0
             ? blocks : 0;
}

// Bytes of the bf16 parts buffer for ``passes`` parts of B [contract, n].
extern "C" long long mx_tall_parts_bytes(long long contract, int n,
                                         int passes) {
  return (long long)tall_chunks(n, passes) * k_steps(contract) * passes *
         n_tiles(n, passes) * 32 * 8;
}

// Rows of the cv^T B partials [rows, n].
extern "C" long long mx_tall_vrows(long long contract) {
  return (k_steps(contract) * K_STEP + V_ROWS - 1) / V_ROWS;
}

// ct: f32 [n, 16*kwi]; vout: f32 [n] (only with cv).  passes: 1 (bf16
// mode), 2 (split: hi + lo), 3 (f32: hi + mid + lo).  parts: the bf16
// parts buffer (mx_tall_parts_bytes); vwork: f32 [mx_tall_vrows, n] (only
// with cv).  With splits > 1, work: f32 [splits, n, 16*kwi] holds the split
// partials.  Returns the cudaError_t of the launches.
extern "C" int mx_tall_dgemm(const void* zq, int kwi, const void* b,
                             long long contract, int n, const void* cv,
                             void* ct, void* vout, void* work, void* vwork,
                             void* parts, int splits, int passes,
                             void* stream) {
  if (n < 1 || kwi < 1 || splits < 1 || contract < 0 || passes < 1 ||
      passes > MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long ks_total = k_steps(contract);
  const int nt = n_tiles(n, passes), chunks = tall_chunks(n, passes);
  long long kps = (ks_total + splits - 1) / splits;
  kps = (kps + KK - 1) / KK * KK;                 // whole staged tiles

  // row blocks on gridDim.x: no limit on the contraction's length short of
  // 2^31 - 1 blocks
  dim3 pgrid((unsigned)mx_tall_vrows(contract), chunks * nt);
  tall_parts<<<pgrid, 256, 0, st>>>(
      (const float*)b, contract, n, chunk_width(n, passes), nt, ks_total,
      passes, (const float*)cv, (uint2*)parts, (float*)vwork);

  const Args a{(const uint32_t*)zq, kwi, contract, (const uint2*)parts,
               ks_total, n, kps, splits,
               (kwi % 4 == 0) && ((uintptr_t)zq % 16 == 0),
               splits == 1 ? (float*)ct : (float*)work, st};
  const int err = dispatch(passes, nt, &a, nullptr);
  if (err != 0) return err;
  if (splits > 1) {
    const long long len = 16LL * kwi * n;
    const int threads = 256;
    const long long blocks = (len + threads - 1) / threads;
    mx::reduce_splits<<<(unsigned)blocks, threads, 0, st>>>(
        (float*)work, splits, len, (float*)ct, nullptr, 0, nullptr);
  }
  if (cv != nullptr)
    mx::reduce_splits<<<(n + 255) / 256, 256, 0, st>>>(
        nullptr, (int)mx_tall_vrows(contract), 0, nullptr,
        (const float*)vwork, n, (float*)vout);
  return (int)cudaGetLastError();
}
