// Weighted crossproduct W = decode(zq) diag(w) decode(zq)^T at f32 grade, on
// the bf16 tensor cores.
//
// Replaces miraculix_tpu/ops/grm.py:_crossprod_weighted_kernel (with
// _plane_prod_weighted and the wrapped-pair triangle grid of _wrap_pair):
// the GCTA GRM's numerator (grm_yang) and the per-pair denominators.
//
// zq: int32 planar16 words [rows, kw]; w: f32 [16, kw], plane-major (decoded
// column m*kw + k is SNP m*kw + k and has weight w[m][k]); out: f32
// [rows, rows], every entry written.  Words past kw read as 0.  Genotype
// codes are 0, 1 or 2.
//
// Grade, as the reference splits it: w is cut into three bf16 digits by bit
// masking, h1 = bits(w) & 0xFFFF0000, h2 = bits(w - h1) & 0xFFFF0000, h3 =
// w - h1 - h2, which sum to w exactly (8 + 8 + 8 significant bits).  z is
// 0, 1 or 2, so z * h_d is exact in bf16 (a doubling moves the exponent)
// and equals the reference's digit of z * w; every product z_i * (z_j *
// h_d) is exact in the tensor core, and only the sums round.  The tensor
// cores' f32 sums truncate addends below the accumulator's window
// (tall_dgemm.cu), so each digit sums in an mma accumulator of its own,
// from zero, for one stage of KS words; then the digits' stage sums are
// added smallest first and the result to an f32 register total, by
// round-to-nearest adds.  No accumulator runs across digits or stages.
// The totals are f32, so their rounding grows with the number of stages
// (kw / KS).  At 65,536 SNPs (kw = 4,096: 128 stages) and positive GCTA
// weights the error is 9.1e-7 of each output on an H100, within the 4e-6
// that chip_smoke.py allows; longer panels are not measured, and f64
// totals are the remedy where one needs them.
//
// Bound on H100: operations.  At 16,384 rows x 65,536 SNPs the upper
// triangle is 8.8e12 multiply-adds a digit: 53.4 ms for three bf16 passes
// at 989 TFLOP/s, against 1.3 ms for the 1.3 GB the call must move.
// Design:
//   - a pre-pass (weighted_digits) writes w's three digits once, in the
//     mma k order below, as bf16 pairs [word][t][digit] (one uint2 a lane
//     and digit; zero past kw, up to whole stages);
//   - one mma.sync m16n8k16 K-step is the 16 planes of one packed word.
//     Both operands are rows of one panel with one word -> SNP map, so any
//     plane order that both sides share gives the contraction: lane (g, t)
//     holds k 2t, 2t+1 = planes t, t+8 and k 2t+8, 2t+9 = planes t+4,
//     t+12, and each A and B register is one plane_pair_bf16 (decode.cuh)
//     of a raw word shifted by 2t, at bit 0 or 8: no decoded tile goes
//     through shared memory;
//   - the weights go on B: a B register of digit d is the decoded pair
//     times the digit pair, one __hmul2 (exact, see above).  A warp tile of
//     32 x 32 has as many B registers as A registers;
//   - a block is EDGE x EDGE warps of 32 x 32 outputs (a TILE x TILE output
//     tile); a cp.async ring of STAGES stages of KS words brings the raw
//     words of the tile's row and column blocks and the stage's digits, the
//     next stages' copies in flight while one stage's mmas run;
//   - per K-step a lane decodes its 4 A and 4 B words once and runs 3 x 2 x
//     4 mmas, the digit innermost: the three digits' stage sums (96 f32
//     registers) and the total (32) stay live, none spilled;
//   - the blocks walk the upper tile pairs (mx::upper_pair) and write the
//     mirror, or every tile when `full` is set.  Tile (j, i) sums the same
//     exact products in the same k order as tile (i, j), so the full grid
//     is symmetric bit for bit.  No atomics: results repeat bit for bit.
// On an H100 SXM (700 W) this runs at 37% of the bound (144 ms); its mmas
// alone, with the copies, loads and decode cut, take 111 ms (~483 TFLOP/s,
// the mma.sync pipe's rate), and the lanes' decode and digit products are
// the most of what it does not hide.  One bf16 library call of the three
// passes on the full square (wgmma) is faster; wgmma with the weighted
// rows from registers and one decoded tile for all three digits in shared
// memory is the Hopper route past it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "mma.cuh"

namespace {

constexpr int DIGITS = 3;

// The kernel's geometry: EDGE x EDGE warps of 32 x 32 outputs, stages of KS
// words in a ring of STAGES, at least MIN_BLOCKS blocks an SM (the
// register cap of __launch_bounds__).
template <int EDGE_, int KS_, int STAGES_, int MIN_BLOCKS_>
struct Shape {
  static constexpr int EDGE = EDGE_, KS = KS_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int TILE = 32 * EDGE;               // output tile edge
  static constexpr int THREADS = 32 * EDGE * EDGE;
  static constexpr int ZS = KS + 4;                    // padded word row
  static constexpr int Z_WORDS = TILE * ZS;            // one side's stage
  static constexpr int D_U2 = KS * 4 * DIGITS;         // one digit stage
  static constexpr size_t STAGE_BYTES =
      2 * Z_WORDS * sizeof(uint32_t) + D_U2 * sizeof(uint2);
  static constexpr size_t SMEM = STAGES * STAGE_BYTES;
  static_assert(KS % 4 == 0 && STAGES >= 2, "whole 16-byte rows, a ring");
};

//              EDGE KS STAGES MIN_BLOCKS
using Cfg = Shape<2, 32, 4, 2>;

constexpr int MI = 2, NT = 4;     // m16 and n8 tiles of a warp's 32 x 32

// ---------------------------------------------------------------------------
// Pre-pass: w [16][kw] -> digit pairs dg[word][t][digit] (uint2: .x = the
// digit of planes t (low half) and t+8, .y of planes t+4 and t+12), for
// words < kwp; words past kw are 0.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float mask_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
}

// digit d of x as bf16 bits: the reference's masked split
__device__ __forceinline__ void split3(float x, uint32_t* h) {
  const float h1 = mask_hi(x);
  const float r1 = x - h1;                 // exact
  const float h2 = mask_hi(r1);
  const float h3 = r1 - h2;                // exact, <= 8 significant bits
  h[0] = __float_as_uint(h1) >> 16;
  h[1] = __float_as_uint(h2) >> 16;
  h[2] = __bfloat16_as_ushort(__float2bfloat16_rn(h3));   // exact
}

__global__ void __launch_bounds__(256)
weighted_digits(const float* __restrict__ w, int kw, long long kwp,
                uint2* __restrict__ dg) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;   // word * 4 + t
  if (i >= kwp * 4) return;
  const long long s = i >> 2;
  const int t = (int)(i & 3);
  const int plane[4] = {t, t + 8, t + 4, t + 12};
  uint32_t h[4][DIGITS];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    split3(s < kw ? __ldg(w + (long long)plane[r] * kw + s) : 0.f, h[r]);
#pragma unroll
  for (int d = 0; d < DIGITS; ++d)
    dg[i * DIGITS + d] = make_uint2(h[0][d] | h[1][d] << 16,
                                    h[2][d] | h[3][d] << 16);
}

// ---------------------------------------------------------------------------
// Main kernel.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// block: tile pair (bi, bj) -- the upper pair of blockIdx.x, or (blockIdx.y,
// blockIdx.x) when `full` -- rows [TILE bi, ...) x columns [TILE bj, ...)
template <class S>
__global__ void __launch_bounds__(S::THREADS, S::MIN_BLOCKS)
weighted_mma(const uint32_t* __restrict__ zq, int rows, int kw,
             const uint2* __restrict__ dg, int full, int vec,
             float* __restrict__ out) {
  constexpr int KS = S::KS, ZS = S::ZS;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const ring = smem;
  int bi, bj;
  if (full) {
    bi = blockIdx.y;
    bj = blockIdx.x;
  } else {
    mx::upper_pair(blockIdx.x, bi, bj);
  }
  const bool mirror = !full && bi != bj;
  const int row0 = bi * S::TILE, col0 = bj * S::TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % S::EDGE) * 32, wc = (warp / S::EDGE) * 32;
  const int nst = (kw + KS - 1) / KS;
  auto stage = [&](int s) { return ring + (s % S::STAGES) * S::STAGE_BYTES; };
  auto load = [&](int s) {
    const int w0 = s * KS;
    uint32_t* za = reinterpret_cast<uint32_t*>(stage(s));
    mx::copy_rows<S::TILE, KS, ZS, S::THREADS>(zq, rows, kw, row0, w0, vec,
                                               za);
    mx::copy_rows<S::TILE, KS, ZS, S::THREADS>(zq, rows, kw, col0, w0, vec,
                                               za + S::Z_WORDS);
    const uint4* src = reinterpret_cast<const uint4*>(dg + (long long)w0 * 4 *
                                                      DIGITS);
    uint4* dst = reinterpret_cast<uint4*>(za + 2 * S::Z_WORDS);
    for (int idx = threadIdx.x; idx < S::D_U2 / 2; idx += S::THREADS)
      mx::cp_async16(dst + idx, src + idx, 16);
  };

  float acc[MI][NT][4];
  float d[DIGITS][MI][NT][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][u][e] = 0.f;

  const int sh = 2 * t;             // planes t, t+8 (bit 0) and t+4, t+12 (8)
#pragma unroll
  for (int s = 0; s < S::STAGES - 1; ++s) {
    if (s < nst) load(s);
    mx::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    // stage s has landed for every thread; every warp is done with stage
    // s - 1, whose slot the next copy refills
    mx::cp_async_wait<S::STAGES - 2>();
    __syncthreads();
    if (s + S::STAGES - 1 < nst) load(s + S::STAGES - 1);
    mx::cp_async_commit();
    const uint32_t* za =
        reinterpret_cast<const uint32_t*>(stage(s)) + (wr + g) * ZS;
    const uint32_t* zb =
        reinterpret_cast<const uint32_t*>(stage(s)) + S::Z_WORDS +
        (wc + g) * ZS;
    const uint2* ds = reinterpret_cast<const uint2*>(
        reinterpret_cast<const uint32_t*>(stage(s)) + 2 * S::Z_WORDS) +
        t * DIGITS;
#pragma unroll
    for (int q = 0; q < KS / 2; ++q) {   // words 2q, 2q+1 of the stage
      uint2 wa[2 * MI], wb[NT];          // rows g + 8i; columns g + 8u
#pragma unroll
      for (int i = 0; i < 2 * MI; ++i)
        wa[i] = *reinterpret_cast<const uint2*>(za + 8 * i * ZS + 2 * q);
#pragma unroll
      for (int u = 0; u < NT; ++u)
        wb[u] = *reinterpret_cast<const uint2*>(zb + 8 * u * ZS + 2 * q);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * q + h;
        uint2 wd[DIGITS];
#pragma unroll
        for (int dd = 0; dd < DIGITS; ++dd) wd[dd] = ds[kk * 4 * DIGITS + dd];
        uint32_t a[MI][4], b[NT][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const uint32_t x0 = (h ? wa[2 * mi].y : wa[2 * mi].x) >> sh;
          const uint32_t x1 = (h ? wa[2 * mi + 1].y : wa[2 * mi + 1].x) >> sh;
          a[mi][0] = mx::plane_pair_bf16(x0, 0);
          a[mi][1] = mx::plane_pair_bf16(x1, 0);
          a[mi][2] = mx::plane_pair_bf16(x0, 8);
          a[mi][3] = mx::plane_pair_bf16(x1, 8);
        }
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const uint32_t y = (h ? wb[u].y : wb[u].x) >> sh;
          b[u][0] = mx::plane_pair_bf16(y, 0);
          b[u][1] = mx::plane_pair_bf16(y, 8);
        }
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int dd = 0; dd < DIGITS; ++dd) {
            const uint2 bw = make_uint2(hmul2(b[u][0], wd[dd].x),
                                        hmul2(b[u][1], wd[dd].y));
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              if (kk == 0) mx::mma_bf16_zero(d[dd][mi][u], a[mi], bw);
              else mx::mma_bf16(d[dd][mi][u], a[mi], bw);
            }
          }
      }
    }
    mx::promote<DIGITS, MI, NT>(acc, d);   // once a stage
  }
  mx::cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wr + 16 * mi + g + 8 * (e >> 1);
        const int c = col0 + wc + 8 * u + 2 * t + (e & 1);
        if (r < rows && c < rows) {
          out[(long long)r * rows + c] = acc[mi][u][e];
          if (mirror) out[(long long)c * rows + r] = acc[mi][u][e];
        }
      }
}

cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      weighted_mma<Cfg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg::SMEM);
  done = e == cudaSuccess;
  return e;
}

long long padded_words(int kw) {
  return ((long long)kw + Cfg::KS - 1) / Cfg::KS * Cfg::KS;
}

}  // namespace

// Registers, local (spill) bytes, dynamic shared memory, resident blocks per
// SM, output tile edge, threads, words a stage and stages of the kernel ->
// v[0..7].  Returns the cudaError_t.
extern "C" int mx_weighted_info(int* v) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, weighted_mma<Cfg>);
  if (e != cudaSuccess) return (int)e;
  v[0] = attr.numRegs;
  v[1] = (int)attr.localSizeBytes;
  v[2] = (int)Cfg::SMEM;
  v[4] = Cfg::TILE;
  v[5] = Cfg::THREADS;
  v[6] = Cfg::KS;
  v[7] = Cfg::STAGES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &v[3], weighted_mma<Cfg>, Cfg::THREADS, Cfg::SMEM);
}

// Bytes of the digit buffer for kw words.
extern "C" long long mx_weighted_digits_bytes(int kw) {
  if (kw < 1) return 0;
  return padded_words(kw) * 4 * DIGITS * (long long)sizeof(uint2);
}

// out: f32 [rows, rows]; full != 0 walks every tile, otherwise the upper
// tile pairs with their mirror.  dg: the digit buffer
// (mx_weighted_digits_bytes).  Returns the cudaError_t of the launches.
extern "C" int mx_crossprod_weighted(const void* zq, int rows, int kw,
                                     const void* w, int full, void* dg,
                                     void* out, void* stream) {
  if (rows < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long nt = (rows + Cfg::TILE - 1) / Cfg::TILE;
  dim3 grid;
  if (full) {
    if (nt > 65535) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)nt, (unsigned)nt);
  } else {
    const long long pairs = nt * (nt + 1) / 2;
    if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    grid = dim3((unsigned)pairs);
  }
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const long long kwp = padded_words(kw);
  weighted_digits<<<(unsigned)((kwp * 4 + 255) / 256), 256, 0, st>>>(
      (const float*)w, kw, kwp, (uint2*)dg);
  const int vec = (kw % 4 == 0) && ((uintptr_t)zq % 16 == 0);
  weighted_mma<Cfg><<<grid, Cfg::THREADS, Cfg::SMEM, st>>>(
      (const uint32_t*)zq, rows, kw, (const uint2*)dg, full, vec,
      (float*)out);
  return (int)cudaGetLastError();
}
