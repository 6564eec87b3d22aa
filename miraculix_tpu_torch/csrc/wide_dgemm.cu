// Wide packed product on the bf16 tensor cores:
//
//     C[rows, n] = decode(zq[rows, kw]) @ B'[16*kw, n]
//
// Replaces, in miraculix_tpu/ops/dgemm.py (all launched by packed_matmul):
//   _pmm_kernel_split_wide_pp (B3) and _pmm_kernel_split_wide (B11), the
//     split tier for n > 64, and _pmm_kernel_split (B4), the split tier for
//     n <= 64: two passes, B' = hi + lo;
//   _pmm_kernel_bf16 (B5): one pass, B' = hi;
//   _pmm_kernel_f32 (B5): three passes, B' = hi + mid + lo = B;
// with hi = bf16(B), then each part the bf16 rounding (to nearest even) of
// what the parts before it leave, as in tall_dgemm.cu.  The per-plane order
// of B3 and the 4^-m RHS scaling of _reorder_rhs are TPU scheduling
// devices; this kernel computes the function: decoded column m*kw + w is
// word w, plane m, and B rows at or past `cols` count as zero.  Genotype
// codes are exact in bf16, so each part is one bf16 tensor-core pass.
//
// Bound on H100: operations.  At the GWAS shape (zq 16,384 x 4,096 words
// against B [65,536, 65]) the work is 1.4e11 multiply-adds: 0.28 ms for
// the split tier's two bf16 passes at 989 TFLOP/s, 0.14 / 0.42 ms for one /
// three, against 0.09 ms for the 0.29 GB the call must move.  Design:
//   - a pre-pass (wide_parts) splits B once into its 1-3 bf16 parts, laid
//     out in mma B-fragment order [chunk][word][part][8-column tile][lane]
//     (one uint2 a lane and part; zero past cols, n and kw, up to whole
//     stages), reading rows of the chunk's columns;
//   - one mma.sync m16n8k16 K-step is the 16 planes of one packed word, its
//     M rows 16 output rows.  The k order is chosen for the decode: lane
//     (g, t) holds k 2t, 2t+1, 2t+8, 2t+9 = planes 2t, 2t+8, 2t+1, 2t+9 of
//     the words of rows g and g+8, so each A register is the plane pair
//     (p, p+8) of one word, (w >> 4t [>> 2]) & 0x00030003 | 0x43004300 less
//     128 in one bf16x2 subtraction (decode.cuh's plane_pair_bf16), and the
//     pre-pass puts B's rows in the same order.  One A fragment serves the
//     chunk's NT column tiles and every part;
//   - a block is 8 warps of 16*MI rows (BM rows) and one column chunk of
//     8*NT columns; a cp.async ring of STAGES stages of KS words brings the
//     rows' words and the chunk's B fragments to shared memory, the next
//     stages' copies in flight while one stage's mmas run;
//   - each part sums in an mma accumulator of its own, from zero, for
//     PROMOTE words; then the parts' sums are added smallest first and the
//     result to an f32 register total, by round-to-nearest adds.  The
//     tensor cores' f32 sums truncate addends below the accumulator's
//     window (tall_dgemm.cu): a sum run on over a whole contraction drifts
//     where B is positive;
//   - the contraction splits over gridDim.y (the wrapper picks the words a
//     split so that the last wave of blocks is nearly full) into a
//     workspace that reduce_splits sums in split order: no atomics, results
//     repeat bit for bit.
// On an H100 SXM (700 W) this runs at 24-38% of the bound; its mmas alone,
// with the copies, loads and decode cut, reach ~470 TFLOP/s (48% of the
// bf16 peak), the mma.sync pipe's own rate.  The Hopper route past it
// (wgmma with A from the decoded registers and B from shared memory) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "mma.cuh"

namespace {

constexpr int WARPS = 8;          // warps of a main-kernel block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_PASSES = 3;
constexpr int PRE_WORDS = 4;      // words of one pre-pass block
constexpr int MAX_NT = 8;         // widest chunk: 64 columns

// The geometry of the instances of one part count: MI m16 tiles a warp (BM
// = 128 MI rows a block), chunks of at most NT_MAX n8 tiles, stages of KS
// words in a ring of STAGES, each part's mma sum promoted every PROMOTE
// words.
template <int MI_, int NT_MAX_, int KS_, int STAGES_, int PROMOTE_>
struct Shape {
  static constexpr int MI = MI_, NT_MAX = NT_MAX_, KS = KS_;
  static constexpr int STAGES = STAGES_, PROMOTE = PROMOTE_;
  static_assert(NT_MAX >= 1 && NT_MAX <= MAX_NT, "chunks of 8 to 64 columns");
  static_assert(KS % 4 == 0 && KS % PROMOTE == 0, "whole groups a stage");
  static_assert(STAGES >= 2, "a ring");
};

//                MI NT_MAX KS STAGES PROMOTE
using One = Shape<2, 8, 32, 2, 32>;     // bf16: hi
using Two = Shape<2, 4, 32, 2, 32>;     // split: hi + lo
using Three = Shape<2, 3, 32, 2, 32>;   // f32: hi + mid + lo

template <int P> struct ShapeOf { using S = One; };
template <> struct ShapeOf<2> { using S = Two; };
template <> struct ShapeOf<3> { using S = Three; };

template <int P, int NT>
struct Cfg {
  using S = typename ShapeOf<P>::S;
  static constexpr int MI = S::MI, KS = S::KS, STAGES = S::STAGES;
  static constexpr int PROMOTE = S::PROMOTE;
  static constexpr int BM = 16 * MI * WARPS;           // rows a block
  static constexpr int ZS = KS + 4;                    // padded A row
  static constexpr int Z_WORDS = BM * ZS;              // one A stage
  static constexpr int B_U2 = KS * P * NT * 32;        // one B stage
  static constexpr size_t SMEM =
      (size_t)STAGES * (Z_WORDS * sizeof(uint32_t) + B_U2 * sizeof(uint2));
};

__host__ __device__ constexpr int nt_max(int passes) {
  return passes == 1 ? One::NT_MAX : passes == 2 ? Two::NT_MAX
                                                 : Three::NT_MAX;
}
__host__ __device__ constexpr int stage_words(int passes) {
  return passes == 1 ? One::KS : passes == 2 ? Two::KS : Three::KS;
}
// chunks of an n-column RHS and their n8 tiles: the fewest chunks of at
// most nt_max tiles, of equal tiles (chunk c: columns [8 nt c, 8 nt (c+1)))
inline void tiles(int n, int passes, int* chunks, int* nt) {
  const int t8 = (n + 7) / 8;
  *chunks = (t8 + nt_max(passes) - 1) / nt_max(passes);
  *nt = (t8 + *chunks - 1) / *chunks;
}
// words of the parts buffer: kw padded to whole stages
inline long long padded_words(int kw, int passes) {
  const int ks = stage_words(passes);
  return ((long long)kw + ks - 1) / ks * ks;
}

// ---------------------------------------------------------------------------
// Pre-pass: B -> bf16 parts in B-fragment order.  Grid (kwp / PRE_WORDS,
// chunks), 256 threads: block (x, c) stages B's rows m*kw + w (w in its
// PRE_WORDS words, m = 0..15) at the chunk's columns in shared memory, a
// warp reading consecutive columns, then writes every (word, part, tile,
// lane) uint2: lane (g, t) of tile u holds column 8u + g at planes 2t, 2t+8
// (.x, low half first) and 2t+1, 2t+9 (.y), the A fragment's k order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
wide_parts(const float* __restrict__ b, long long cols, int n, int kw,
           long long kwp, int nt, int passes, uint2* __restrict__ parts) {
  __shared__ float vs[PRE_WORDS][16][8 * MAX_NT + 1];
  const int cw = 8 * nt, c0 = blockIdx.y * cw;
  const long long w0 = (long long)blockIdx.x * PRE_WORDS;
  for (int idx = threadIdx.x; idx < PRE_WORDS * 16 * cw; idx += 256) {
    const int q = idx % cw, m = (idx / cw) % 16, i = idx / (16 * cw);
    const long long w = w0 + i, row = (long long)m * kw + w;
    const int j = c0 + q;
    vs[i][m][q] = (w < kw && j < n && row < cols) ? __ldg(b + row * n + j)
                                                  : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < PRE_WORDS * nt * 32; idx += 256) {
    const int lane = idx & 31, u = (idx >> 5) % nt, i = (idx >> 5) / nt;
    const int g = lane >> 2, t = lane & 3;
    const int plane[4] = {2 * t, 2 * t + 8, 2 * t + 1, 2 * t + 9};
    uint32_t frag[MAX_PASSES][2] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // x = hi + mid + r2 exactly; each part is one bf16 rounding
      const float x = vs[i][plane[r]][8 * u + g];
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
      parts[(((long long)blockIdx.y * kwp + w0 + i) * passes + pp) * nt * 32 +
            u * 32 + lane] = make_uint2(frag[pp][0], frag[pp][1]);
  }
}

// ---------------------------------------------------------------------------
// Main kernel.
// ---------------------------------------------------------------------------
// Stage: words [w0, w0 + KS) of rows [row0, row0 + BM) -> zs (row-major,
// rows of ZS words; zero past `rows` and past kw), and the chunk's B
// fragments of the same words (pg: those of word w0) -> ps.
template <int P, int NT>
__device__ __forceinline__ void load_stage(const uint32_t* __restrict__ zq,
                                           int rows, int kw, int row0,
                                           int w0, bool vec,
                                           const uint4* __restrict__ pg,
                                           uint32_t* zs, uint4* ps) {
  using C = Cfg<P, NT>;
  mx::copy_rows<C::BM, C::KS, C::ZS, THREADS>(zq, rows, kw, row0, w0, vec,
                                              zs);
#pragma unroll
  for (int idx = threadIdx.x; idx < C::B_U2 / 2; idx += THREADS)
    mx::cp_async16(ps + idx, pg + idx, 16);
}

// block (row tile x, split y, chunk z): rows [BM x, BM (x+1)), words
// [per y, per (y+1)), columns [8 NT z, 8 NT (z+1)); out: f32 [splits][rows,
// n] (the split's partial at out + y rows n)
template <int P, int NT>
__global__ void __launch_bounds__(THREADS, 1)
wide_mma(const uint32_t* __restrict__ zq, int rows, int kw,
         const uint2* __restrict__ parts, long long kwp, int n, int per,
         int vec, float* __restrict__ out) {
  using C = Cfg<P, NT>;
  constexpr int MI = C::MI, KS = C::KS, PROMOTE = C::PROMOTE;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* z_ring = reinterpret_cast<uint32_t*>(smem);
  uint2* b_ring = reinterpret_cast<uint2*>(
      smem + C::STAGES * C::Z_WORDS * sizeof(uint32_t));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * C::BM, arow = warp * 16 * MI;
  const int chunk = blockIdx.z, c0 = chunk * 8 * NT;
  const int w_begin = blockIdx.y * per;
  const int w_end = min(kw, w_begin + per);
  const int nst = w_end > w_begin ? (w_end - w_begin + KS - 1) / KS : 0;
  const uint4* pg = reinterpret_cast<const uint4*>(
      parts + (long long)chunk * kwp * P * NT * 32);
  auto load = [&](int s) {
    const int w0 = w_begin + s * KS;
    load_stage<P, NT>(zq, rows, kw, row0, w0, vec,
                      pg + (long long)w0 * P * NT * 16,
                      z_ring + (s % C::STAGES) * C::Z_WORDS,
                      reinterpret_cast<uint4*>(b_ring + (s % C::STAGES) *
                                               C::B_U2));
  };

  float acc[MI][NT][4];
  float d[P][MI][NT][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][u][e] = 0.f;

  const int sh = 4 * t;              // planes 2t, 2t+8 (and 2t+1, 2t+9)
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nst) load(s);
    mx::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    // stage s has landed for every thread; every warp is done with stage
    // s - 1, whose slot the next copy refills
    mx::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (s + C::STAGES - 1 < nst) load(s + C::STAGES - 1);
    mx::cp_async_commit();
    const uint32_t* zs =
        z_ring + (s % C::STAGES) * C::Z_WORDS + (arow + g) * C::ZS;
    const uint2* ps = b_ring + (s % C::STAGES) * C::B_U2 + lane;
#pragma unroll
    for (int q = 0; q < KS / 2; ++q) {   // words 2q, 2q+1 of the stage
      uint2 lo[MI], hi[MI];              // of rows g and g + 8 of each tile
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        lo[mi] = *reinterpret_cast<const uint2*>(zs + 16 * mi * C::ZS +
                                                 2 * q);
        hi[mi] = *reinterpret_cast<const uint2*>(zs + (16 * mi + 8) * C::ZS +
                                                 2 * q);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = 2 * q + h;
        uint32_t a[MI][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const uint32_t x0 = (h ? lo[mi].y : lo[mi].x) >> sh;
          const uint32_t x1 = (h ? hi[mi].y : hi[mi].x) >> sh;
          a[mi][0] = mx::plane_pair_bf16(x0, 0);
          a[mi][1] = mx::plane_pair_bf16(x1, 0);
          a[mi][2] = mx::plane_pair_bf16(x0, 2);
          a[mi][3] = mx::plane_pair_bf16(x1, 2);
        }
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const uint2 bb = ps[((kk * P + p) * NT + u) * 32];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              if (kk % PROMOTE == 0)
                mx::mma_bf16_zero(d[p][mi][u], a[mi], bb);
              else
                mx::mma_bf16(d[p][mi][u], a[mi], bb);
            }
          }
        if (kk % PROMOTE == PROMOTE - 1) mx::promote<P, MI, NT>(acc, d);
      }
    }
  }
  mx::cp_async_wait<0>();

  float* dst = out + (long long)blockIdx.y * rows * n;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int u = 0; u < NT; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + arow + 16 * mi + g + 8 * (e >> 1);
        const int c = c0 + 8 * u + 2 * t + (e & 1);
        if (r < rows && c < n) dst[(long long)r * n + c] = acc[mi][u][e];
      }
}

template <int P, int NT>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      wide_mma<P, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cfg<P, NT>::SMEM);
  done = e == cudaSuccess;
  return e;
}

// registers, local (spill) bytes, dynamic shared memory, resident blocks
// per SM, rows a block, columns a chunk, words a stage, threads, words a
// promotion, stages -> v[0..9]
template <int P, int NT>
int info(int* v) {
  using C = Cfg<P, NT>;
  cudaError_t e = allow_smem<P, NT>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, wide_mma<P, NT>);
  if (e != cudaSuccess) return (int)e;
  v[0] = attr.numRegs;
  v[1] = (int)attr.localSizeBytes;
  v[2] = (int)C::SMEM;
  v[4] = C::BM;
  v[5] = 8 * NT;
  v[6] = C::KS;
  v[7] = THREADS;
  v[8] = C::PROMOTE;
  v[9] = C::STAGES;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &v[3], wide_mma<P, NT>, THREADS, C::SMEM);
}

struct Args {
  const uint32_t* zq;
  int rows, kw;
  const uint2* parts;
  long long kwp;
  int n, per, chunks, vec;
  float* out;
  cudaStream_t st;
};

template <int P, int NT>
int launch(const Args& a) {
  using C = Cfg<P, NT>;
  const long long row_tiles = (a.rows + C::BM - 1) / C::BM;
  const dim3 grid((unsigned)row_tiles, (a.kw + a.per - 1) / a.per, a.chunks);
  if (a.per < 1 || a.per % C::KS || grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<P, NT>();
  if (e != cudaSuccess) return (int)e;
  wide_mma<P, NT><<<grid, THREADS, C::SMEM, a.st>>>(
      a.zq, a.rows, a.kw, a.parts, a.kwp, a.n, a.per, a.vec, a.out);
  return 0;
}

// the instance of P parts and nt tiles: launch it, or with ``a`` null
// report its attributes
template <int P, int NT = 1>
int dispatch(int nt, const Args* a, int* v) {
  if constexpr (NT > ShapeOf<P>::S::NT_MAX) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (nt == NT) return a ? launch<P, NT>(*a) : info<P, NT>(v);
    return dispatch<P, NT + 1>(nt, a, v);
  }
}

int dispatch_passes(int passes, int nt, const Args* a, int* v) {
  if (passes == 1) return dispatch<1>(nt, a, v);
  if (passes == 2) return dispatch<2>(nt, a, v);
  if (passes == 3) return dispatch<3>(nt, a, v);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Column chunks and n8 tiles a chunk of an n-column RHS in ``passes``
// parts -> out[0..1]; and the widest chunk's tiles (out[2]).
extern "C" int mx_wide_tiles(int n, int passes, int* out) {
  if (n < 1 || passes < 1 || passes > MAX_PASSES)
    return (int)cudaErrorInvalidValue;
  tiles(n, passes, &out[0], &out[1]);
  out[2] = nt_max(passes);
  return 0;
}

// Of the instance of ``passes`` parts and ``nt`` tiles a chunk: registers,
// local (spill) bytes, dynamic shared memory, resident blocks per SM, rows a
// block, columns a chunk, words a stage, threads, words a promotion and
// stages -> info[0..9].  Returns the cudaError_t.
extern "C" int mx_wide_info(int passes, int nt, int* info_out) {
  return dispatch_passes(passes, nt, nullptr, info_out);
}

// Bytes of the bf16 parts buffer for ``passes`` parts of an n-column RHS
// over kw words.
extern "C" long long mx_wide_parts_bytes(int kw, int n, int passes) {
  if (n < 1 || kw < 1 || passes < 1 || passes > MAX_PASSES) return 0;
  int chunks, nt;
  tiles(n, passes, &chunks, &nt);
  return (long long)chunks * padded_words(kw, passes) * passes * nt * 32 *
         sizeof(uint2);
}

// zq: int32 words [rows, kw]; b: f32 [cols, n] with cols <= 16*kw; out: f32
// [rows, n].  passes: 1 (bf16: hi), 2 (split: hi + lo), 3 (f32: hi + mid +
// lo).  parts: the bf16 parts buffer (mx_wide_parts_bytes).  per: words a
// contraction split, a multiple of the instance's stage; with more than one
// split, work: f32 [splits, rows, n] holds the split partials.  Returns the
// cudaError_t of the launches.
extern "C" int mx_wide_dgemm(const void* zq, int rows, int kw, const void* b,
                             long long cols, int n, int passes, void* parts,
                             int per, void* out, void* work, void* stream) {
  if (rows < 1 || kw < 1 || n < 1 || cols < 0 || cols > 16LL * kw ||
      passes < 1 || passes > MAX_PASSES || per < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int chunks, nt;
  tiles(n, passes, &chunks, &nt);
  const long long kwp = padded_words(kw, passes);
  const int splits = (kw + per - 1) / per;
  if (splits > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  wide_parts<<<dim3((unsigned)(kwp / PRE_WORDS), chunks), 256, 0, st>>>(
      (const float*)b, cols, n, kw, kwp, nt, passes, (uint2*)parts);
  const Args a{(const uint32_t*)zq, rows, kw, (const uint2*)parts, kwp, n,
               per, chunks,
               (kw % 4 == 0) && ((uintptr_t)zq % 16 == 0),
               splits == 1 ? (float*)out : (float*)work, st};
  const int err = dispatch_passes(passes, nt, &a, nullptr);
  if (err != 0) return err;
  if (splits > 1) {
    const long long len = (long long)rows * n;
    const int threads = 256;
    mx::reduce_splits<<<(unsigned)((len + threads - 1) / threads), threads,
                        0, st>>>((const float*)work, splits, len, (float*)out,
                                 nullptr, 0, nullptr);
  }
  return (int)cudaGetLastError();
}
