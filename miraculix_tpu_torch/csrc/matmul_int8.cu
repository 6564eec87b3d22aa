// Exact int8-digit product out = decode(zq) @ D (the f64 tier's digit pass).
//
// Replaces miraculix_tpu/ops/dgemm.py:_pmm_kernel_int8 (launched by
// packed_matmul_int8): out[r, j] = sum_c decode(zq)[r, c] * D[c, j] in int32,
// exactly.  Genotypes are 0..3 and the f64 tier's digits lie in [-64, 64], so
// each product is at most 192 in size and the caller guarantees
// 192 * 16 * kw < 2^31: the s32 sums of the int8 mma (which do not round;
// no .satfinite) are the reference's bit for bit.
//
// Operands:
//   - words: uint32 planar16 [rows, kw]; rows past `rows` and words past kw
//     read as 0;
//   - digit quads dq: int32 [n][kwq = ceil(kw / 4)][4][4], laid out by a
//     pre-pass (digit_quads_kernel) from the int8 digits D [cols <= 16*kw, n]
//     (plane-major rows m*kw + w, zero past cols and past kw): byte b of
//     dq[j][P][q][u] is D[(4b + q)*kw + 4P + u, j], signed.
//
// The k order is decode.cuh's int8_quads: a word is 16 int8 k-values, byte
// k = 4q + b holding plane 4b + q, so register q of word w is
// (w >> 2q) & 0x03030303.  One m16n8k32 step covers two words, w0 (k 0-15)
// and w1 (k 16-31), and the fragments of lane (g, t) (mma.cuh) are
//   a[0] = (Z[g][w0] >> 2t) & 0x03030303, a[1] the same for row g + 8,
//   a[2], a[3] the same at w1;   b[0] = dq[g][w0 / 4][t][w0 % 4],
//   b[1] = dq[g][w1 / 4][t][w1 % 4]:
// one shift and one mask per A register, straight from the raw word, and
// no decode of B, only its layout.  The four lanes of a quad read the same
// word (a broadcast), and the four words 4P..4P+3 of one (column, q) are one
// 16-byte chunk: one 128-bit load gives a lane its B registers for two mma
// steps (the layout interleaves words by fours for that; a [n][kw][4]
// layout would give each lane every fourth int32).
//
// Bound on H100: the int8 tensor cores at 96 digit columns (rows * 16*kw *
// 96 multiply-adds), the 2-bit words at 8 (each read once: 268 MB at the
// smoke's shapes).  Design:
//   - mma.sync m16n8k32 s8 x s8 -> s32.  Two instances of one template:
//     `Wide` (n <= 96) is 8 warps down the rows, a warp 32 rows x 96
//     columns (2 m16 x 12 n8 tiles: each A fragment, one shift and mask a
//     register, serves all twelve n8 tiles; 239 registers, one block an
//     SM), a block 256 rows x 96 columns; `Narrow` (n <= 8) is 8 warps of
//     16 rows x 8 columns, a block 128 rows x 8 columns, two blocks an SM.
//     Wider n takes more column groups (gridDim.y);
//   - a stage is DW words of the block's rows and the matching digit
//     chunks, brought by a cp.async ring of STAGES stages (zero-filled past
//     the panel through the copy's source size; 4-byte copies where rows are
//     not 16-byte aligned); one barrier a stage.  The wide instance takes
//     32-word stages, two of them (160 KB): half the barriers of 16-word
//     stages in a ring of four, ~5% faster at 96 columns;
//   - per 4-word step a wide warp reads 4 A chunks of 8 rows (a broadcast:
//     128 distinct bytes each) and 12 B loads of 512 bytes from shared
//     memory, and shift-masks 32 A registers, for 48 mmas: 139 distinct
//     bytes (171 by lanes) and 0.67 shift-masks a mma.  The shift-masks
//     cost more than the bytes: warps of 64 x 48 (85 bytes, 1.33
//     shift-masks a mma) read ~4% slower, and 16 warps of 32 x 48 (128
//     registers and spills) ~15% slower (tools/torch_matmul_int8_sweep.py);
//   - both stages are swizzled so that a quarter warp's 128-bit loads and
//     the cp.async stores are free of bank conflicts: A chunk p of row r at
//     p ^ ((r / (8 / CA)) % CA) within its row of CA = DW / 4 chunks (the 8
//     rows of one load land in 8 distinct 16-byte bank groups); B chunk j of
//     column c at j ^ 4 (c & 1) (the two columns of a quarter warp);
//   - the wide block's B stage (96 columns x 16 bytes a word) outweighs its
//     A stage (256 rows x 4 bytes a word); 256 rows a block halve the L2
//     reads of B against 128;
//   - the contraction splits over gridDim.z (whole stages a split) where
//     the row tiles alone would not fill the card (the launcher's split
//     rule); the output is zeroed first and the splits add their int32
//     partials with atomics (integer addition: the same bits in any order);
//   - the pre-pass gathers a (column, word quad)'s 64 bytes a thread,
//     columns fastest (coalesced byte reads of D's rows, whole 16-byte
//     stores), one launch with no zero-fill pass.
// On the H100 (tools/torch_matmul_int8_sweep.py at chip_smoke.py's shapes)
// the wide instance runs 96 columns at ~740 T op/s, 37% of the int8 peak;
// its mmas alone (copies, shared loads and shift-masks cut) read ~960, and
// with the mmas cut the rest alone takes as long as the whole kernel: the
// copies, shared loads and shift-masks bound it, not the mma pipe.  The
// narrow one streams the words at ~76% of the HBM rate.  wgmma (B from
// shared memory, A from these registers) and a TMA ring are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// A kernel instance: NT n8 tiles (BN = 8 NT digit columns) a block, WN
// warps across them and WM down the rows with MI m16 tiles each (BM = 16 MI
// WM rows a block), stages of DW words in a ring of STAGES.
template <int NT_, int WN_, int WM_, int MI_, int DW_, int STAGES_>
struct Cfg {
  static constexpr int NT = NT_, WN = WN_, WM = WM_, MI = MI_, DW = DW_;
  static constexpr int STAGES = STAGES_;
  static constexpr int NI = NT / WN;            // n8 tiles a warp
  static constexpr int THREADS = 32 * WN * WM;
  static constexpr int BM = 16 * MI * WM;       // rows a block
  static constexpr int BN = 8 * NT;             // digit columns a block
  static constexpr int CA = DW / 4;             // 16-byte chunks of a row
  static constexpr int A_WORDS = BM * DW;       // one A stage, uint32
  static constexpr int B_WORDS = BN * DW * 4;   // one B stage, int32
  static constexpr size_t SMEM = (size_t)STAGES * (A_WORDS + B_WORDS) * 4;
  static_assert(NT % WN == 0, "whole n8 tiles a warp");
  static_assert(CA == 2 || CA == 4 || CA == 8, "A rows of 2, 4 or 8 chunks");
  static_assert(DW % 8 == 0, "the B swizzle stays inside a column");
  static_assert(BM * CA % THREADS == 0 && BN * DW % THREADS == 0 &&
                A_WORDS % THREADS == 0, "whole copies a thread");
};

//                NT WN WM MI  DW STAGES
using Narrow = Cfg<1, 1, 8, 1, 32, 4>;   // 128 x 8, 256 threads, 80 KB
using Wide = Cfg<12, 1, 8, 2, 32, 2>;    // 256 x 96, 256 threads, 160 KB

// chunk index of words 4p..4p+3 of row r in an A stage
template <class C>
__device__ __forceinline__ int a_chunk(int r, int p) {
  return r * C::CA + (p ^ ((r / (8 / C::CA)) & (C::CA - 1)));
}

// chunk index of chunk j (= 4 P + q: register q of words 4P..4P+3) of
// column c in a B stage
template <class C>
__device__ __forceinline__ int b_chunk(int c, int j) {
  return c * C::DW + (j ^ ((c & 1) << 2));
}

__device__ __forceinline__ uint32_t el(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Stage: words [k0, k0 + DW) (k0 % 4 == 0) of rows [row0, row0 + BM) -> a,
// zero past `rows` and past w_end; the digit chunks of columns
// [col0, col0 + BN) for the same words -> b, zero past n and past kwq.
template <class C>
__device__ __forceinline__ void load_stage(
    const uint32_t* __restrict__ zq, int rows, int kw, int w_end,
    const int4* __restrict__ dq, int n, int kwq, int row0, int col0, int k0,
    bool vec, uint32_t* a, int* b) {
  if (vec) {   // kw % 4 == 0: a chunk is all in or all out
#pragma unroll
    for (int i = 0; i < C::BM * C::CA / C::THREADS; ++i) {
      const int idx = threadIdx.x + i * C::THREADS;
      const int r = idx / C::CA, p = idx % C::CA;
      const bool ok = row0 + r < rows && k0 + 4 * p < w_end;
      mx::cp_async16(a + 4 * a_chunk<C>(r, p),
                     ok ? zq + (long long)(row0 + r) * kw + k0 + 4 * p : zq,
                     ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < C::A_WORDS / C::THREADS; ++i) {
      const int idx = threadIdx.x + i * C::THREADS;
      const int r = idx / C::DW, w = idx % C::DW;
      const bool ok = row0 + r < rows && k0 + w < w_end;
      mx::cp_async4(a + 4 * a_chunk<C>(r, w >> 2) + (w & 3),
                    ok ? zq + (long long)(row0 + r) * kw + k0 + w : zq,
                    ok ? 4 : 0);
    }
  }
#pragma unroll
  for (int i = 0; i < C::BN * C::DW / C::THREADS; ++i) {
    const int idx = threadIdx.x + i * C::THREADS;
    const int c = idx / C::DW, j = idx % C::DW;
    const int P = (k0 >> 2) + (j >> 2);
    const bool ok = col0 + c < n && P < kwq;
    mx::cp_async16(b + 4 * b_chunk<C>(c, j),
                   ok ? dq + ((long long)(col0 + c) * kwq + P) * 4 + (j & 3)
                      : dq,
                   ok ? 16 : 0);
  }
}

// acc[mi][ni] += this warp's rows arow + 16 mi.. x columns bcol + 8 ni.. of
// one stage
template <class C>
__device__ __forceinline__ void mma_stage(const uint32_t* a, const int* b,
                                          int arow, int bcol, int g, int t,
                                          int (&acc)[C::MI][C::NI][4]) {
  const int sh = 2 * t;
#pragma unroll
  for (int p = 0; p < C::CA; ++p) {   // words 4p..4p+3: two mma steps
    uint4 lo[C::MI], hi[C::MI], bq[C::NI];
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const int r = arow + 16 * mi + g;
      lo[mi] = *reinterpret_cast<const uint4*>(a + 4 * a_chunk<C>(r, p));
      hi[mi] = *reinterpret_cast<const uint4*>(a + 4 * a_chunk<C>(r + 8, p));
    }
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
      bq[ni] = *reinterpret_cast<const uint4*>(
          b + 4 * b_chunk<C>(bcol + 8 * ni + g, 4 * p + t));
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // words w0 = 4p + 2h, w1 = w0 + 1
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        const uint32_t af[4] = {(el(lo[mi], 2 * h) >> sh) & 0x03030303u,
                                (el(hi[mi], 2 * h) >> sh) & 0x03030303u,
                                (el(lo[mi], 2 * h + 1) >> sh) & 0x03030303u,
                                (el(hi[mi], 2 * h + 1) >> sh) & 0x03030303u};
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) {
          const uint32_t bf[2] = {el(bq[ni], 2 * h), el(bq[ni], 2 * h + 1)};
          mx::mma_s8(acc[mi][ni], af, bf);
        }
      }
    }
  }
}

// block (row tile x, column group y, split z): words [z per, (z+1) per)
template <class C>
__global__ void __launch_bounds__(C::THREADS)
matmul_int8_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                   const int4* __restrict__ dq, int n, int per, int vec,
                   int* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* a_ring = smem;                                  // [STAGES][A]
  int* b_ring = reinterpret_cast<int*>(smem + C::STAGES * C::A_WORDS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int arow = (warp / C::WN) * 16 * C::MI;
  const int bcol = (warp % C::WN) * 8 * C::NI;
  const int row0 = blockIdx.x * C::BM, col0 = blockIdx.y * C::BN;
  const int w_begin = blockIdx.z * per;
  const int w_end = min(kw, w_begin + per);
  const int kwq = (kw + 3) >> 2;
  const int nst = (w_end - w_begin + C::DW - 1) / C::DW;
  auto load = [&](int s) {
    load_stage<C>(zq, rows, kw, w_end, dq, n, kwq, row0, col0,
                  w_begin + s * C::DW, vec, a_ring + (s % C::STAGES) *
                  C::A_WORDS, b_ring + (s % C::STAGES) * C::B_WORDS);
  };

  int acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // group s of the ring holds stage s
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nst) load(s);
    mx::cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    // stage s has landed for every thread; every warp is done with stage
    // s - 1, whose slot the next copy refills with stage s + STAGES - 1
    mx::cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (s + C::STAGES - 1 < nst) load(s + C::STAGES - 1);
    mx::cp_async_commit();
    mma_stage<C>(a_ring + (s % C::STAGES) * C::A_WORDS,
                 b_ring + (s % C::STAGES) * C::B_WORDS, arow, bcol, g, t,
                 acc);
  }
  mx::cp_async_wait<0>();

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + arow + 16 * mi + g + 8 * (e >> 1);
        const int c = col0 + bcol + 8 * ni + 2 * t + (e & 1);
        if (r < rows && c < n) {
          int* o = out + (long long)r * n + c;
          if (split) atomicAdd(o, acc[mi][ni][e]);
          else *o = acc[mi][ni][e];
        }
      }
}

// The 16 int32 dq[j][P][0..3][0..3] (64 contiguous bytes) of one column j
// and word quad P, a thread each, columns fastest: a warp's byte reads of
// D's rows are coalesced and each thread writes four whole 16-byte chunks.
// Byte b of dq[j][P][q][u] is D[(4b + q) kw + 4P + u, j] (zero past cols
// and past kw).
__global__ void digit_quads_kernel(const int8_t* __restrict__ d, int cols,
                                   int n, int kw, int kwq,
                                   int4* __restrict__ dq) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)kwq * n) return;
  const int j = (int)(i % n), P = (int)(i / n);
  uint32_t v[16];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int w = 4 * P + u;
      uint32_t x = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const long long row = (long long)(4 * b + q) * kw + w;
        if (w < kw && row < cols)
          x |= (uint32_t)(uint8_t)__ldg(d + row * n + j) << (8 * b);
      }
      v[4 * q + u] = x;
    }
  int4* o = dq + ((long long)j * kwq + P) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    o[q] = make_int4((int)v[4 * q], (int)v[4 * q + 1], (int)v[4 * q + 2],
                     (int)v[4 * q + 3]);
}

template <class C>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_int8_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  done = e == cudaSuccess;
  return e;
}

template <class C>
int info(int* v) {
  cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, matmul_int8_kernel<C>);
  if (e != cudaSuccess) return (int)e;
  v[0] = attr.numRegs;
  v[1] = (int)attr.localSizeBytes;
  v[2] = (int)C::SMEM;
  v[4] = C::BM;
  v[5] = C::BN;
  v[6] = C::DW;
  v[7] = C::THREADS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &v[3], matmul_int8_kernel<C>, C::THREADS, C::SMEM);
}

template <class C>
int launch(const void* zq, int rows, int kw, const void* dq, int n, int per,
           void* out, cudaStream_t s) {
  if (per < 1 || per % C::DW) return (int)cudaErrorInvalidValue;
  const long long row_tiles = (rows + C::BM - 1) / C::BM;
  const dim3 grid((unsigned)row_tiles, (n + C::BN - 1) / C::BN,
                  (kw + per - 1) / per);
  if (row_tiles > 0x7fffffffLL || grid.y > 65535 || grid.z > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<C>();
  if (e != cudaSuccess) return (int)e;
  if (grid.z > 1) {
    e = cudaMemsetAsync(out, 0, (size_t)rows * n * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = kw % 4 == 0 && (uintptr_t)zq % 16 == 0;
  matmul_int8_kernel<C><<<grid, C::THREADS, C::SMEM, s>>>(
      (const uint32_t*)zq, rows, kw, (const int4*)dq, n, per, vec,
      (int*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Of the narrow (wide = 0) or the wide (1) instance: registers and local
// (spill) bytes a thread, dynamic shared memory a block, resident blocks per
// SM, then rows a block, digit columns a block, words a stage and threads a
// block -> info[0..7].  Returns the cudaError_t.
extern "C" int mx_matmul_int8_info(int wide, int* info_out) {
  return wide ? info<Wide>(info_out) : info<Narrow>(info_out);
}

// The digit quads dq [n][ceil(kw / 4)][4][4] of the int8 digits d
// [cols <= 16 kw, n].  Returns the cudaError_t of the launch.
extern "C" int mx_matmul_int8_layout(const void* d, int cols, int n, int kw,
                                     void* dq, void* stream) {
  if (cols < 0 || n < 1 || kw < 1 || cols > 16LL * kw)
    return (int)cudaErrorInvalidValue;
  const int kwq = (kw + 3) / 4;
  const long long blocks = ((long long)kwq * n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  digit_quads_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)d, cols, n, kw, kwq, (int4*)dq);
  return (int)cudaGetLastError();
}

// out: int32 [rows, n] (zeroed here when the contraction splits); dq the
// digit quads [n][ceil(kw / 4)][4][4]; `per` words a split, a multiple of
// the instance's stage.  Returns the cudaError_t of the launch.
extern "C" int mx_matmul_int8(const void* zq, int rows, int kw, const void* dq,
                              int n, int wide, int per, void* out,
                              void* stream) {
  if (rows < 1 || kw < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return wide ? launch<Wide>(zq, rows, kw, dq, n, per, out, s)
              : launch<Narrow>(zq, rows, kw, dq, n, per, out, s);
}
