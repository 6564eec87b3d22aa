// Exact integer crossproducts decode(za) decode(zb)^T (the GRM and LD core).
//
// One 128 x 128 int8 tensor-core tile product, launched three ways:
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
// guarantees 4 * 16 * kw < 2^31, so the s32 sums of the int8 mma equal the
// reference's bit for bit (integer mma sums do not round; no .satfinite).
// Rows past ra/rb and words past kw read as 0.
//
// Bound on H100: the int8 tensor cores (1,979 TOP/s) -- 16*kw products per
// output pair; the packed operand is a quarter byte per genotype.  Design:
//   - mma.sync m16n8k32 s8 x s8 -> s32.  decode.cuh's int8_quads turns a
//     word into 16 int8 values, one 16-byte chunk of a row's K; both
//     operands share that k order, so fragments need no shuffle or .trans;
//   - a block is 8 warps (2 x 4) of 64 x 32 outputs and one 128 x 128 tile.
//     A stage is DW = 8 words (K = 128) of the block's 2 x 128 rows: raw
//     words arrive through a cp.async ring of STAGES stages (zero-filled
//     past the panel through the copy's source size), are decoded once per
//     block into an int8 K-major tile in shared memory (128-byte rows, the
//     16-byte chunk c of row r stored at c ^ (r & 7), so that ldmatrix and
//     the decode's 16-byte stores are free of bank conflicts), and ldmatrix
//     .x4 loads the A and B fragments.  The decode of stage s + 1 and the
//     mmas of stage s run between the same two barriers (one per stage),
//     on two decoded buffers;
//   - 96 KB of shared memory and at most 128 registers a thread keep two
//     blocks on an SM;
//   - blocks walk the tiles in bands of GROUP tile rows (K3: the upper
//     pairs of a band, then its columns right of the band's triangle,
//     GROUP rows per column; the rectangular grid: GROUP rows per column),
//     so the blocks in flight share their row and column panels in L2;
//   - a tile whose two row ranges are the same rows of one operand loads
//     and decodes its words once and uses them on both sides;
//   - the epilogue stages the tile in shared memory and writes rows of 128
//     consecutive outputs; K3's off-diagonal tiles write the transposed
//     stage as their mirror, coalesced too.
// On the H100 it is bound by the mma.sync pipe: K3 at 16,384 rows x 65,536
// SNPs reads ~765 T op/s, and with the loads and the decode cut (its mmas
// alone) ~793, about 40% of the int8 peak (tools/torch_crossprod_sweep.py).
// The walk order, a fifth stage and decoding each lane's fragments in
// registers instead of the shared tile moved nothing or lost.  The route to
// the full int8 rate is wgmma, which reads B from a K-major swizzled tile
// like this one, with a TMA ring and warp specialisation: later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "mma.cuh"

namespace {

constexpr int TILE = 128;                 // output tile edge
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int WM = 64, WN = 32;           // warp tile: 2 x 4 warps
constexpr int DW = 8;                     // words per stage
constexpr int ROW_BYTES = DW * 16;        // decoded int8 row of a stage
constexpr int STAGES = 4;                 // cp.async ring depth
constexpr int GROUP = 8;                  // tile rows per band of the walk
constexpr int RAW_WORDS = TILE * DW;      // one operand's stage
constexpr int DEC_BYTES = TILE * ROW_BYTES;
constexpr size_t RAW_SMEM = (size_t)STAGES * 2 * RAW_WORDS * 4;
constexpr size_t SMEM = RAW_SMEM + 2 * 2 * DEC_BYTES;   // 96 KB
constexpr int OUT_LD = TILE + 1;          // epilogue stage row, in int32
static_assert((size_t)TILE * OUT_LD * 4 <= SMEM, "epilogue stage fits");
static_assert(WARPS * WM * WN == TILE * TILE, "warps cover the tile");

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// byte offset of the 16-byte chunk c of row r in a decoded tile
__device__ __forceinline__ int swizzle(int r, int c) {
  return r * ROW_BYTES + ((c ^ (r & 7)) << 4);
}

// raw words [k0, k0 + DW) of rows [row0, row0 + TILE) -> dst [TILE][DW];
// rows past `rows` and words past kw are zero-filled
__device__ __forceinline__ void load_stage(const uint32_t* __restrict__ z,
                                           int rows, int kw, int row0, int k0,
                                           uint32_t* dst, bool vec) {
  if (vec) {                      // kw % 4 == 0: a chunk is all in or out
    const int r = threadIdx.x >> 1, c = 4 * (threadIdx.x & 1);
    const bool ok = row0 + r < rows && k0 + c < kw;
    mx::cp_async16(dst + r * DW + c,
               ok ? z + (long long)(row0 + r) * kw + k0 + c : z, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int i = 0; i < RAW_WORDS / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / DW, c = idx % DW;
      const bool ok = row0 + r < rows && k0 + c < kw;
      mx::cp_async4(dst + idx,
                ok ? z + (long long)(row0 + r) * kw + k0 + c : z, ok ? 4 : 0);
    }
  }
}

// raw [TILE][DW] words -> the swizzled int8 tile: thread = (row, 4 words)
__device__ __forceinline__ void decode_stage(const uint32_t* raw,
                                             uint8_t* dec) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const uint4 x = *reinterpret_cast<const uint4*>(raw + r * DW + 4 * h);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<uint4*>(dec + swizzle(r, 4 * h + i)) =
        mx::int8_quads(w[i]);
}

// acc[mi][ni][e] += the stage's K of A rows x B rows for this warp's m16
// tile mi and n8 tile ni (C fragment element e: row g + 8 (e >> 1), column
// 2t + (e & 1))
__device__ __forceinline__ void mma_stage(const uint8_t* a_dec,
                                          const uint8_t* b_dec,
                                          int (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int am = (warp >> 2) * WM, bn = (warp & 3) * WN;
#pragma unroll
  for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
    uint32_t a[4][4], b[4][2];
    // A: matrices rows 0-7 / 8-15 of k 0-15, then of k 16-31
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
      ldmatrix_x4(a[mi], a_dec + swizzle(am + mi * 16 + (lane & 15),
                                         2 * kk + (lane >> 4)));
#pragma unroll
    for (int nj = 0; nj < 2; ++nj) {  // B: rows 0-7 of k 0-15 / 16-31, 8-15
      uint32_t r[4];
      ldmatrix_x4(r, b_dec + swizzle(bn + nj * 16 + (lane & 7) +
                                         ((lane >> 4) << 3),
                                     2 * kk + ((lane >> 3) & 1)));
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mx::mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

// acc = rows row0.. of decode(za) . rows col0.. of decode(zb), this warp's
// 64 x 32 part of the tile.  `same`: both ranges are the same rows of one
// operand, loaded and decoded once.  Ends with a barrier: smem is free.
__device__ __forceinline__ void tile_product(
    const uint32_t* __restrict__ za, int ra, const uint32_t* __restrict__ zb,
    int rb, int kw, int row0, int col0, bool same, bool vec, uint8_t* smem,
    int (&acc)[4][4][4]) {
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem);   // [STAGES][2][..]
  uint8_t* dec = smem + RAW_SMEM;                      // [2][2][DEC_BYTES]
  const int nst = (kw + DW - 1) / DW;
  auto load = [&](int s) {
    uint32_t* d = raw + (s % STAGES) * 2 * RAW_WORDS;
    load_stage(za, ra, kw, row0, s * DW, d, vec);
    if (!same) load_stage(zb, rb, kw, col0, s * DW, d + RAW_WORDS, vec);
  };
  auto decode = [&](int s) {
    const uint32_t* r = raw + (s % STAGES) * 2 * RAW_WORDS;
    uint8_t* d = dec + (s & 1) * 2 * DEC_BYTES;
    decode_stage(r, d);
    if (!same) decode_stage(r + RAW_WORDS, d + DEC_BYTES);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // group s of the ring holds stage s
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < nst) load(s);
    mx::cp_async_commit();
  }
  mx::cp_async_wait<STAGES - 1>();
  __syncthreads();
  decode(0);
  for (int s = 0; s < nst; ++s) {
    // stage s + 1 has landed; stage s's decode is visible; every warp is
    // done with stage s - 1's mmas (their buffer is decode(s + 1)'s) and
    // with stage s's raw words (their slot is load(s + STAGES)'s)
    mx::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES < nst) load(s + STAGES);
    mx::cp_async_commit();
    if (s + 1 < nst) decode(s + 1);
    const uint8_t* d = dec + (s & 1) * 2 * DEC_BYTES;
    mma_stage(d, same ? d : d + DEC_BYTES, acc);
  }
  mx::cp_async_wait<0>();
  __syncthreads();
}

// The tile through shared memory to out[row0.., col0..] (leading dimension
// ld, rows < rmax, columns < cmax) in rows of consecutive outputs, and with
// `mirror` its transpose to out[col0.., row0..] likewise.
__device__ __forceinline__ void store_tile(const int (&acc)[4][4][4],
                                           uint8_t* smem,
                                           int* __restrict__ out,
                                           long long ld, int row0, int col0,
                                           int rmax, int cmax, bool mirror) {
  int* st = reinterpret_cast<int*>(smem);              // [TILE][OUT_LD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int am = (warp >> 2) * WM, bn = (warp & 3) * WN;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[(am + mi * 16 + g + 8 * (e >> 1)) * OUT_LD + bn + ni * 8 + 2 * t +
           (e & 1)] = acc[mi][ni][e];
  __syncthreads();
  for (int r = warp; r < TILE && row0 + r < rmax; r += WARPS)
#pragma unroll
    for (int i = 0; i < TILE / 32; ++i) {
      const int c = lane + 32 * i;
      if (col0 + c < cmax)
        out[(long long)(row0 + r) * ld + col0 + c] = st[r * OUT_LD + c];
    }
  if (!mirror) return;
  for (int c = warp; c < TILE && col0 + c < cmax; c += WARPS)
#pragma unroll
    for (int i = 0; i < TILE / 32; ++i) {
      const int r = lane + 32 * i;
      if (row0 + r < rmax)
        out[(long long)(col0 + c) * ld + row0 + r] = st[r * OUT_LD + c];
    }
}

// K3's walk: block p -> the upper tile pair (bi <= bj) of nt tiles, in
// bands of GROUP tile rows: a band's triangle first (mx::upper_pair), then
// its columns to the right, the band's rows innermost
__device__ __forceinline__ void band_pair(long long p, int nt, int& bi,
                                          int& bj) {
  for (int b0 = 0;; b0 += GROUP) {
    const int h = min(GROUP, nt - b0);
    const long long tri = (long long)h * (h + 1) / 2;
    const long long cnt = tri + (long long)h * (nt - b0 - h);
    if (p < cnt) {
      if (p < tri) {
        mx::upper_pair(p, bi, bj);
        bi += b0;
        bj += b0;
      } else {
        const long long q = p - tri;
        bi = b0 + (int)(q % h);
        bj = b0 + h + (int)(q / h);
      }
      return;
    }
    p -= cnt;
  }
}

// the rectangular grid's walk: block p -> tile (bi, bj) of ta x tb, GROUP
// tile rows per column
__device__ __forceinline__ void group_pair(long long p, int ta, int tb,
                                           int& bi, int& bj) {
  const long long per = (long long)GROUP * tb;
  const int b0 = (int)(p / per) * GROUP;
  const int h = min(GROUP, ta - b0);
  const long long l = p % per;
  bi = b0 + (int)(l % h);
  bj = (int)(l / h);
}

__global__ void __launch_bounds__(THREADS, 2)
crossprod_kernel(const uint32_t* __restrict__ zq, int rows, int kw, int vec,
                 int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int bi, bj;
  band_pair(blockIdx.x, (rows + TILE - 1) / TILE, bi, bj);
  int acc[4][4][4];
  tile_product(zq, rows, zq, rows, kw, bi * TILE, bj * TILE, bi == bj, vec,
               smem, acc);
  store_tile(acc, smem, out, rows, bi * TILE, bj * TILE, rows, rows,
             bi != bj);
}

// `upper` requires za == zb, ra == rb
__global__ void __launch_bounds__(THREADS, 2)
crossprod_rect_kernel(const uint32_t* __restrict__ za, int ra,
                      const uint32_t* __restrict__ zb, int rb, int kw,
                      int upper, int vec, int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int bi, bj;
  group_pair(blockIdx.x, (ra + TILE - 1) / TILE, (rb + TILE - 1) / TILE, bi,
             bj);
  if (upper && bj < bi) return;  // wholly below the diagonal: the mirror's
  int acc[4][4][4];
  // one decode serves both sides only where both ranges are the same rows
  // of one operand: two views of one buffer may end at different rows
  tile_product(za, ra, zb, rb, kw, bi * TILE, bj * TILE,
               za == zb && ra == rb && bi == bj, vec, smem, acc);
  store_tile(acc, smem, out, rb, bi * TILE, bj * TILE, ra, rb, false);
}

cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      crossprod_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(crossprod_rect_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM);
  done = e == cudaSuccess;
  return e;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// The output tile edge: the unit of K3's pairs and of B12's mask.
extern "C" int mx_crossprod_tile() { return TILE; }

// Of crossprod_kernel (which 0) or crossprod_rect_kernel (1): registers a
// thread, local (spill) bytes a thread, dynamic shared memory a block and
// resident blocks per SM -> info[0..3].  Returns the cudaError_t.
extern "C" int mx_crossprod_info(int which, int* info) {
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  const void* fn = which == 0 ? (const void*)crossprod_kernel
                              : (const void*)crossprod_rect_kernel;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[3], fn,
                                                            THREADS, SMEM);
}

// out: int32 [rows, rows].  Returns the cudaError_t of the launch.
extern "C" int mx_crossprod(const void* zq, int rows, int kw, void* out,
                            void* stream) {
  if (rows < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (rows + TILE - 1) / TILE;
  const long long pairs = nt * (nt + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  crossprod_kernel<<<(unsigned)pairs, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)zq, rows, kw, kw % 4 == 0 && aligned16(zq), (int*)out);
  return (int)cudaGetLastError();
}

// out: int32 [ra, rb].  upper != 0: za == zb, ra == rb, and the tiles wholly
// below the diagonal are left unwritten.  Returns the cudaError_t.
extern "C" int mx_crossprod_rect(const void* za, int ra, const void* zb,
                                 int rb, int kw, int upper, void* out,
                                 void* stream) {
  if (ra < 1 || rb < 1 || kw < 1) return (int)cudaErrorInvalidValue;
  if (upper && (za != zb || ra != rb)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)((ra + TILE - 1) / TILE) * ((rb + TILE - 1) / TILE);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  crossprod_rect_kernel<<<(unsigned)blocks, THREADS, SMEM,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)za, ra, (const uint32_t*)zb, rb, kw, upper,
      kw % 4 == 0 && aligned16(za) && aligned16(zb), (int*)out);
  return (int)cudaGetLastError();
}
