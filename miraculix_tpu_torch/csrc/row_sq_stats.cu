// Per-row sum of z^2 over a planar16 packing, exactly: the diagonal of
// Z^T Z (zq_t rows: GWAS's d_s, LD pruning's SNP scales) or of Z Z^T (zq_n
// rows: grm_diag's Jacobi preconditioner).
//
// Replaces no Pallas kernel: the reference's packed_row_sq_stats
// (miraculix_tpu/ops/common.py) is plain jnp that XLA fuses into one pass.
// The port's plain twin (ops/common.py packed_row_sq_stats_plain) takes 16
// passes over the packing, each materialising a full-size plane.
//
// The plane loop sums z + 2 [z == 2] a 2-bit field: 0, 1, 4, 3 for the
// codes 00, 01, 10, 11 (code 3, which no genotype holds, reads as 3).  With
// lo = w & 0x55555555 and hi = (w >> 1) & 0x55555555 (an unsigned shift) a
// word sums to
//   popc(lo) + 4 popc(hi) - 2 popc(lo & hi) = popc(lo ^ hi) + 3 popc(hi),
// two popc a word, bit for bit the plane loop's sum for every code.  A word
// sums to at most 64, a row of fewer than 2^25 words to < 2^31, and the f32
// result is exact below 2^24 (64 x 62,592 words, the many_snps zq_n rows, is
// 4.0e6).  No atomics: one warp or one block sums a row, in a fixed order.
//
// Bound on H100: one read of the packing at HBM rate (3.35 TB/s): 5.63 GB
// for the many_snps zq_t (1,000,192 x 1,408 words), 1.68 ms.  Two popc, a
// shift, an xor, two ands and two adds a word stay under that read.  Design:
//   - 16-byte loads (uint4), neighbouring lanes on neighbouring addresses,
//     four in flight a thread; a row's words before its first 16-byte
//     boundary (rows of kw % 4 != 0, row views) and after its last whole
//     uint4 are read one word a lane, so every row takes the vector path;
//   - the threads a row follow its width: rows under WIDE_WORDS words (the
//     1,408-word zq_t rows) take one warp each, eight rows a block; wider
//     rows (the 62,592-word zq_n rows) take a block each.  Measured on the
//     H100 (each form at each width, random words): a warp a row is 13%
//     faster at 1,408 words x 1,000,192 rows, a block a row 2-4% faster at
//     3,200, 6,400 and 62,592 words x 21,248-101,120 rows, and 31% faster
//     at 62,592 words x 1,024 rows, where a warp a row leaves most of the
//     card idle; WIDE_WORDS splits the forms between 1,408 and 3,200;
//   - a warp sums with __reduce_add_sync, a block through shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIDE_WORDS = 2048;   // rows this wide take a block each
constexpr uint32_t LOW = 0x55555555u;

__device__ __forceinline__ int word_sq(uint32_t w) {
  const uint32_t hi = (w >> 1) & LOW;
  return __popc((w & LOW) ^ hi) + 3 * __popc(hi);
}

__device__ __forceinline__ int quad_sq(uint4 v) {
  return word_sq(v.x) + word_sq(v.y) + word_sq(v.z) + word_sq(v.w);
}

// Thread t of nt (nt >= 4) sums its share of one row of kw words.
__device__ __forceinline__ int row_part(const uint32_t* __restrict__ row,
                                        int kw, int t, int nt) {
  const int head =
      min(kw, (int)(((16 - ((uintptr_t)row & 15)) & 15) >> 2));
  int s = t < head ? word_sq(__ldg(row + t)) : 0;
  const uint4* __restrict__ body = reinterpret_cast<const uint4*>(row + head);
  const int quads = (kw - head) >> 2;
  int q = t;
  for (; q + 3 * nt < quads; q += 4 * nt) {
    const uint4 a = __ldg(body + q), b = __ldg(body + q + nt),
                c = __ldg(body + q + 2 * nt), d = __ldg(body + q + 3 * nt);
    s += quad_sq(a) + quad_sq(b) + quad_sq(c) + quad_sq(d);
  }
  for (; q < quads; q += nt) s += quad_sq(__ldg(body + q));
  const int tail = head + 4 * quads;
  if (t < kw - tail) s += word_sq(__ldg(row + tail + t));
  return s;
}

// One warp a row, WARPS rows a block.
__global__ void __launch_bounds__(THREADS)
row_sq_warp_kernel(const uint32_t* __restrict__ zq, int rows, int kw,
                   float* __restrict__ out) {
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int s = __reduce_add_sync(0xffffffffu,
                                  row_part(zq + (size_t)r * kw, kw, lane, 32));
  if (lane == 0) out[r] = (float)s;
}

// One block a row.
__global__ void __launch_bounds__(THREADS)
row_sq_block_kernel(const uint32_t* __restrict__ zq, int kw,
                    float* __restrict__ out) {
  __shared__ int part[WARPS];
  const int r = blockIdx.x;
  const int s = __reduce_add_sync(
      0xffffffffu,
      row_part(zq + (size_t)r * kw, kw, threadIdx.x, THREADS));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int p = __reduce_add_sync(
        0xffffffffu, threadIdx.x < WARPS ? part[threadIdx.x] : 0);
    if (threadIdx.x == 0) out[r] = (float)p;
  }
}

}  // namespace

// zq: int32 [rows, kw], 4-byte aligned; out: f32 [rows].  Returns the
// cudaError_t of the launch.
extern "C" int mx_row_sq_stats(const void* zq, int rows, int kw, void* out,
                               void* stream) {
  if (rows < 1 || kw < 1 || kw >= (1 << 25))
    return (int)cudaErrorInvalidValue;
  const uint32_t* w = (const uint32_t*)zq;
  if (kw < WIDE_WORDS)
    row_sq_warp_kernel<<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0,
                         (cudaStream_t)stream>>>(w, rows, kw, (float*)out);
  else
    row_sq_block_kernel<<<(unsigned)rows, THREADS, 0, (cudaStream_t)stream>>>(
        w, kw, (float*)out);
  return (int)cudaGetLastError();
}
