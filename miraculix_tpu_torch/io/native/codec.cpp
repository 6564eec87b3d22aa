// Native host codec of miraculix_tpu_torch: PLINK decode/encode, planar16
// packing, allele frequencies, the missing scan, fused .bed ingestion,
// per-individual .bed statistics, inbreeding coefficients and the greedy
// LD-prune scans.
//
// The port's own copy of miraculix_tpu/io/native/codec.cpp: the same entry
// points and arguments, bit for bit the same outputs, plus
// mx_payload_to_dense (the SNP-major decode).  Its counterparts in the
// original miraculix are the PLINK bit-stream converters
// (src/miraculix/5codesChar.cc:213-340), the packed transpose
// (src/bindings/Julia/compressed_operations.jl:45-66) and the missing scan
// (src/miraculix/plinkUint.cc:155), rebuilt for the planar16 layout with
// OpenMP.  For a 1M-SNP x 100K-individual panel the host pack touches
// ~100 GB of genotype bytes; this path keeps ingestion from dominating
// end-to-end time.
//
// C ABI only (loaded through ctypes by io/native/__init__.py).  All
// matrices are C-order (row-major).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <queue>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// PLINK 2-bit code -> genotype value; missing (01) -> 3.
static inline uint8_t plink_decode_code(unsigned code) {
    // 00 -> 0, 01 -> missing(3), 10 -> 1, 11 -> 2
    static const uint8_t tbl[4] = {0, 3, 1, 2};
    return tbl[code & 3u];
}

// geno value -> PLINK 2-bit code (3 = missing -> 01).
static inline unsigned plink_encode_val(uint8_t v) {
    static const uint8_t tbl[4] = {0u, 2u, 3u, 1u};
    return tbl[v & 3u];
}

// Decode packed PLINK bytes [nbytes, nmajor] -> dense genotypes
// [n_within, nmajor] (values 0/1/2, 3 = missing).
void mx_plink_to_dense(const uint8_t* plink, int64_t nbytes, int64_t nmajor,
                       int64_t n_within, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nbytes; ++b) {
        const uint8_t* src = plink + b * nmajor;
        for (int i = 0; i < 4; ++i) {
            int64_t row = 4 * b + i;
            if (row >= n_within) break;
            uint8_t* dst = out + row * nmajor;
            for (int64_t j = 0; j < nmajor; ++j) {
                dst[j] = plink_decode_code((unsigned)(src[j] >> (2 * i)));
            }
        }
    }
}

// Decode the raw SNP-major .bed payload [nmajor, nbytes] -> dense genotypes
// [nmajor, n_within] (values 0/1/2, 3 = missing): each byte's 4 codes are 4
// adjacent genotypes of one row, so no transpose is involved.
void mx_payload_to_dense(const uint8_t* payload, int64_t nmajor,
                         int64_t nbytes, int64_t n_within, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < nmajor; ++s) {
        const uint8_t* src = payload + s * nbytes;
        uint8_t* dst = out + s * n_within;
        for (int64_t i = 0; i < n_within; ++i)
            dst[i] = plink_decode_code((unsigned)(src[i >> 2] >> (2 * (i & 3))));
    }
}

// Encode dense genotypes [n_within, nmajor] -> PLINK bytes
// [ceil(n_within/4), nmajor].
void mx_dense_to_plink(const uint8_t* geno, int64_t n_within, int64_t nmajor,
                       uint8_t* out) {
    int64_t nbytes = (n_within + 3) / 4;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nbytes; ++b) {
        uint8_t* dst = out + b * nmajor;
        std::memset(dst, 0, (size_t)nmajor);
        for (int i = 0; i < 4; ++i) {
            int64_t row = 4 * b + i;
            if (row >= n_within) break;
            const uint8_t* src = geno + row * nmajor;
            for (int64_t j = 0; j < nmajor; ++j) {
                dst[j] = (uint8_t)(dst[j] | (plink_encode_val(src[j]) << (2 * i)));
            }
        }
    }
}

// planar16 pack: genotypes [rows, cols] (row stride rstride, col stride
// cstride, in ELEMENTS — so a transposed view packs without a host copy)
// -> uint32 words [rp, kw].  Missing (3) packs as 0.
void mx_pack_planar16(const uint8_t* geno, int64_t rows, int64_t cols,
                      int64_t rstride, int64_t cstride,
                      int64_t rp, int64_t kw, uint32_t* out) {
    // Strided (e.g. transposed-view) sources cost an L2 hit per element in
    // the pack loop; a cache-blocked gather into a contiguous staging
    // buffer first is ~3.5x faster overall.  Skipped beyond 2 GB to avoid
    // doubling peak host memory at out-of-core scale.
    uint8_t* staged = nullptr;
    if (cstride != 1 && rows * cols <= (int64_t)1 << 31) {
        staged = new (std::nothrow) uint8_t[(size_t)(rows * cols)];
        if (staged) {
            const int64_t B = 64;
#pragma omp parallel for collapse(2) schedule(static)
            for (int64_t r0 = 0; r0 < rows; r0 += B) {
                for (int64_t c0 = 0; c0 < cols; c0 += B) {
                    int64_t r1 = r0 + B < rows ? r0 + B : rows;
                    int64_t c1 = c0 + B < cols ? c0 + B : cols;
                    for (int64_t r = r0; r < r1; ++r)
                        for (int64_t c = c0; c < c1; ++c)
                            staged[r * cols + c] =
                                geno[r * rstride + c * cstride];
                }
            }
        }
    }
    const uint8_t* src0 = staged ? staged : geno;
    const int64_t rs = staged ? cols : rstride;
    const int64_t cs = staged ? 1 : cstride;
    static const uint8_t g3[4] = {0u, 1u, 2u, 0u};  // missing (3) -> 0

#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < rp; ++r) {
        uint32_t* dst = out + r * kw;
        if (r >= rows) {
            std::memset(dst, 0, (size_t)kw * 4);
            continue;
        }
        const uint8_t* src = src0 + r * rs;
        if (cs == 1) {
            // plane-major: one sequential read + OR per genotype
            std::memset(dst, 0, (size_t)kw * 4);
            for (int m = 0; m < 16; ++m) {
                int64_t base = (int64_t)m * kw;
                if (base >= cols) break;
                int64_t lim = cols - base < kw ? cols - base : kw;
                const uint8_t* p = src + base;
                uint32_t shift = (uint32_t)(2 * m);
                for (int64_t c = 0; c < lim; ++c)
                    dst[c] |= (uint32_t)g3[p[c] & 3u] << shift;
            }
        } else {
            for (int64_t c = 0; c < kw; ++c) {
                uint32_t w = 0;
                for (int m = 0; m < 16; ++m) {
                    int64_t col = (int64_t)m * kw + c;
                    if (col >= cols) continue;
                    w |= (uint32_t)g3[src[col * cs] & 3u] << (2 * m);
                }
                dst[c] = w;
            }
        }
    }
    delete[] staged;
}

// Allele frequencies over rows (axis 0): geno [rows, cols] row-major,
// missing (3) excluded from numerator and denominator.
void mx_allele_freq(const uint8_t* geno, int64_t rows, int64_t cols,
                    double* freq) {
    int64_t* sums = new int64_t[cols];
    int64_t* called = new int64_t[cols];
    std::memset(sums, 0, (size_t)cols * 8);
    std::memset(called, 0, (size_t)cols * 8);
#pragma omp parallel
    {
        int64_t* lsum = new int64_t[cols]();
        int64_t* lcall = new int64_t[cols]();
#pragma omp for schedule(static) nowait
        for (int64_t r = 0; r < rows; ++r) {
            const uint8_t* src = geno + r * cols;
            for (int64_t j = 0; j < cols; ++j) {
                uint8_t v = src[j];
                if (v != 3) {
                    lsum[j] += v;
                    lcall[j] += 1;
                }
            }
        }
#pragma omp critical
        {
            for (int64_t j = 0; j < cols; ++j) {
                sums[j] += lsum[j];
                called[j] += lcall[j];
            }
        }
        delete[] lsum;
        delete[] lcall;
    }
    for (int64_t j = 0; j < cols; ++j) {
        int64_t n = called[j] > 0 ? called[j] : 1;
        freq[j] = (double)sums[j] / (2.0 * (double)n);
    }
    delete[] sums;
    delete[] called;
}

// Count missing entries (value 3) in geno [rows, cols].
int64_t mx_count_missing(const uint8_t* geno, int64_t rows, int64_t cols) {
    int64_t total = 0;
#pragma omp parallel for schedule(static) reduction(+ : total)
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t* src = geno + r * cols;
        for (int64_t j = 0; j < cols; ++j) total += (src[j] == 3);
    }
    return total;
}

// Blocked byte-matrix transpose: in [rows, cols] -> out [cols, rows].
void mx_transpose_u8(const uint8_t* in, int64_t rows, int64_t cols,
                     uint8_t* out) {
    const int64_t B = 64;
#pragma omp parallel for collapse(2) schedule(static)
    for (int64_t r0 = 0; r0 < rows; r0 += B) {
        for (int64_t c0 = 0; c0 < cols; c0 += B) {
            int64_t r1 = r0 + B < rows ? r0 + B : rows;
            int64_t c1 = c0 + B < cols ? c0 + B : cols;
            for (int64_t r = r0; r < r1; ++r)
                for (int64_t c = c0; c < c1; ++c)
                    out[c * rows + r] = in[r * cols + c];
        }
    }
}

// Fused .bed ingestion: raw SNP-major PLINK payload -> planar16 packings
// of BOTH orientations + allele frequencies, without ever materializing the
// dense genotype matrix (which is 8x the .bed size — prohibitive at the
// reference's 1M-SNP x 100K-individual scale).  This is the runtime
// equivalent of the reference's plink2Geno5codes32 bit-stream converters
// (src/miraculix/5codesChar.cc:213-340) fused with its freq pass
// (haplogeno.cc:1547-1661), targeting the planar16 layout.
//
// payload: [snps, nbytes] row-major — the .bed stream after the 3 magic
// bytes, untransposed.  zqt: [spad, kwi]; zqn: [ipad, kws]; freq: [snps];
// pfreq: [indiv].  Missing (PLINK code 01) packs as 0 and is excluded from
// both frequency denominators.  zqt, zqn and pfreq may each be NULL to
// skip that output (freq is always computed): out-of-core GRM needs only
// zqn + freq and must not pay for the 25 GB transposed packing.
namespace {
// Per-.bed-byte lookup tables: a byte holds 4 PLINK 2-bit codes.  dec4 is
// the 4 decoded genotypes re-packed 2-bit (missing -> 0), sum4/cnt4 the
// non-missing sum/count, miss4 a 4-bit missing mask.  One table lookup
// replaces four decode+branch iterations in both ingestion passes.
struct BedLuts {
    uint8_t dec4[256];
    uint8_t sum4[256];
    uint8_t cnt4[256];
    uint8_t miss4[256];
    BedLuts() {
        static const uint8_t dec[4] = {0u, 3u, 1u, 2u};
        for (int b = 0; b < 256; ++b) {
            uint8_t d4 = 0, s = 0, c = 0, mm = 0;
            for (int j = 0; j < 4; ++j) {
                uint8_t g = dec[(b >> (2 * j)) & 3];
                if (g == 3u) {
                    mm |= (uint8_t)(1u << j);
                    g = 0u;
                } else {
                    s = (uint8_t)(s + g);
                    c = (uint8_t)(c + 1);
                }
                d4 |= (uint8_t)(g << (2 * j));
            }
            dec4[b] = d4;
            sum4[b] = s;
            cnt4[b] = c;
            miss4[b] = mm;
        }
    }
};
const BedLuts LUT;
}  // namespace

void mx_bed_ingest(const uint8_t* payload, int64_t snps, int64_t indiv,
                   int64_t spad, int64_t kwi, int64_t ipad, int64_t kws,
                   uint32_t* zqt, uint32_t* zqn,
                   double* freq, double* pfreq) {
    const int64_t nbytes = (indiv + 3) / 4;
    static const uint8_t dec[4] = {0u, 3u, 1u, 2u};

    // pass 1: zq_t rows (decoded columns = individuals) + per-SNP freq
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < (zqt ? spad : snps); ++s) {
        uint32_t* dst = zqt ? zqt + s * kwi : nullptr;
        if (s >= snps) {
            std::memset(dst, 0, (size_t)kwi * 4);
            continue;
        }
        const uint8_t* row = payload + s * nbytes;
        int64_t sum = 0, called = 0;
        if (dst && (kwi & 3) == 0) {
            // plane-major fast path: within plane m the genotypes for words
            // c..c+3 sit in ONE byte (kwi % 4 == 0 keeps planes
            // byte-aligned), so each byte is one LUT hit + 4 ORs
            std::memset(dst, 0, (size_t)kwi * 4);
            for (int m = 0; m < 16; ++m) {
                int64_t base = (int64_t)m * kwi;
                if (base >= indiv) break;
                uint32_t shift = (uint32_t)(2 * m);
                int64_t lim = indiv - base;
                int64_t full = lim >= kwi ? kwi : (lim & ~3LL);
                const uint8_t* src = row + (base >> 2);
                int64_t c = 0;
                for (; c < full; c += 4) {
                    uint8_t b = src[c >> 2];
                    uint32_t d = LUT.dec4[b];
                    sum += LUT.sum4[b];
                    called += LUT.cnt4[b];
                    dst[c] |= (d & 3u) << shift;
                    dst[c + 1] |= ((d >> 2) & 3u) << shift;
                    dst[c + 2] |= ((d >> 4) & 3u) << shift;
                    dst[c + 3] |= ((d >> 6) & 3u) << shift;
                }
                for (; c < kwi && base + c < indiv; ++c) {
                    int64_t idx = base + c;
                    uint32_t g = dec[(row[idx >> 2] >> (2 * (idx & 3))) & 3u];
                    if (g == 3u) {
                        g = 0u;
                    } else {
                        sum += g;
                        called += 1;
                    }
                    dst[c] |= g << shift;
                }
            }
        } else if (dst) {
            for (int64_t c = 0; c < kwi; ++c) {
                uint32_t w = 0;
                for (int m = 0; m < 16; ++m) {
                    int64_t idx = (int64_t)m * kwi + c;
                    if (idx >= indiv) continue;
                    uint32_t g = dec[(row[idx >> 2] >> (2 * (idx & 3))) & 3u];
                    if (g == 3u) {
                        g = 0u;
                    } else {
                        sum += g;
                        called += 1;
                    }
                    w |= g << (2 * m);
                }
                dst[c] = w;
            }
        } else {  // freq-only scan: byte LUTs over the SNP's full bytes
            int64_t fb = indiv >> 2;
            for (int64_t k = 0; k < fb; ++k) {
                sum += LUT.sum4[row[k]];
                called += LUT.cnt4[row[k]];
            }
            for (int64_t i = 4 * fb; i < indiv; ++i) {
                uint32_t g = dec[(row[i >> 2] >> (2 * (i & 3))) & 3u];
                if (g != 3u) {
                    sum += g;
                    called += 1;
                }
            }
        }
        freq[s] = (double)sum / (2.0 * (double)(called > 0 ? called : 1));
    }

    // pass 2: zq_n rows (decoded columns = SNPs) + per-individual freq.
    // Parallel over byte-rows (4 individuals each); s/kws is the plane.
    if (!zqn && !pfreq) return;
    // Column-strided payload reads cost an L2 hit per byte; for payloads up
    // to 2 GB a blocked byte-transpose (two streaming passes) makes the
    // per-individual sweep sequential — measured 0.40 -> 0.17 s on the
    // 20k x 8k panel.  Larger payloads (the 25 GB out-of-core case) keep
    // the strided path rather than doubling peak host memory.
    uint8_t* payT = nullptr;
    if (zqn && indiv >= 4 && snps * nbytes <= (int64_t)1 << 31) {
        payT = new (std::nothrow) uint8_t[(size_t)(snps * nbytes)];
        if (payT) mx_transpose_u8(payload, snps, nbytes, payT);
    }
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < (ipad + 3) / 4; ++b) {
        uint32_t* dst[4];
        int64_t sum[4] = {0, 0, 0, 0}, called[4] = {0, 0, 0, 0};
        for (int j = 0; j < 4; ++j) {
            int64_t i = 4 * b + j;
            dst[j] = (zqn && i < ipad) ? zqn + i * kws : nullptr;
            if (dst[j]) std::memset(dst[j], 0, (size_t)kws * 4);
        }
        if (4 * b >= indiv) continue;  // pure padding rows: zeroed above
        if (zqn && 4 * b + 3 < indiv) {
            // fast path: all 4 individuals of this byte-column are real, so
            // decode the byte once via LUT, plane loop hoisted (no per-SNP
            // division), no per-genotype branches
            int64_t s = 0;
            for (int m = 0; s < snps; ++m) {
                uint32_t shift = (uint32_t)(2 * m);
                int64_t cend = snps - s < kws ? snps - s : kws;
                const uint8_t* col = payT ? payT + b * snps + s
                                          : payload + s * nbytes + b;
                const int64_t step = payT ? 1 : nbytes;
                for (int64_t c = 0; c < cend; ++c, ++s, col += step) {
                    uint8_t byte = *col;
                    uint32_t d = LUT.dec4[byte];
                    uint32_t mm = LUT.miss4[byte];
                    sum[0] += d & 3u;
                    sum[1] += (d >> 2) & 3u;
                    sum[2] += (d >> 4) & 3u;
                    sum[3] += (d >> 6) & 3u;
                    called[0] += 1 - (mm & 1u);
                    called[1] += 1 - ((mm >> 1) & 1u);
                    called[2] += 1 - ((mm >> 2) & 1u);
                    called[3] += 1 - ((mm >> 3) & 1u);
                    dst[0][c] |= (d & 3u) << shift;
                    dst[1][c] |= ((d >> 2) & 3u) << shift;
                    dst[2][c] |= ((d >> 4) & 3u) << shift;
                    dst[3][c] |= ((d >> 6) & 3u) << shift;
                }
            }
        } else {
            for (int64_t s = 0; s < snps; ++s) {
                uint8_t byte = payload[s * nbytes + b];
                int64_t m = s / kws, c = s - m * kws;
                uint32_t shift = (uint32_t)(2 * m);
                for (int j = 0; j < 4; ++j) {
                    int64_t i = 4 * b + j;
                    if (i >= indiv) break;
                    uint32_t g = dec[(byte >> (2 * j)) & 3u];
                    if (g == 3u) {
                        g = 0u;
                    } else {
                        sum[j] += g;
                        called[j] += 1;
                    }
                    if (dst[j]) dst[j][c] |= g << shift;
                }
            }
        }
        if (pfreq) {
            for (int j = 0; j < 4; ++j) {
                int64_t i = 4 * b + j;
                if (i < indiv)
                    pfreq[i] = (double)sum[j]
                               / (2.0 * (double)(called[j] > 0 ? called[j] : 1));
            }
        }
    }
    delete[] payT;
}

// Per-individual genotype sums and non-missing counts straight off the raw
// SNP-major .bed payload (no dense intermediate).  Lets chunked readers
// combine whole-panel pseudo-frequencies exactly: pf[i] = Σ_chunks sum_i /
// (2 Σ_chunks called_i) — the chunk-local pfreq ratios alone cannot be
// merged when missing counts differ per individual.
void mx_bed_colstats(const uint8_t* payload, int64_t snps, int64_t indiv,
                     int64_t* out_sum, int64_t* out_called) {
    const int64_t nbytes = (indiv + 3) / 4;
    const int64_t cap = 4 * nbytes;  // incl. the last byte's padding slots
    std::memset(out_sum, 0, (size_t)indiv * 8);
    std::memset(out_called, 0, (size_t)indiv * 8);
    // SNP-outer sweep: the payload is SNP-major, so a byte-column-major
    // walk would fetch each 64-byte cache line up to 64 times; reading
    // row by row streams the payload ONCE, with per-thread accumulators
    // merged at the end (the layout mx_bed_ingest's freq scan uses).
#pragma omp parallel
    {
        int64_t* ls = new int64_t[cap]();
        int64_t* lc = new int64_t[cap]();
#pragma omp for schedule(static) nowait
        for (int64_t s = 0; s < snps; ++s) {
            const uint8_t* row = payload + s * nbytes;
            for (int64_t b = 0; b < nbytes; ++b) {
                uint8_t byte = row[b];
                uint32_t d = LUT.dec4[byte];
                uint32_t mm = LUT.miss4[byte];
                int64_t i = 4 * b;
                ls[i] += d & 3u;
                ls[i + 1] += (d >> 2) & 3u;
                ls[i + 2] += (d >> 4) & 3u;
                ls[i + 3] += (d >> 6) & 3u;
                lc[i] += 1 - (int64_t)(mm & 1u);
                lc[i + 1] += 1 - (int64_t)((mm >> 1) & 1u);
                lc[i + 2] += 1 - (int64_t)((mm >> 2) & 1u);
                lc[i + 3] += 1 - (int64_t)((mm >> 3) & 1u);
            }
        }
#pragma omp critical
        {
            for (int64_t i = 0; i < indiv; ++i) {
                out_sum[i] += ls[i];
                out_called[i] += lc[i];
            }
        }
        delete[] ls;
        delete[] lc;
    }
}

// Inbreeding coefficients by Meuwissen & Luo (1992): for each animal,
// trace its ancestor paths youngest-first (a max-heap; parents-first
// numbering makes the popped sequence strictly decreasing) accumulating
// a_ii = sum_j L_j^2 * D_j.  Serves the pedigree's inbreeding for
// MiXBLUP-scale pedigrees (n ~ 1e6), where the per-animal Python loop is
// prohibitive; the Python implementation remains the tested oracle.
// sire/dam: 1-based, 0 = unknown, parents precede offspring (validated on
// the Python side).  f_out: n doubles.
void mx_inbreeding(const int64_t* sire, const int64_t* dam, int64_t n,
                   double* f_out) {
    std::vector<double> f(n + 1, 0.0);
    f[0] = -1.0;  // unknown-parent convention: D = 0.5 - 0.25*(F_s + F_d)
    std::vector<double> dvar(n + 1, 0.0);
    std::vector<double> lw(n + 1, 0.0);
    std::vector<uint8_t> inh(n + 1, 0);
    std::priority_queue<int64_t> heap;
    // full-sib memo: animals sharing the (sire, dam) pair share F, and in
    // livestock pedigrees full-sib families are large — compute each pair
    // once.  Consecutive-sib detection is enough (sib groups are stored
    // contiguously in practice); a full hash map would buy little more.
    int64_t prev_s = -1, prev_d = -1;
    double prev_f = 0.0;
    for (int64_t i = 1; i <= n; ++i) {
        int64_t s = sire[i - 1], d = dam[i - 1];
        dvar[i] = 0.5 - 0.25 * (f[s] + f[d]);
        if (s == 0 || d == 0) continue;  // F = 0 (unrelated unknown parent)
        if (s == prev_s && d == prev_d) {
            f[i] = prev_f;
            continue;
        }
        lw[i] = 1.0;
        heap.push(i);
        inh[i] = 1;
        double aii = 0.0;
        while (!heap.empty()) {
            int64_t j = heap.top();
            heap.pop();
            inh[j] = 0;
            double w = lw[j];
            lw[j] = 0.0;
            aii += w * w * dvar[j];
            int64_t ps = sire[j - 1], pd = dam[j - 1];
            if (ps > 0) {
                lw[ps] += 0.5 * w;
                if (!inh[ps]) { heap.push(ps); inh[ps] = 1; }
            }
            if (pd > 0) {
                lw[pd] += 0.5 * w;
                if (!inh[pd]) { heap.push(pd); inh[pd] = 1; }
            }
        }
        f[i] = aii - 1.0;
        prev_s = s;
        prev_d = d;
        prev_f = f[i];
    }
    std::memcpy(f_out, f.data() + 1, (size_t)n * sizeof(double));
}

// ---------------------------------------------------------------------------
// Greedy pairwise LD pruning over a precomputed banded r^2 (the
// plink --indep-pairwise scan).  Semantics identical to the Python loop in
// ops/grm._ld_prune_greedy (asserted by the tests): scan SNPs left to
// right; for each still-kept offending pair (r^2 > thr within the window)
// drop the LOWER-MAF member, ties dropping the later SNP.  One tight pass
// over the [snps, window] float band: ~1e9 comparisons/s where the Python
// loop pays ~10 us of interpreter overhead per SNP (hours at 1M SNPs
// against seconds here).
void mx_ld_prune(const float* band2, const double* maf, double thr,
                 int64_t snps, int64_t window, uint8_t* keep) {
    for (int64_t s = 0; s < snps; ++s) keep[s] = 1;
    const float thrf = (float)thr;
    for (int64_t s = 0; s < snps; ++s) {
        if (!keep[s]) continue;
        const float* row = band2 + s * window;
        const int64_t lim = std::min(window, snps - s - 1);
        bool any = false, drop_self = false;
        for (int64_t d = 0; d < lim; ++d) {
            const int64_t p = s + 1 + d;
            if (keep[p] && row[d] > thrf) {
                any = true;
                if (maf[s] < maf[p]) { drop_self = true; break; }
            }
        }
        if (!any) continue;
        if (drop_self) {
            keep[s] = 0;
            for (int64_t d = 0; d < lim; ++d) {
                const int64_t p = s + 1 + d;
                if (keep[p] && row[d] > thrf && maf[p] <= maf[s])
                    keep[p] = 0;
            }
        } else {
            for (int64_t d = 0; d < lim; ++d) {
                const int64_t p = s + 1 + d;
                if (keep[p] && row[d] > thrf) keep[p] = 0;
            }
        }
    }
}

// Same greedy scan over a PRE-THRESHOLDED uint8 offender mask:
// the r^2 comparison happens on device per block, so only snps*window
// BYTES cross host<->device instead of float32 values — 4x less transfer
// on the band fetch that dominates the 1M-SNP prune wall.
void mx_ld_prune_mask(const uint8_t* mask, const double* maf,
                      int64_t snps, int64_t window, uint8_t* keep) {
    for (int64_t s = 0; s < snps; ++s) keep[s] = 1;
    for (int64_t s = 0; s < snps; ++s) {
        if (!keep[s]) continue;
        const uint8_t* row = mask + s * window;
        const int64_t lim = std::min(window, snps - s - 1);
        bool any = false, drop_self = false;
        for (int64_t d = 0; d < lim; ++d) {
            const int64_t p = s + 1 + d;
            if (keep[p] && row[d]) {
                any = true;
                if (maf[s] < maf[p]) { drop_self = true; break; }
            }
        }
        if (!any) continue;
        if (drop_self) {
            keep[s] = 0;
            for (int64_t d = 0; d < lim; ++d) {
                const int64_t p = s + 1 + d;
                if (keep[p] && row[d] && maf[p] <= maf[s])
                    keep[p] = 0;
            }
        } else {
            for (int64_t d = 0; d < lim; ++d) {
                const int64_t p = s + 1 + d;
                if (keep[p] && row[d]) keep[p] = 0;
            }
        }
    }
}

int mx_codec_version(void) { return 9; }

}  // extern "C"
