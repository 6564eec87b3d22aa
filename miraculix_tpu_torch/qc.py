"""Panel quality control: per-SNP / per-individual statistics and the
standard filters (PLINK's --maf / --geno / --mind / --hwe roles).

Beyond-parity: the reference ingests pre-cleaned panels and has no QC
layer, but every production pipeline runs these filters before the
linear algebra.  Stats stream over the SNP-major .bed payload in byte
chunks: a 256-bin byte histogram per SNP row (and per byte column) times
256-entry lookup tables (one pass, no dense panel); the
filtered fileset is written SNP-row-wise, so a panel never needs to fit
in memory.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .io import bed as bedio

# per-byte code counts: byte -> (#dense0, #dense1, #dense2, #missing)
# over its 4 two-bit PLINK codes (00->0, 01->missing, 10->1, 11->2)
_CODE_OF = np.array([0, 3, 1, 2], np.uint8)  # plink code -> dense value
_CNT = np.zeros((256, 4), np.uint16)
for _b in range(256):
    for _j in range(4):
        _v = _CODE_OF[(_b >> (2 * _j)) & 3]
        _CNT[_b, 3 if _v == 3 else _v] += 1
# per-byte missing bit mask (bit j = position j missing)
_MISS4 = np.zeros(256, np.uint8)
for _b in range(256):
    for _j in range(4):
        if _CODE_OF[(_b >> (2 * _j)) & 3] == 3:
            _MISS4[_b] |= 1 << _j
# the same tables as int64 matrices over a 256-bin byte histogram:
# counts = hist @ _CNT64, per-position missing = hist @ _MISS_BITS
_CNT64 = _CNT.astype(np.int64)
_MISS_BITS = ((_MISS4[:, None] >> np.arange(4)) & 1).astype(np.int64)


def _byte_hist(rows: np.ndarray, axis: int) -> np.ndarray:
    """256-bin histograms of the bytes of each row (``axis=1``) or each
    column (``axis=0``) of ``rows`` -> int64 [n, 256]: one bincount of
    (line index * 256 + byte)."""
    n = rows.shape[0 if axis == 1 else 1]
    line = np.arange(n, dtype=np.int64) * 256
    key = (line[:, None] if axis == 1 else line[None, :]) + rows
    return np.bincount(key.ravel(), minlength=n * 256).reshape(n, 256)


def _check_bed(path: str) -> None:
    if not path.endswith(".bed"):
        raise ValueError(f"expected a .bed path, got {path!r} (sibling "
                         ".bim/.fam names are derived from it)")


def _auto_chunk(chunk_snps: int, nbytes: int,
                budget_bytes: int = 512 << 20) -> int:
    """Cap the SNP chunk so the per-chunk expansion (~10 bytes per
    genotype byte: raw + the int64 histogram keys) stays inside a fixed
    byte budget — per-chunk memory must scale with individuals, or
    biobank-width panels OOM exactly where streaming matters."""
    return max(1, min(chunk_snps, budget_bytes // (10 * max(nbytes, 1))))


def snp_stats(bed_path: str, chunk_snps: int = 65_536):
    """One streaming pass -> per-SNP genotype counts [snps, 4]
    (n0, n1, n2, nmiss in ALT-dosage coding) and per-individual missing
    counts [indiv]."""
    _check_bed(bed_path)
    n_indiv = bedio._count_lines(bed_path[:-4] + ".fam")
    n_snps = bedio._count_lines(bed_path[:-4] + ".bim")
    nbytes = (n_indiv + 3) // 4
    chunk_snps = _auto_chunk(chunk_snps, nbytes)
    counts = np.zeros((n_snps, 4), np.int64)
    indiv_miss = np.zeros(nbytes * 4, np.int64)
    # positions past n_indiv in the last byte are zero-padded (code 00 =
    # dense 0): subtract them from n0 after the scan
    pad = nbytes * 4 - n_indiv
    with open(bed_path, "rb") as fh:
        fh.seek(3)
        for s0 in range(0, n_snps, chunk_snps):
            s1 = min(s0 + chunk_snps, n_snps)
            raw = np.frombuffer(fh.read((s1 - s0) * nbytes), np.uint8)
            rows = raw.reshape(s1 - s0, nbytes)
            counts[s0:s1] = _byte_hist(rows, 1) @ _CNT64
            # position 4b + j of the panel is bit j of byte column b
            indiv_miss += (_byte_hist(rows, 0) @ _MISS_BITS).reshape(-1)
    if pad:
        counts[:, 0] -= pad
    return counts, indiv_miss[:n_indiv]


def hwe_chi2_p(counts: np.ndarray) -> np.ndarray:
    """Hardy-Weinberg chi-square (1 df) p-values from per-SNP genotype
    counts [snps, 4]; monomorphic SNPs get p = 1."""
    n0 = counts[:, 0].astype(np.float64)
    n1 = counts[:, 1].astype(np.float64)
    n2 = counts[:, 2].astype(np.float64)
    nc = n0 + n1 + n2
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (2 * n2 + n1) / (2 * np.maximum(nc, 1))
        q = 1.0 - p
        e0, e1, e2 = nc * q * q, 2 * nc * p * q, nc * p * p
        chi2 = np.zeros(len(nc))
        for o, e in ((n0, e0), (n1, e1), (n2, e2)):
            chi2 += np.where(e > 0, (o - e) ** 2 / np.maximum(e, 1e-300),
                             0.0)
    try:
        from scipy.stats import chi2 as chi2dist

        pv = chi2dist.sf(chi2, 1)
    except ImportError:  # pragma: no cover
        pv = np.array([math.erfc(math.sqrt(x / 2.0)) for x in chi2])
    return np.where((p <= 0) | (p >= 1), 1.0, pv)


def qc_filter(
    bed_path: str,
    out_path: str,
    maf: float = 0.0,
    geno: float = 1.0,
    mind: float = 1.0,
    hwe: float = 0.0,
    chunk_snps: int = 65_536,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply the standard filters and write a filtered fileset:

    - ``mind``: drop individuals with missing rate > mind (applied FIRST,
      like PLINK, so their genotypes don't count against SNPs)
    - ``geno``: drop SNPs with missing rate > geno (over kept indiv)
    - ``maf``: drop SNPs with minor-allele frequency < maf
    - ``hwe``: drop SNPs with HWE p-value < hwe

    With all-default thresholds this is a no-op (100%-missing SNPs are
    kept; their MAF counts as 0, so any ``maf`` > 0 drops them).

    Returns (kept_snp_mask, kept_indiv_mask).
    """
    from .io import codec

    _check_bed(out_path)
    counts, indiv_miss = snp_stats(bed_path, chunk_snps)
    n_snps = counts.shape[0]
    n_indiv = len(indiv_miss)
    keep_i = indiv_miss / n_snps <= mind

    tmp_bed = None
    if keep_i.all():
        c = counts
    else:
        # re-count on the kept individuals; the same decode pass also
        # writes the individual-filtered bytes to a temp payload so the
        # final write is a byte-level row filter (no second decode)
        c = np.zeros_like(counts)
        nbytes = (n_indiv + 3) // 4
        ki = np.flatnonzero(keep_i)
        chunk = _auto_chunk(chunk_snps, nbytes)
        tmp_bed = out_path + ".indiv_filtered.tmp"
        with open(bed_path, "rb") as fh, open(tmp_bed, "wb") as tf:
            fh.seek(3)
            for s0 in range(0, n_snps, chunk):
                s1 = min(s0 + chunk, n_snps)
                raw = np.frombuffer(fh.read((s1 - s0) * nbytes), np.uint8)
                dense = codec.plink_to_dense(
                    raw.reshape(s1 - s0, nbytes).T, n_indiv)[ki]
                for v, col in ((0, 0), (1, 1), (2, 2), (3, 3)):
                    c[s0:s1, col] = (dense == v).sum(axis=0)
                tf.write(codec.dense_to_plink(dense).T.tobytes())

    nc = c[:, :3].sum(axis=1).astype(np.float64)
    ncall = np.maximum(nc, 1)
    p_alt = (2 * c[:, 2] + c[:, 1]) / (2 * ncall)
    maf_s = np.minimum(p_alt, 1 - p_alt)
    miss_rate = c[:, 3] / np.maximum(keep_i.sum(), 1)
    keep_s = (miss_rate <= geno) & (maf_s >= maf)
    if maf > 0:
        keep_s &= nc > 0  # all-missing SNPs have no defined MAF
    if hwe > 0:
        keep_s &= hwe_chi2_p(c) >= hwe

    try:
        _write_filtered(bed_path, out_path, keep_s, keep_i, chunk_snps,
                        tmp_bed=tmp_bed, n_kept_indiv=int(keep_i.sum()))
    finally:
        import os

        if tmp_bed and os.path.exists(tmp_bed):
            os.remove(tmp_bed)
    return keep_s, keep_i


def _write_filtered(bed_path, out_path, keep_s, keep_i, chunk_snps,
                    tmp_bed=None, n_kept_indiv=None):
    n_indiv = n_kept_indiv if tmp_bed else len(keep_i)
    nbytes = (n_indiv + 3) // 4
    src_path = tmp_bed or bed_path
    offset = 0 if tmp_bed else 3  # the temp payload has no magic bytes
    chunk = _auto_chunk(chunk_snps, nbytes)
    with open(src_path, "rb") as src, open(out_path, "wb") as dst:
        dst.write(bedio.BED_MAGIC)
        src.seek(offset)
        n_snps = len(keep_s)
        for s0 in range(0, n_snps, chunk):
            s1 = min(s0 + chunk, n_snps)
            raw = np.frombuffer(src.read((s1 - s0) * nbytes), np.uint8)
            dst.write(raw.reshape(s1 - s0, nbytes)[keep_s[s0:s1]].tobytes())
    for ext, keep in ((".bim", keep_s), (".fam", keep_i)):
        with open(bed_path[:-4] + ext) as src_f:
            lines = [ln for ln in src_f if ln.strip()]
        with open(out_path[:-4] + ext, "w") as dst_f:
            for k, ln in zip(keep, lines):
                if k:
                    dst_f.write(ln)


def rel_cutoff(grm: np.ndarray, cutoff: float = 0.125) -> np.ndarray:
    """Greedy unrelated-subset selection (PLINK --rel-cutoff role): while
    any off-diagonal relatedness exceeds ``cutoff``, drop the individual
    involved in the most violations (ties -> higher mean relatedness).
    Returns a boolean keep mask."""
    g = np.asarray(grm, np.float64)
    n = g.shape[0]
    viol = (g > cutoff)  # SIGNED, like plink: negative relatedness
    # (diverged groups) is not a violation
    np.fill_diagonal(viol, False)
    keep = np.ones(n, bool)
    counts = viol.sum(axis=1).astype(np.int64)
    while True:
        active = counts * keep
        worst = int(np.argmax(active))
        if active[worst] == 0:
            break
        cand = np.flatnonzero(active == active[worst])
        if len(cand) > 1:
            worst = int(cand[np.argmax(g[cand].mean(axis=1))])
        keep[worst] = False
        counts -= viol[:, worst]
        counts[worst] = 0
    return keep
