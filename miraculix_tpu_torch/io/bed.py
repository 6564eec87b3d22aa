"""PLINK fileset I/O: .bed / .bim / .fam / .freq readers and writers, the
SNP-range readers and the HWE panel simulators.

Twin of ``miraculix_tpu.io.bed``: the same file checks and errors, the same
byte layout and, for the simulators, the same numpy draws for the same seed
(so the same bytes).  The byte work runs in the native codec where it is
available (``io/codec.py``).
"""
from __future__ import annotations

import os

import numpy as np

from . import codec

BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


def _count_lines(path: str) -> int:
    """Non-blank line count of a .fam/.bim companion."""
    with open(path, "rb") as fh:
        return sum(1 for ln in fh if ln.strip())


def _fileset_dims(path: str) -> tuple[int, int, int]:
    """(n_snps, n_indiv, bytes per SNP) from the .bim/.fam companions."""
    if not path.endswith(".bed"):
        raise ValueError(f"file must end in .bed, got {path!r}")
    fam, bim = path[:-4] + ".fam", path[:-4] + ".bim"
    for q in (fam, bim):
        if not os.path.exists(q):
            raise FileNotFoundError(f"missing supplementary file {q}")
    n_indiv = _count_lines(fam)
    return _count_lines(bim), n_indiv, (n_indiv + 3) // 4


def _norm_snp_range(snp_start: int, snp_end: int,
                    n_snps: int) -> tuple[int, int]:
    """A negative start raises; a range past the end clamps (to an empty
    range when it lies wholly past it)."""
    if snp_start < 0:
        raise ValueError(f"bad SNP range: snp_start={snp_start} < 0")
    snp_end = min(snp_end, n_snps)
    return min(snp_start, snp_end), snp_end


def read_bed_payload(path: str, mmap: bool = True):
    """Raw SNP-major payload ``(payload, n_snps, n_indiv)`` with ``payload``
    uint8 [snps, ceil(indiv/4)] in disk order (memory-mapped by default)."""
    n_snps, n_indiv, nbytes = _fileset_dims(path)
    with open(path, "rb") as fh:
        if fh.read(3) != BED_MAGIC:
            raise ValueError("not a valid .bed file (bad magic bytes)")
        if mmap:
            payload = np.memmap(path, dtype=np.uint8, mode="r", offset=3,
                                shape=(n_snps * nbytes,))
        else:
            payload = np.frombuffer(fh.read(), dtype=np.uint8)
    if payload.size != nbytes * n_snps:
        raise ValueError(
            f".bed payload has {payload.size} bytes, expected {nbytes * n_snps}")
    return payload.reshape(n_snps, nbytes), n_snps, n_indiv


def read_bed_slice_payload(path: str, snp_start: int, snp_end: int):
    """``(payload, n_snps, n_indiv)`` with ``payload`` uint8
    [snp_end - snp_start, ceil(indiv/4)]: the SNP range [snp_start,
    snp_end) in disk order, one contiguous read (the fused ingestion's
    input for one SNP shard)."""
    n_snps, n_indiv, nbytes = _fileset_dims(path)
    snp_start, snp_end = _norm_snp_range(snp_start, snp_end, n_snps)
    with open(path, "rb") as fh:
        if fh.read(3) != BED_MAGIC:
            raise ValueError("not a valid .bed file (bad magic bytes)")
        fh.seek(3 + snp_start * nbytes)
        payload = np.frombuffer(fh.read((snp_end - snp_start) * nbytes),
                                dtype=np.uint8)
    return payload.reshape(snp_end - snp_start, nbytes), n_snps, n_indiv


def read_bed_slice(path: str, snp_start: int, snp_end: int):
    """``(plink, n_snps, n_indiv)`` with ``plink`` uint8 [ceil(indiv/4),
    snp_end - snp_start]: the SNP range in :func:`read_bed`'s layout."""
    payload, n_snps, n_indiv = read_bed_slice_payload(path, snp_start,
                                                      snp_end)
    return codec.transpose_u8(payload), n_snps, n_indiv


def read_bed(path: str):
    """``(plink, n_snps, n_indiv)`` with ``plink`` uint8 [ceil(indiv/4), snps]."""
    payload, n_snps, n_indiv = read_bed_payload(path, mmap=False)
    return codec.transpose_u8(payload), n_snps, n_indiv


def read_bed_genotypes(path: str):
    """``(geno, freq)``: genotypes uint8 [indiv, snps] (3 = missing) and the
    per-SNP allele frequencies."""
    plink, _, n_indiv = read_bed(path)
    geno = codec.plink_to_dense(plink, n_indiv)
    return geno, codec.allele_freq(geno, axis=0)


def write_bed(path: str, geno: np.ndarray, write_companions: bool = True) -> None:
    """Write genotypes [indiv, snps] (0/1/2, 3 = missing) as a PLINK fileset
    with minimal .bim/.fam companions."""
    if not path.endswith(".bed"):
        raise ValueError("file must end in .bed")
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        # the SNP-major stream: PLINK bytes [ceil(indiv/4), snps] transposed
        fh.write(codec.transpose_u8(codec.dense_to_plink(geno)))
    if write_companions:
        _write_companions(path, n_indiv, n_snps)


def _write_companions(path: str, n_indiv: int, n_snps: int) -> None:
    """Minimal .fam and .bim beside ``path``."""
    with open(path[:-4] + ".fam", "w") as fh:
        fh.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n_indiv))
    with open(path[:-4] + ".bim", "w") as fh:
        fh.writelines(f"1 snp{s} 0 {s + 1} A B\n" for s in range(n_snps))


def _fileset_path(path: str, ext: str) -> str:
    """Companion path of a fileset member (.bed, .bim or .fam)."""
    stem = path[:-4] if path.endswith((".bed", ".bim", ".fam")) else path
    return stem + ext


def read_bim(path: str) -> list:
    """Rows of the fileset's .bim as token lists [chrom, id, cM, bp, A1, A2]
    (whitespace-split, blank lines dropped).  ``path`` may be the .bed."""
    with open(_fileset_path(path, ".bim")) as fh:
        return [ln.split() for ln in fh if ln.strip()]


def read_fam_ids(path: str) -> list:
    """(FID, IID) pairs of the fileset's .fam.  ``path`` may be the .bed."""
    with open(_fileset_path(path, ".fam")) as fh:
        return [tuple(ln.split()[:2]) for ln in fh if ln.strip()]


def read_freq(path: str) -> np.ndarray:
    """A .freq table's second column (the frequencies), float64."""
    return np.loadtxt(path, dtype=str, ndmin=2)[:, 1].astype(np.float64)


def write_freq(path: str, freq: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.writelines(f"snp{i} {f:.10f}\n"
                      for i, f in enumerate(np.asarray(freq)))


def _hwe_draw(rng, n_indiv: int, n_snps: int,
              maf_range: tuple[float, float]) -> np.ndarray:
    """HWE genotypes uint8 [indiv, snps]: per-SNP MAFs, then one uniform a
    call, counted against the two genotype thresholds."""
    maf = rng.uniform(*maf_range, size=n_snps)
    u = rng.random((n_indiv, n_snps), dtype=np.float32)
    hom_ref = ((1.0 - maf) ** 2).astype(np.float32)
    het = hom_ref + (2.0 * maf * (1.0 - maf)).astype(np.float32)
    geno = (u >= hom_ref).astype(np.uint8)
    geno += u >= het
    return geno


def simulate_bed(path: str, n_indiv: int, n_snps: int, seed: int = 0,
                 chunk_snps: int = 65536,
                 maf_range: tuple[float, float] = (0.05, 0.5)) -> None:
    """Write a simulated HWE fileset of any size, SNP chunk by chunk (the
    host never holds the dense panel); byte-equal to
    ``miraculix_tpu.io.bed.simulate_bed`` for the same arguments (the chunked
    draws differ from :func:`simulate_genotypes`')."""
    if not path.endswith(".bed"):
        raise ValueError("file must end in .bed")
    rng = np.random.default_rng(seed)
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        for s0 in range(0, n_snps, chunk_snps):
            geno = _hwe_draw(rng, n_indiv, min(chunk_snps, n_snps - s0),
                             maf_range)
            fh.write(codec.transpose_u8(codec.dense_to_plink(geno)))
    _write_companions(path, n_indiv, n_snps)


def simulate_genotypes(n_indiv: int, n_snps: int, seed: int = 0,
                       maf_range: tuple[float, float] = (0.05, 0.5),
                       missing_rate: float = 0.0) -> np.ndarray:
    """Hardy-Weinberg panel uint8 [indiv, snps] (0/1/2, 3 = missing), drawn
    exactly as ``miraculix_tpu.io.bed.simulate_genotypes`` draws it."""
    rng = np.random.default_rng(seed)
    geno = _hwe_draw(rng, n_indiv, n_snps, maf_range)
    if missing_rate > 0:
        miss = rng.random((n_indiv, n_snps), dtype=np.float32) < missing_rate
        geno[miss] = codec.MISSING
    return geno
