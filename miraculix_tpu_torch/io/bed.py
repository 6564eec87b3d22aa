"""PLINK fileset I/O: .bed readers and writer, and the HWE panel simulator.

Numpy twin of ``miraculix_tpu.io.bed``: the same file checks, the same byte
layout and, for the simulator, the same numpy draws for the same seed.
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


def read_bed(path: str):
    """``(plink, n_snps, n_indiv)`` with ``plink`` uint8 [ceil(indiv/4), snps]."""
    payload, n_snps, n_indiv = read_bed_payload(path, mmap=False)
    return payload.T.copy(), n_snps, n_indiv


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
    plink = codec.dense_to_plink(geno)  # [ceil(indiv/4), snps]
    with open(path, "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(plink.T.tobytes())     # SNP-major stream
    if not write_companions:
        return
    with open(path[:-4] + ".fam", "w") as fh:
        fh.writelines(f"F{i} I{i} 0 0 0 -9\n" for i in range(n_indiv))
    with open(path[:-4] + ".bim", "w") as fh:
        fh.writelines(f"1 snp{s} 0 {s + 1} A B\n" for s in range(n_snps))


def simulate_genotypes(n_indiv: int, n_snps: int, seed: int = 0,
                       maf_range: tuple[float, float] = (0.05, 0.5),
                       missing_rate: float = 0.0) -> np.ndarray:
    """Hardy-Weinberg panel uint8 [indiv, snps] (0/1/2, 3 = missing), drawn
    exactly as ``miraculix_tpu.io.bed.simulate_genotypes`` draws it."""
    rng = np.random.default_rng(seed)
    maf = rng.uniform(*maf_range, size=n_snps)
    u = rng.random((n_indiv, n_snps), dtype=np.float32)
    hom_ref = ((1.0 - maf) ** 2).astype(np.float32)
    het = hom_ref + (2.0 * maf * (1.0 - maf)).astype(np.float32)
    geno = (u >= hom_ref).astype(np.uint8)
    geno += u >= het
    del u
    if missing_rate > 0:
        miss = rng.random((n_indiv, n_snps), dtype=np.float32) < missing_rate
        geno[miss] = codec.MISSING
    return geno
