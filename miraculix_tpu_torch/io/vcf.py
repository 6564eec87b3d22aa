"""Minimal VCF ingestion: biallelic GT fields -> the packed pipeline.

Beyond-parity interop: the reference reads PLINK filesets only
(read_plink.jl); VCF is the sequencing-side interchange format, so a
panel coming off a variant-calling pipeline needs this step.  Supports
plain and gzip/BGZF-compressed files (BGZF is a sequence of gzip
members, which Python's gzip reads natively).

Scope (documented, checked): biallelic SNPs only (others skipped with a
count), diploid GT as the first colon-field, '/' or '|' separators,
missing ('.') -> 3.  The parser is a per-line Python loop — fine for the
typical "convert once, then work packed" flow; convert with
``vcf_to_bed`` and everything downstream runs on the native .bed path.
"""
from __future__ import annotations

import gzip
from typing import List, Tuple

import numpy as np

_GT = {
    "0/0": 0, "0|0": 0,
    "0/1": 1, "1/0": 1, "0|1": 1, "1|0": 1,
    "1/1": 2, "1|1": 2,
    "./.": 3, ".|.": 3, ".": 3,
    "0": 0, "1": 1,  # haploid calls (chrX etc.): dosage of the ALT allele
}


def _open(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path)


def read_vcf(path: str):
    """Read a VCF -> ``(geno [n_indiv, n_snps] uint8 (3 = missing),
    sample_ids, variants)`` with ``variants`` a list of
    ``(chrom, pos, vid, ref, alt)`` tuples; genotype values are ALT-allele
    dosages.  Non-biallelic, monomorphic, and GT-less records are skipped
    (their count is visible as the difference from the file's record
    count)."""
    samples: List[str] = []
    saw_header = False
    cols: List[np.ndarray] = []
    variants: List[Tuple[str, int, str, str, str]] = []
    with _open(path) as fh:
        for lineno, ln in enumerate(fh, 1):
            ln = ln.rstrip("\r\n")  # CRLF files: \r would poison the
            # last sample field (its GT then misses the table -> missing)
            if ln.startswith("##"):
                continue
            if ln.startswith("#CHROM"):
                samples = ln.split("\t")[9:]
                saw_header = True
                continue
            if not ln.strip():
                continue
            if not saw_header:
                raise ValueError(f"{path}:{lineno}: data line before "
                                 "#CHROM header")
            if not samples:
                raise ValueError(f"{path}: sites-only VCF (no sample "
                                 "columns in the #CHROM header)")
            parts = ln.split("\t")
            if len(parts) - 9 != len(samples):
                raise ValueError(
                    f"{path}:{lineno}: {max(len(parts) - 9, 0)} sample "
                    f"fields, header has {len(samples)}")
            chrom, pos, vid, ref, alt = parts[0], parts[1], parts[2], \
                parts[3], parts[4]
            if "," in alt or alt in (".", ""):
                continue  # multi-allelic / monomorphic: skip
            fmt = parts[8].split(":")
            if "GT" not in fmt:
                continue  # GT-less record (valid per spec): skip
            gt_idx = fmt.index("GT")
            col = np.empty(len(samples), np.uint8)
            for i, field in enumerate(parts[9:]):
                sub = field.split(":")
                # spec allows dropping trailing subfields: a field shorter
                # than gt_idx has no GT -> missing
                gt = sub[gt_idx] if gt_idx < len(sub) else "."
                col[i] = _GT.get(gt, 3)  # partial calls like ./1 -> 3
            cols.append(col)
            variants.append((chrom, int(pos), vid, ref, alt))
    if not cols:
        raise ValueError(f"{path}: no usable biallelic records")
    geno = np.stack(cols, axis=1)
    return geno, samples, variants


def vcf_to_bed(vcf_path: str, bed_path: str) -> Tuple[int, int]:
    """Convert a VCF to a PLINK .bed/.bim/.fam fileset; returns
    (n_indiv, n_snps).  The .bed then feeds the native fused ingestion
    (from_bed / StreamedGeno) like any PLINK panel."""
    from . import bed as bedio

    geno, samples, variants = read_vcf(vcf_path)
    # payload only: the REAL companions come from the VCF below (writing
    # write_bed's placeholders first just to overwrite them risked leaving
    # plausible-looking wrong .fam/.bim on a mid-rewrite failure)
    bedio.write_bed(bed_path, geno, write_companions=False)
    with open(bed_path[:-4] + ".fam", "w") as fh:
        for s in samples:
            fh.write(f"{s} {s} 0 0 0 -9\n")
    with open(bed_path[:-4] + ".bim", "w") as fh:
        for chrom, pos, vid, ref, alt in variants:
            name = vid if vid not in (".", "") else f"{chrom}:{pos}"
            # dense value = ALT dosage = .bed code 0b11 = homozygous A2,
            # so A1 = REF, A2 = ALT — swapping these would allele-flip
            # every genotype for external PLINK/GCTA consumers
            fh.write(f"{chrom} {name} 0 {pos} {ref} {alt}\n")
    return geno.shape[0], geno.shape[1]
