"""Haplotype layer: random haplotype matrices, haplo->geno, coded wrappers.

Reference: the haplotype codings (src/miraculix/Haplo.h, HaploUint.cc),
``rhaplomatrix`` (src/miraculix/HaploR.cc:41-110 — random haplotypes with
per-SNP allele frequencies) and the TwoBithaplo2geno collapse kernels.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import codings as C
from .transform import CodedMatrix


def rhaplomatrix(
    freq: np.ndarray,
    indiv: int,
    freq2: Optional[np.ndarray] = None,
    coding: C.Coding = C.Coding.TWO_BIT_HAPLO,
    seed: int = 0,
) -> CodedMatrix:
    """Random haplotype matrix: allele k of SNP s is Bernoulli(freq[s])
    (allele 2 uses ``freq2`` when given) — semantics of the reference's
    ``rhaplomatrix`` (HaploR.cc:41-110).

    Returns a CodedMatrix in a haplotype coding; collapse with
    transform(..., haplo_to_geno=True) for genotypes.
    """
    if coding not in C.HAPLO_CODINGS:
        # a GENO coding would encode the allele-pair value 3 = (1,1) as
        # the missing sentinel — silent corruption, not a layout choice
        raise ValueError(f"rhaplomatrix needs a haplotype coding, got "
                         f"{coding} (see codings.HAPLO_CODINGS)")
    freq = np.asarray(freq, dtype=np.float64)
    f2 = freq if freq2 is None else np.asarray(freq2, dtype=np.float64)
    snps = len(freq)
    rng = np.random.default_rng(seed)
    a1 = (rng.random((indiv, snps)) < freq[None, :]).astype(np.uint8)
    a2 = (rng.random((indiv, snps)) < f2[None, :]).astype(np.uint8)
    dense = a1 + 2 * a2
    return CodedMatrix(
        buf=C.encode(dense, coding),
        coding=coding,
        snps=snps,
        indiv=indiv,
        is_haplo=True,
    )


def haplo_to_geno_matrix(m: CodedMatrix) -> CodedMatrix:
    """Collapse a coded haplotype matrix to OneByte genotypes."""
    dense = C.haplo_to_geno(m.dense())
    return CodedMatrix(
        buf=C.encode(dense, C.Coding.ONE_BYTE),
        coding=C.Coding.ONE_BYTE,
        snps=m.snps,
        indiv=m.indiv,
        is_haplo=False,
    )
