"""Transform: any-to-any recoding with SNP/individual sub-selection,
transposition, haplo->geno collapse, and file ingestion.

Reference: ``Transform(SxI, SxIint, codingInfo, selSnps, lenSnps, selIndiv,
lenIndiv, ...)`` (src/miraculix/transformUint.cc:1068-1315,
transform.h:25-36) — the coding-conversion hub every binding uses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from ..io import codec
from . import codings as C


@dataclasses.dataclass
class CodedMatrix:
    """A packed buffer plus its metadata — the role of the reference's
    SEXP-compatible container Information vector (compatibility.SEXP.h:
    126-136: SNPS/INDIVIDUALS/CODING/VARIANT/LDA...)."""

    buf: np.ndarray
    coding: C.Coding
    snps: int
    indiv: int
    is_haplo: bool = False

    def dense(self) -> np.ndarray:
        return C.decode(self.buf, self.coding, self.indiv, self.snps)


def transform(
    src: CodedMatrix,
    to_coding: C.Coding,
    sel_snps: Optional[Sequence[int]] = None,
    sel_indiv: Optional[Sequence[int]] = None,
    transpose: bool = False,
    haplo_to_geno: bool = False,
) -> CodedMatrix:
    """Recode ``src`` into ``to_coding`` with optional sub-selection of SNPs
    and individuals, transposition and haplotype collapse — the full
    semantics of the reference's Transform (transformUint.cc:1068-1315)."""
    dense = src.dense()
    is_haplo = src.is_haplo
    if haplo_to_geno:
        if not is_haplo:
            raise ValueError("haplo_to_geno on a genotype matrix")
        dense = C.haplo_to_geno(dense)
        is_haplo = False
    if sel_indiv is not None:
        dense = dense[np.asarray(sel_indiv)]
    if sel_snps is not None:
        dense = dense[:, np.asarray(sel_snps)]
    if transpose:   # the native blocked transpose for byte matrices
        dense = codec.transpose_u8(dense) if dense.dtype == np.uint8 \
            else np.ascontiguousarray(dense.T)
    if to_coding in C.HAPLO_CODINGS and not is_haplo:
        raise ValueError("cannot encode a genotype matrix into a haplo coding")
    if to_coding in C.GENO_CODINGS and is_haplo:
        raise ValueError("collapse haplotypes first (haplo_to_geno=True)")
    indiv, snps = dense.shape
    return CodedMatrix(
        buf=C.encode(dense, to_coding),
        coding=to_coding,
        snps=snps,
        indiv=indiv,
        is_haplo=is_haplo,
    )


def from_file(
    path: str,
    coding: C.Coding = C.Coding.PLANAR16,
    **kwargs,
) -> CodedMatrix:
    """Ingest a genotype file directly into a coding (the reference's
    is_file Transform path, transformUint.cc:1130-1160, and the
    DotFile/FileDot codings).  Supports PLINK .bed filesets and whitespace
    ASCII 0/1/2 tables (FilesUint.cc equivalents)."""
    from ..io import bed

    if path.endswith(".bed"):
        dense, _ = bed.read_bed_genotypes(path)
    else:
        dense = np.loadtxt(path, dtype=np.uint8, ndmin=2)
    src = CodedMatrix(
        buf=C.encode(dense, C.Coding.ONE_BYTE),
        coding=C.Coding.ONE_BYTE,
        snps=dense.shape[1],
        indiv=dense.shape[0],
    )
    return transform(src, coding, **kwargs)


def zero_geno(
    m: CodedMatrix,
    snps: Sequence[int],
    indiv: Sequence[int],
) -> CodedMatrix:
    """Zero the genotypes at the (indiv x snps) cross section — the R API's
    ``zeroGeno`` (reference zzzR.c entry; impl transformUint.cc)."""
    dense = m.dense()
    dense[np.ix_(np.asarray(indiv), np.asarray(snps))] = 0
    return CodedMatrix(C.encode(dense, m.coding), m.coding, m.snps, m.indiv,
                       m.is_haplo)
