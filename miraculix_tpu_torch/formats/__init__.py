"""Coding registry, any-to-any Transform, haplotype layer."""
from .codings import (GENO_CODINGS, HAPLO_CODINGS, Coding, decode, encode,
                      haplo_to_geno)
from .haplo import haplo_to_geno_matrix, rhaplomatrix
from .transform import CodedMatrix, from_file, transform, zero_geno

__all__ = [
    "CodedMatrix",
    "Coding",
    "GENO_CODINGS",
    "HAPLO_CODINGS",
    "decode",
    "encode",
    "from_file",
    "haplo_to_geno",
    "haplo_to_geno_matrix",
    "rhaplomatrix",
    "transform",
    "zero_geno",
]
