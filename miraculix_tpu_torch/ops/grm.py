"""Integer crossproducts and the VanRaden GRM.

Torch twin of the GRM core of ``miraculix_tpu.ops.grm``:
:func:`packed_crossprod` (kernel K3 of ``csrc/crossprod.cu`` on CUDA tensors),
:func:`snp_crossprod` and :func:`grm` without missing-data correction.  The
VanRaden finish (Schlather decomposition) is the reference's:

    M -= (m 1^T + 1 m^T) / n;  M += (sum m) / n^2;  M /= 2 sum p(1-p)

with m = M 1 the row sums of the raw integer crossproduct.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from ..geno import GenoMatrix
from .common import decode_planar16


def _check_capacity(kw: int) -> None:
    if 4 * 16 * kw >= 2 ** 31:
        raise ValueError(
            f"{16 * kw} packed SNP columns could overflow the exact int32 "
            "accumulator (limit ~536M); chunk the SNP axis and sum partials")


def packed_crossprod_plain(zq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_crossprod`: decode to float64 (exact
    below 2^53) and multiply."""
    _check_capacity(zq.shape[1])
    d = decode_planar16(zq, torch.float64)
    return (d @ d.T).to(torch.int32)


def packed_crossprod(zq: torch.Tensor) -> torch.Tensor:
    """Raw integer crossproduct decode(zq) decode(zq)^T -> int32 [rows, rows],
    exact while 4*snps < 2^31.  CUDA tensors launch K3; CPU tensors take the
    plain version."""
    _check_capacity(zq.shape[1])
    if not zq.is_cuda:
        return packed_crossprod_plain(zq)
    return _kernels.crossprod(zq.contiguous())


def snp_crossprod(g: GenoMatrix, snpmajor_output: bool = False) -> torch.Tensor:
    """M = Z Z^T [indiv, indiv] (GRM direction), or Z^T Z [snps, snps] with
    ``snpmajor_output=True`` (LD direction); int32."""
    if snpmajor_output:
        return packed_crossprod(g.zq_t)[: g.snps, : g.snps]
    return packed_crossprod(g.zq_n)[: g.indiv, : g.indiv]


def grm(g: GenoMatrix, scale: bool = True, dtype=torch.float32,
        correct_missing: Optional[bool] = None,
        pair_denominator: bool = False) -> torch.Tensor:
    """VanRaden genomic relationship matrix [indiv, indiv] via the Schlather
    decomposition.  ``correct_missing`` defaults, as in the reference, to
    whether the panel carries missing information."""
    if pair_denominator:
        raise NotImplementedError(
            "grm(pair_denominator=True) is not ported yet (ROADMAP A9, "
            "kernel B9)")
    if correct_missing is None:
        correct_missing = g.miss_rows_n is not None
    if correct_missing:
        raise NotImplementedError(
            "grm(correct_missing=True) needs ops/sparse, not ported yet "
            "(ROADMAP A8)")
    n = g.indiv
    m = snp_crossprod(g).to(dtype)
    colsum = m.sum(dim=1)
    total = colsum.sum()
    # in place (same order of operations as the reference): at 16K animals
    # each temporary would be another GB of device memory
    m.sub_(colsum[None, :] / n).sub_(colsum[:, None] / n).add_(total / (n * n))
    if scale:
        m.div_(g.sigma2.to(dtype))
    return m
