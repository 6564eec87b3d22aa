"""The scaled VanRaden GRM, G = Z_c Z_c^T / sigma2 with Z_c = Z - 1 (2f)^T,
f the sample allele frequencies and sigma2 = 2 sum_s f_s (1 - f_s): the
integer crossproduct Z Z^T exact (int8 products summed in int32), the
centering and scaling in float64."""
from __future__ import annotations

import torch

from .. import genotypes
from .zpass import F64

CHUNK = 16384   # SNPs a crossproduct step


def _pad8(x: torch.Tensor) -> torch.Tensor:
    """``x`` with zero rows and columns up to multiples of 8 (int8 GEMM)."""
    r, c = x.shape
    pr, pc = -r % 8, -c % 8
    return torch.nn.functional.pad(x, (0, pc, 0, pr)) if pr or pc else x


def full(spec: genotypes.Spec) -> torch.Tensor:
    """The whole G in float64 [indiv, indiv]."""
    n, s = spec.indiv, spec.snps
    if 4 * s >= 1 << 31:
        raise ValueError("too many SNPs for exact int32 sums")
    z = torch.empty((n, s), dtype=torch.int8, device=spec.device)
    colsum = torch.zeros(s, dtype=F64, device=spec.device)
    for r0, r1, g in genotypes.units(spec):
        z[r0:r1] = g
        colsum += g.sum(dim=0, dtype=torch.int64).to(F64)
        del g
    c = None
    for c0 in range(0, s, CHUNK):
        zc = _pad8(z[:, c0:c0 + CHUNK].contiguous())
        part = torch._int_mm(zc, zc.T)
        c = part if c is None else c.add_(part)
        del zc, part
    del z
    f2 = colsum / n
    sigma2 = float(torch.sum(f2 * (1.0 - 0.5 * f2)))
    g = c[:n, :n].to(F64)
    del c
    u = g.sum(dim=1) / n                      # Z (2f): row sums of Z Z^T / n
    g.sub_(u[None, :]).sub_(u[:, None]).add_(u.sum() / n).div_(sigma2)
    return g
