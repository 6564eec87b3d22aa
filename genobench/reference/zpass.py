"""Float64 products with the genotype matrix Z [indiv, snps]: made again
unit by unit from the seed (never held whole) for one product, held dense
in float64 for the solvers, which multiply by it many times."""
from __future__ import annotations

from typing import Optional

import torch

from .. import genotypes

F64 = torch.float64


def rounded(x: torch.Tensor, rnd: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` in float64, first rounded to ``rnd`` where one is given."""
    return x.to(F64) if rnd is None else x.to(rnd).to(F64)


def zt_products(spec: genotypes.Spec, w: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One walk over Z: the per-SNP sums of squares (exact) and Z^T ``w``
    for ``w`` [indiv, k], both float64."""
    colsq = torch.zeros(spec.snps, dtype=F64, device=spec.device)
    ztw = torch.zeros((spec.snps, w.shape[1]), dtype=F64, device=spec.device)
    for r0, r1, g in genotypes.units(spec):
        z = g.to(F64)
        colsq += (z * z).sum(dim=0)
        ztw += z.T @ w[r0:r1]
        del z, g
    return colsq, ztw


def freq(colsum: torch.Tensor, n: int) -> torch.Tensor:
    """Sample allele frequencies f = sum_i z_is / (2 n)."""
    return colsum / (2.0 * n)


def dense(spec: genotypes.Spec) -> torch.Tensor:
    """Z as float64 [indiv, snps] on the spec's device."""
    z = torch.empty((spec.indiv, spec.snps), dtype=F64, device=spec.device)
    for r0, r1, g in genotypes.units(spec):
        z[r0:r1] = g
        del g
    return z


class GrmOperator:
    """V -> G V with G = Z_c Z_c^T / sigma2 (VanRaden), Z_c = Z - 1 (2f)^T,
    on a dense float64 Z; ``rnd`` rounds each product's vector operand."""

    def __init__(self, z: torch.Tensor, rnd: Optional[torch.dtype] = None):
        self.z = z
        self.rnd = rnd
        self.f2 = 2.0 * freq(z.sum(dim=0), z.shape[0])
        self.sigma2 = float(torch.sum(self.f2 * (1.0 - 0.5 * self.f2)))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        v = rounded(v, self.rnd)
        w = self.z.T @ v - self.f2[:, None] * v.sum(dim=0)[None, :]
        w = rounded(w, self.rnd)
        return (self.z @ w - (self.f2 @ w)[None, :]) / self.sigma2


def cg(op, b: torch.Tensor, lam: float, tol: float, maxiter: int
       ) -> tuple[torch.Tensor, int]:
    """(op + lam I) x = b by textbook CG, float64, each column on its own
    step sizes, until every column's residual norm is at most ``tol``."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = (r * r).sum(dim=0)
    it = 0
    while it < maxiter and bool((rs.sqrt() > tol).any()):
        ap = op(p) + lam * p
        denom = (p * ap).sum(dim=0)
        alpha = torch.where(denom > 0, rs / denom, torch.zeros_like(rs))
        x += alpha * p
        r -= alpha * ap
        rs_new = (r * r).sum(dim=0)
        beta = torch.where(rs > 0, rs_new / rs, torch.zeros_like(rs))
        p = r + beta * p
        rs = rs_new
        it += 1
    return x, it
