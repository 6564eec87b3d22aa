"""Conjugate-gradient solvers on the device.

Torch twin of ``miraculix_tpu.solve.cg``: block CG with per-column
alpha/beta and the same ``denom > 0`` / ``rz > 0`` guards, so iteration
counts match the reference.  The operator G v = Z_c (Z_c^T v) is two packed
products.  The loop runs in Python and reads the stop test back to the host
once per iteration (ROADMAP: move the loop onto the device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..geno import GenoMatrix
from ..ops.common import packed_row_sq_stats
from ..ops.dgemm import dgemm


class CGResult(NamedTuple):
    x: torch.Tensor              # solution [n, k] (or [n])
    iterations: int
    residual_norm: torch.Tensor  # [k] final residual 2-norms


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: Optional[torch.Tensor] = None, tol: float = 1e-2,
       maxiter: int = 1000, minv: Optional[torch.Tensor] = None) -> CGResult:
    """Block conjugate gradient for SPD operators; each RHS column iterates
    with its own alpha/beta.  Stops when every column's residual norm is at
    most ``tol`` or after ``maxiter`` iterations.  ``minv`` [n] turns on
    Jacobi preconditioning (the stop test stays on the true residual)."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    x = torch.zeros_like(b) if x0 is None else (x0[:, None] if squeeze else x0)

    def precond(r):
        return r if minv is None else minv[:, None] * r

    r = b - matvec(x)
    z = precond(r)
    p = z
    rs = torch.sum(r * r, dim=0)
    rz = torch.sum(r * z, dim=0)
    it = 0
    while it < maxiter and bool(torch.any(torch.sqrt(rs) > tol)):
        ap = matvec(p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(denom > 0, rz / denom, torch.zeros_like(rz))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = precond(r)
        rs = torch.sum(r * r, dim=0)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    return CGResult(x[:, 0] if squeeze else x, it, torch.sqrt(rs))


def grm_diag(g: GenoMatrix, center: bool = True,
             scale: bool = False) -> torch.Tensor:
    """diag(Z_c Z_c^T) exactly, without forming G:
    diag[i] = sum z^2 - 4 sum_s f_s z_is + 4 sum_s f_s^2."""
    d = packed_row_sq_stats(g.zq_n)[: g.indiv]
    if center:
        f = g.freq
        fz = dgemm(g, f[:, None], trans="n", center=False)[:, 0]
        d = d - 4.0 * fz + 4.0 * torch.sum(f * f)
    if scale:
        d = d / g.sigma2
    return d


def jacobi_minv(d: torch.Tensor) -> torch.Tensor:
    """1/d, with non-positive entries mapped to 1 (a no-op there)."""
    return torch.where(d > 0, 1.0 / d, torch.ones_like(d))


def grm_matvec(g: GenoMatrix, v: torch.Tensor, center: bool = True,
               scale: bool = False, precision: str = "fast") -> torch.Tensor:
    """G v with G the (optionally VanRaden-scaled) relationship matrix, as
    two packed products."""
    zv = dgemm(g, v, trans="t", center=center, precision=precision)
    gv = dgemm(g, zv, trans="n", center=center, precision=precision)
    if scale:
        gv = gv / g.sigma2
    return gv


def grm_cg_solve(g: GenoMatrix, b, lam=0.0, center: bool = True,
                 scale: bool = False, tol: float = 1e-2, maxiter: int = 1000,
                 precision: str = "fast",
                 precondition: bool = False) -> CGResult:
    """Solve (G + lam I) x = b, G = Z_c Z_c^T (optionally / sigma^2).
    ``lam`` is a runtime value: a sweep over it rebuilds nothing."""
    b = torch.as_tensor(b, dtype=torch.float32, device=g.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=g.device)

    def op(v):
        return grm_matvec(g, v, center=center, scale=scale,
                          precision=precision) + lam * v

    minv = jacobi_minv(grm_diag(g, center=center, scale=scale) + lam) \
        if precondition else None
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)
