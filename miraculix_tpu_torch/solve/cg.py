"""Conjugate-gradient solvers on the device.

Torch twin of ``miraculix_tpu.solve.cg``: block CG with per-column
alpha/beta and the same ``denom > 0`` / ``rz > 0`` guards, so iteration
counts match the reference.  The operator G v = Z_c (Z_c^T v) is two packed
products.  The loop runs in Python and reads the stop test back to the host
once per iteration (ROADMAP: move the loop onto the device).  Spans
(``utils.logging.span``, recorded while a profile does): ``cg`` a solve,
``cg.iteration`` a pass of the loop with the stop test that ends it,
``cg.stop_test`` each read-back (the host's wait for the card; the first
comes before any pass), ``grm_cg_solve`` and ``grm_matvec`` their calls.

The f64 grade: :func:`grm_matvec_f64` runs both products through the exact
digit tier (``packed_matmul_f64``) with a float64 epilogue on the device, and
:func:`grm_cg_solve_refined` wraps the f32 CG in iterative refinement on
those residuals.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..geno import GenoMatrix, on_compute
from ..ops.common import packed_row_sq_stats
from ..ops.dgemm import dgemm, packed_matmul_f64
from ..utils.logging import span


class CGResult(NamedTuple):
    x: torch.Tensor              # solution [n, k] (or [n])
    iterations: int
    residual_norm: torch.Tensor  # [k] final residual 2-norms


def cg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: Optional[torch.Tensor] = None, tol: float = 1e-2,
       maxiter: int = 1000, minv: Optional[torch.Tensor] = None,
       dot: Optional[Callable] = None) -> CGResult:
    """Block conjugate gradient for SPD operators; each RHS column iterates
    with its own alpha/beta.  Stops when every column's residual norm is at
    most ``tol`` or after ``maxiter`` iterations.  ``minv`` [n] turns on
    Jacobi preconditioning (the stop test stays on the true residual).
    Without ``x0`` the start is 0 exactly and its residual is ``b``: no
    operator application multiplies a zero block.  ``dot(u, v)`` gives the
    per-column inner products (default: the column sums of u * v); a
    row-sharded solve passes one that also sums over the processes holding
    the other rows, so that every process reads the same stop test."""
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    with span("cg", columns=b.size(1)):
        x = torch.zeros_like(b) if x0 is None else \
            (x0[:, None] if squeeze else x0)
        if dot is None:
            def dot(u, v):
                return torch.sum(u * v, dim=0)

        def precond(r):
            return r if minv is None else minv[:, None] * r

        r = b if x0 is None else b - matvec(x)
        z = precond(r)
        p = z
        rs = dot(r, r)
        rz = dot(r, z)
        it = 0
        with span("cg.stop_test"):
            more = it < maxiter and bool(torch.any(torch.sqrt(rs) > tol))
        while more:
            with span("cg.iteration"):
                ap = matvec(p)
                denom = dot(p, ap)
                alpha = torch.where(denom > 0, rz / denom,
                                    torch.zeros_like(rz))
                x = x + alpha[None, :] * p
                r = r - alpha[None, :] * ap
                z = precond(r)
                rs = dot(r, r)
                rz_new = dot(r, z)
                beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
                p = z + beta[None, :] * p
                rz = rz_new
                it += 1
                with span("cg.stop_test"):
                    more = it < maxiter and \
                        bool(torch.any(torch.sqrt(rs) > tol))
        return CGResult(x[:, 0] if squeeze else x, it, torch.sqrt(rs))


def host_pcg(op, b, tol, maxiter, minv=None):
    """Host-driven float64 Jacobi-PCG on an SPD numpy operator: the loop of
    the out-of-core panels, whose operator streams chunks through the
    device.  ``tol`` is absolute on the residual 2-norm, as in :func:`cg`;
    x starts at 0 exactly, so ``op`` never multiplies a zero block.
    Returns ``(x, iterations, residual_norms)``."""
    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    x = np.zeros_like(b)
    r = b.copy()
    z = r if minv is None else minv[:, None] * r
    p = z.copy()
    rs = (r * r).sum(axis=0)
    rz = (r * z).sum(axis=0)
    it = 0
    while it < maxiter and (np.sqrt(rs) > tol).any():
        ap = op(p)
        denom = (p * ap).sum(axis=0)
        alpha = np.where(denom > 0, rz / np.maximum(denom, 1e-300), 0.0)
        x += alpha * p
        r -= alpha * ap
        z = r if minv is None else minv[:, None] * r
        rs = (r * r).sum(axis=0)
        rz_new = (r * z).sum(axis=0)
        p = z + np.where(rz > 0, rz_new / np.maximum(rz, 1e-300), 0.0) * p
        rz = rz_new
        it += 1
    return (x[:, 0] if squeeze else x), it, np.sqrt(rs)


def grm_diag(g: GenoMatrix, center: bool = True,
             scale: bool = False) -> torch.Tensor:
    """diag(Z_c Z_c^T) exactly, without forming G:
    diag[i] = sum z^2 - 4 sum_s f_s z_is + 4 sum_s f_s^2."""
    g = on_compute(g)
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
    with span("grm_matvec"):
        g = on_compute(g)
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
    with span("grm_cg_solve"):
        g = on_compute(g)
        b = torch.as_tensor(b, dtype=torch.float32, device=g.device)
        lam = torch.as_tensor(lam, dtype=torch.float32, device=g.device)

        def op(v):
            return grm_matvec(g, v, center=center, scale=scale,
                              precision=precision) + lam * v

        minv = jacobi_minv(grm_diag(g, center=center, scale=scale) + lam) \
            if precondition else None
        return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


def grm_matvec_f64(g: GenoMatrix, v, center: bool = True,
                   scale: bool = False) -> np.ndarray:
    """G v in float64: both packed products through the exact digit tier,
    the centering epilogue in float64, all on the panel's device (~1e-15
    relative).  Returns numpy float64."""
    g = on_compute(g)
    v = torch.as_tensor(v, dtype=torch.float64, device=g.device)
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    f = 2.0 * g.freq.double()
    zv = packed_matmul_f64(g.zq_t, v)[: g.snps]
    if center:
        zv -= f[:, None] * v.sum(dim=0)[None, :]      # (Z - M)^T v
    gv = packed_matmul_f64(g.zq_n, zv)[: g.indiv]
    if center:
        gv -= (f @ zv)[None, :]                       # (Z - M) (.)
    if scale:
        gv /= float(g.sigma2)
    gv = gv.cpu().numpy()
    return gv[:, 0] if squeeze else gv


def grm_cg_solve_refined(g: GenoMatrix, b, lam: float = 0.0,
                         center: bool = True, scale: bool = False,
                         tol: float = 1e-10, outer: int = 5,
                         inner_tol_factor: float = 1e-4,
                         inner_maxiter: int = 2000, precision: str = "fast"):
    """Float64-grade solve of (G + lam I) x = b by iterative refinement: the
    inner CG runs on the device at ``precision`` on the residual normalized
    to unit max column norm (a constant inner tolerance), the outer loop
    computes float64 residuals with :func:`grm_matvec_f64`.  Each pass
    multiplies the error by about the inner solve's relative accuracy.

    Returns ``(x, outer_iters, inner_iters_total, rel_residual)``, ``x``
    and ``rel_residual`` (per column, relative to |b|) numpy float64."""
    g = on_compute(g)
    b = np.asarray(b, np.float64)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = b.shape[0]
    if n != g.indiv:
        raise ValueError(f"b has {n} rows, expected indiv={g.indiv}")

    def residual(x):
        ax = grm_matvec_f64(g, x, center=center, scale=scale)
        if lam:
            ax = ax + lam * x
        return b - ax

    bnorm = np.maximum(np.linalg.norm(b, axis=0), 1e-300)
    x = np.zeros_like(b)
    r = b.copy()
    inner_total = 0
    it = 0
    rel = np.linalg.norm(r, axis=0) / bnorm
    while it < outer and rel.max() > tol:
        rnorm = float(np.linalg.norm(r, axis=0).max())
        if rnorm == 0.0:
            break
        res = grm_cg_solve(g, r / rnorm, lam=lam, center=center, scale=scale,
                           tol=float(inner_tol_factor), maxiter=inner_maxiter,
                           precision=precision)
        x = x + rnorm * res.x.cpu().numpy().astype(np.float64)
        inner_total += int(res.iterations)
        r = residual(x)
        rel = np.linalg.norm(r, axis=0) / bnorm
        it += 1
    return (x[:, 0] if squeeze else x), it, inner_total, rel
