"""GBLUP pipeline: randomized GRM PCA -> BLUE/BLUP.

Torch twin of ``miraculix_tpu.gblup`` on a :class:`GenoMatrix`, with the
reference's three solvers: block CG in f32 ("cg"), that CG inside float64
iterative refinement ("refined"), and a formed GRM with a Cholesky solve
("dense").  With lam = (1 - h2) / h2 and G VanRaden-scaled:

    beta_hat = (X^T (G + lam I)^-1 X)^-1 X^T (G + lam I)^-1 y     (BLUE)
    u        = (G + lam I)^-1 (y - X beta_hat)
    g_hat    = G u                                                (BLUP)

Outside "dense", G is never formed: every product with it is two packed
products.  The random draws (PCA test matrix, simulated phenotypes) are
numpy's, seeded as in the reference, so both packages see the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .geno import GenoMatrix
from .ops.dgemm import dgemm
from .ops.grm import grm
from .solve.cg import (grm_cg_solve, grm_cg_solve_refined, grm_matvec,
                       grm_matvec_f64)
from .solve.dense import dense_solve


def _check_container(g) -> None:
    if not isinstance(g, GenoMatrix):
        raise NotImplementedError(
            f"{type(g).__name__}: sharded and streamed containers are not "
            "ported yet (ROADMAP A12-A13)")


def randomized_grm_pca(g: GenoMatrix, k: int = 10, oversample: int = 8,
                       power_iters: int = 2,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenpairs of the (unscaled, centered) GRM by the Halko
    randomized range finder, G applied as Z_c (Z_c^T .).  Returns
    (eigenvalues [k], eigenvectors [indiv, k]) as numpy arrays."""
    _check_container(g)
    rng = np.random.default_rng(seed)
    omega = torch.as_tensor(rng.standard_normal((g.indiv, k + oversample)),
                            dtype=torch.float32, device=g.device)
    y = grm_matvec(g, omega)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(y)
        y = grm_matvec(g, q)
    q, _ = torch.linalg.qr(y)
    t = q.T @ grm_matvec(g, q)
    t = 0.5 * (t + t.T)
    w, v = torch.linalg.eigh(t)
    idx = torch.argsort(w, descending=True)[:k]
    return w[idx].cpu().numpy(), (q @ v[:, idx]).cpu().numpy()


@dataclasses.dataclass
class GBLUPResult:
    beta: np.ndarray        # fixed effects (intercept, covariates, PCs)
    g_hat: np.ndarray       # genomic values (BLUP)
    fitted: np.ndarray      # X beta + g_hat
    pcs: Optional[np.ndarray]
    cg_iterations: int = 0
    u: Optional[np.ndarray] = None  # (G_s + lam I)^-1 (y - X beta)
    converged: bool = True          # every CG (or refined) solve met tol


def gblup(g: GenoMatrix, y: np.ndarray, h2: float = 0.5, n_pcs: int = 10,
          covariates: Optional[np.ndarray] = None, solver: str = "cg",
          tol: float = 1e-4, maxiter: int = 2000,
          seed: int = 0, verbose: bool = False) -> GBLUPResult:
    """Full GBLUP estimation (reference ``gblup`` semantics).

    ``solver``: "cg" (f32 block CG on the device; ``tol`` bounds each
    column's residual norm of the unscaled system (Z_c Z_c^T + lam sigma2 I)
    b' = rhs), "refined" (float64-grade solves by iterative refinement,
    ``tol`` the relative f64 residual, e.g. 1e-10; g_hat by the f64
    matvec), or "dense" (the scaled GRM formed by :func:`grm` and solved by
    Cholesky in f32).  ``verbose`` is accepted for the reference's
    signature; on a ``GenoMatrix`` it prints nothing, as there."""
    if solver not in ("cg", "refined", "dense"):
        raise ValueError(f"solver must be cg/refined/dense, got {solver!r}")
    _check_container(g)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, dtype=np.float64).reshape(n)

    pcs = None
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, dtype=np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        if cov.shape[0] != n:
            raise ValueError(f"covariates have {cov.shape[0]} rows, "
                             f"expected {n}")
        cols.append(cov)
    if n_pcs > 0:
        _, pcs = randomized_grm_pca(g, k=n_pcs, seed=seed)
        cols.append(pcs)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]
    sigma2 = float(g.sigma2)
    converged = True

    def _cg(rhs: np.ndarray) -> Tuple[np.ndarray, int]:
        """(Z_c Z_c^T + lam sigma2 I) b' = rhs; returns (sigma2 b', iters)."""
        nonlocal converged
        if solver == "refined":
            xs, _, inner, rel = grm_cg_solve_refined(
                g, rhs, lam=lam * sigma2, scale=False, tol=tol,
                inner_maxiter=maxiter)
            converged &= bool(rel.max() <= tol)
            return xs * sigma2, inner
        res = grm_cg_solve(g, rhs, lam=lam * sigma2, scale=False, tol=tol,
                           maxiter=maxiter)
        converged &= bool(torch.all(res.residual_norm <= tol))
        return res.x.cpu().numpy().astype(np.float64) * sigma2, res.iterations

    def _dense(rhs: np.ndarray) -> np.ndarray:
        return dense_solve(gmat, torch.as_tensor(
            rhs, dtype=torch.float32, device=g.device)).x.cpu().numpy(
        ).astype(np.float64)

    rhs = np.concatenate([x, y[:, None]], axis=1)
    if solver == "dense":
        gmat = grm(g, scale=True, dtype=torch.float32)
        gmat.diagonal().add_(lam)
        b, iters = _dense(rhs), 0
    else:
        b, iters = _cg(rhs)
    bx, by = b[:, :p], b[:, p]
    beta = np.linalg.solve(x.T @ bx, x.T @ by)
    if solver == "dense":
        u = _dense((y - x @ beta)[:, None])[:, 0]
        gmat.diagonal().sub_(lam)
        g_hat = (gmat @ torch.as_tensor(u, dtype=torch.float32,
                                        device=g.device)).cpu().numpy()
        g_hat = g_hat.astype(np.float64)
    else:
        u, it_u = _cg((y - x @ beta)[:, None])
        u = u[:, 0]
        iters += it_u
        if solver == "refined":
            g_hat = grm_matvec_f64(g, u[:, None])[:, 0] / sigma2
        else:
            g_hat = grm_matvec(g, torch.as_tensor(
                u[:, None], dtype=torch.float32, device=g.device))
            g_hat = g_hat.cpu().numpy().astype(np.float64)[:, 0] / sigma2
    return GBLUPResult(beta=beta, g_hat=g_hat, fitted=x @ beta + g_hat,
                       pcs=pcs, cg_iterations=iters, u=u, converged=converged)


def snp_effects(g: GenoMatrix, res: GBLUPResult) -> np.ndarray:
    """Per-SNP marker effects alpha = Z_c^T u / sigma2 (g_hat = Z_c alpha)."""
    _check_container(g)
    if res.u is None:
        raise ValueError("GBLUPResult has no random-effect solutions")
    u = torch.as_tensor(res.u[:, None], dtype=torch.float32, device=g.device)
    a = dgemm(g, u, trans="t", center=True).cpu().numpy().astype(np.float64)
    return a[:, 0] / float(g.sigma2)


def predict(g_new: GenoMatrix, alpha: np.ndarray,
            freq_train: np.ndarray) -> np.ndarray:
    """Score new animals: (Z_new - 2 f_train) alpha, centered by the
    TRAINING allele frequencies."""
    c = 2.0 * np.asarray(freq_train, np.float32)
    out = dgemm(g_new, np.asarray(alpha, np.float32)[:, None], trans="n",
                center=c)
    return out.cpu().numpy().astype(np.float64)[:, 0]


def simulate_phenotypes(geno: np.ndarray, h2: float = 0.5, n_qtl: int = 100,
                        seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Additive phenotypes: random QTL effects plus noise scaled to h2, with
    the reference's draws.  Returns (phenotypes, true breeding values).
    Only the QTL columns are decoded, so the panel is never copied whole."""
    rng = np.random.default_rng(seed)
    n, s = geno.shape
    qtl = rng.choice(s, size=min(n_qtl, s), replace=False)
    eff = rng.standard_normal(len(qtl))
    zq = np.asarray(geno[:, qtl])
    zq = np.where(zq == 3, 0, zq).astype(np.float64)
    bv = (zq - zq.mean(0)) @ eff
    bv /= bv.std() + 1e-12
    e = rng.standard_normal(n) * np.sqrt((1 - h2) / h2)
    return bv + e, bv
