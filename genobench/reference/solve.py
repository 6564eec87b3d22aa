"""GBLUP and the block solve (G + lam I) X = B in float64 on a dense Z.

GBLUP, with X = [1 | covariates], lam = (1 - h2) / h2 and G the scaled
VanRaden GRM:

    beta  = (X^T (G + lam I)^-1 X)^-1 X^T (G + lam I)^-1 y     (BLUE)
    g_hat = G (G + lam I)^-1 (y - X beta)                       (BLUP)
"""
from __future__ import annotations

import torch

from .zpass import F64, GrmOperator, cg

TOL_REL = 1e-10     # each reference solve: residual norm / rhs norm
MAXITER = 1000


def _solve(op: GrmOperator, b: torch.Tensor, lam: float, tol_rel: float,
           maxiter: int) -> tuple[torch.Tensor, int]:
    tol = tol_rel * float(b.norm(dim=0).min())
    return cg(op, b, lam, tol, maxiter)


def block_solve(op: GrmOperator, b: torch.Tensor, lam: float,
                tol_rel: float = TOL_REL, maxiter: int = MAXITER
                ) -> torch.Tensor:
    """X with (G + lam I) X = B."""
    return _solve(op, b.to(F64), lam, tol_rel, maxiter)[0]


def gblup(op: GrmOperator, x: torch.Tensor, y: torch.Tensor, h2: float,
          tol_rel: float = TOL_REL, maxiter: int = MAXITER) -> dict:
    """beta [p] and g_hat [n] of one trait."""
    x, y = x.to(F64), y.to(F64)
    lam = (1.0 - h2) / h2
    p = x.shape[1]
    b, _ = _solve(op, torch.cat([x, y[:, None]], dim=1), lam, tol_rel,
                  maxiter)
    beta = torch.linalg.solve(x.T @ b[:, :p], x.T @ b[:, p])
    u, _ = _solve(op, (y - x @ beta)[:, None], lam, tol_rel, maxiter)
    return {"beta": beta, "g_hat": op(u)[:, 0]}
