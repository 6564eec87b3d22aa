"""Dense positive-definite solvers: Cholesky solve, log-determinant,
relationship-matrix solve, inverse and square-root helpers.

Torch twin of ``miraculix_tpu.solve.dense`` on ``torch.linalg`` (cuSOLVER on
the card): the plain large linear algebra that the reference leaves to XLA.
Inputs are tensors or arrays, computed in their own type: a tensor stays on
its device, an array goes to ``device`` (the CUDA card unless the caller
names another, as the port's other entry points do), and the results are
tensors there.  A Cholesky
factorization of a matrix that is not positive definite yields NaNs, as the
reference's does, instead of raising.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geno import _device


class DenseSolveResult(NamedTuple):
    x: torch.Tensor
    logdet: Optional[torch.Tensor] = None


def _t(a, like: Optional[torch.Tensor] = None, device=None) -> torch.Tensor:
    """``a`` as a tensor: of ``like``'s type and device when given, else a
    tensor as it is and an array on ``_device(device)``."""
    if like is not None:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=_device(device))


def _eye(a: torch.Tensor) -> torch.Tensor:
    return torch.eye(a.shape[0], dtype=a.dtype, device=a.device)


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; all NaN where the factorization fails."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where(info == 0, chol, torch.full_like(chol, float("nan")))


def dense_solve(a, b, calc_logdet: bool = False, jitter: float = 0.0,
                device=None) -> DenseSolveResult:
    """Solve A X = B for symmetric positive-definite A by Cholesky, with the
    log-determinant 2 sum(log diag L) on request; ``jitter`` adds eps I
    first."""
    a = _t(a, device=device)
    if jitter:
        a = a + jitter * _eye(a)
    chol = _cholesky(a)
    b = _t(b, chol)
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    x = torch.cholesky_solve(b, chol)
    if squeeze:
        x = x[:, 0]
    logdet = None
    if calc_logdet:
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return DenseSolveResult(x, logdet)


def chol2inv(a, device=None) -> torch.Tensor:
    """Inverse of an SPD matrix from its Cholesky factorization."""
    return torch.cholesky_inverse(_cholesky(_t(a, device=device)))


def x_cinv_y_logdet(x, c, y,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """X^T C^-1 Y and log det C from one factorization."""
    chol = _cholesky(_t(c, device=device))
    ciy = torch.cholesky_solve(_t(y, chol), chol)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return _t(x, chol).T @ ciy, logdet


class RelMatResult(NamedTuple):
    x: torch.Tensor
    yhat: Optional[torch.Tensor] = None


def solve_relmat(a, tau, v, beta=None, compute_yhat: bool = True,
                 device=None) -> RelMatResult:
    """GBLUP helper: solve (A + tau I) x = v and return yhat = A x + beta."""
    a = _t(a, device=device)
    x = dense_solve(a + _t(tau, a) * _eye(a), v).x
    yhat = None
    if compute_yhat:
        yhat = a @ x
        if beta is not None:
            yhat = yhat + _t(beta, yhat)
    return RelMatResult(x, yhat)


def sqrt_posdef(a, device=None) -> torch.Tensor:
    """Symmetric square root of an SPD matrix by eigendecomposition."""
    w, q = torch.linalg.eigh(_t(a, device=device))
    w = torch.clamp(w, min=0.0)
    return (q * torch.sqrt(w)[None, :]) @ q.T


def sqrt_rhs(a, b, device=None) -> torch.Tensor:
    """A^(1/2) B without forming the square root."""
    w, q = torch.linalg.eigh(_t(a, device=device))
    w = torch.clamp(w, min=0.0)
    return q @ (torch.sqrt(w)[:, None] * (q.T @ _t(b, q)))


def solve_posdef(a, b, method: str = "auto", calc_logdet: bool = False,
                 jitter: float = 0.0, eigen_floor: float = 0.0,
                 device=None) -> DenseSolveResult:
    """Positive-(semi)definite solve with graceful degradation:
    "cholesky" (NaN where A is not positive definite), "eigh" (eigenvalues
    at or below ``eigen_floor`` dropped: the rank-deficient path), "lu", or
    "auto" (Cholesky, then eigh when its result is not finite)."""
    a = _t(a, device=device)
    if jitter:
        a = a + jitter * _eye(a)
    b = _t(b, a)
    squeeze = b.dim() == 1
    bb = b[:, None] if squeeze else b

    def _eigh():
        w, q = torch.linalg.eigh(a)
        keep = w > eigen_floor
        w_inv = torch.where(keep, 1.0 / torch.clamp(w, min=1e-300),
                            torch.zeros_like(w))
        x = q @ (w_inv[:, None] * (q.T @ bb))
        ld = (torch.sum(torch.where(keep, torch.log(torch.clamp(w, min=1e-300)),
                                    torch.zeros_like(w)))
              if calc_logdet else None)
        return x, ld

    if method == "eigh":
        x, ld = _eigh()
    elif method == "lu":
        x = torch.linalg.solve(a, bb)
        ld = torch.linalg.slogdet(a)[1] if calc_logdet else None
    elif method in ("cholesky", "auto"):
        x, ld = dense_solve(a, bb, calc_logdet=calc_logdet)
        if method == "auto" and not bool(torch.isfinite(x).all()):
            x, ld = _eigh()
    else:
        raise ValueError(f"unknown method {method!r}")
    return DenseSolveResult(x[:, 0] if squeeze else x, ld)
