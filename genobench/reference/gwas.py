"""The linear association scan: for each SNP s, y regressed on [X | z_s]
by ordinary least squares, in float64.  By Frisch-Waugh-Lovell, with
M = I - X (X^T X)^-1 X^T and n - p - 1 residual degrees of freedom:

    beta_s = z_s^T M y / d_s,   d_s = z_s^T M z_s
    se_s   = sqrt((y^T M y - beta_s z_s^T M y) / (n - p - 1) / d_s)
    t_s    = beta_s / se_s
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import genotypes
from .zpass import F64, rounded, zt_products


def scan(spec: genotypes.Spec, x: torch.Tensor, y: torch.Tensor,
         rnd: Optional[torch.dtype] = None) -> dict:
    """beta, se and t, each float64 [snps, traits], for the traits ``y``
    [indiv, traits] on covariates ``x`` [indiv, p] (intercept included),
    from one walk over Z."""
    x, y = x.to(F64), y.to(F64)
    n, p = x.shape
    k = y.shape[1]
    xtx_inv = torch.linalg.inv(x.T @ x)
    my = y - x @ (xtx_inv @ (x.T @ y))
    colsq, ztw = zt_products(spec, rounded(torch.cat([my, x], dim=1), rnd))
    num, a = ztw[:, :k], ztw[:, k:]
    d = colsq - torch.einsum("sp,pq,sq->s", a, xtx_inv, a)
    beta = num / d[:, None]
    sigma2 = ((my * my).sum(dim=0)[None, :] - beta * num) / (n - p - 1)
    se = torch.sqrt(sigma2 / d[:, None])
    return {"beta": beta, "se": se, "t": beta / se}
