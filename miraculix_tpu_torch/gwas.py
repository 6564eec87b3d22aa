"""GWAS scans straight off the packed panel: linear, logistic score, and the
GRAMMAR-gamma mixed model, with or without leave-one-chromosome-out.

Torch twin of ``miraculix_tpu.gwas`` on a :class:`GenoMatrix`.  With X the
covariate matrix (intercept included) and M = I - X (X^T X)^-1 X^T,

    beta_s = z_s^T M y / d_s,      d_s = z_s^T M z_s
    d_s    = (Z^T Z)_ss - a_s^T (X^T X)^-1 a_s,   a_s = X^T z_s

so a whole scan is a few packed products (``ops.dgemm``) plus the exact
per-SNP sum of squares; no dense genotype matrix is formed and no SNP is
looped over.  The mixed scans add one block CG against
V = G / sigma^2 + lam I over [M y | M z_sampled]: at the default 64 sampled
SNPs that is 65 columns, which run on the wide kernel.  Host arithmetic is
numpy float64, as in the reference.

On an out-of-core :class:`StreamedGeno` every packed pass streams the
chunks, and the mixed scan's block CG is the container's host PCG, as in
the reference; the LOCO scan needs a GenoMatrix.  On a SNP-sharded
:class:`parallel.ShardedGeno` every 't' pass is row-parallel over the
shards, the sampled columns one 'n' pass by a one-hot RHS, the mixed
scan's CG the sharded Jacobi CG, and LOCO masks the off-chromosome SNPs
between the passes of one sharded operator (no repacking), as in the
reference; a 2D-sharded panel raises TypeError, as there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .gblup import _check_container
from .geno import GenoMatrix, subset_snps
from .ops.common import packed_indicator2, packed_row_sq_stats
from .ops.dgemm import dgemm, packed_matmul_tall
from .parallel import (ShardedGeno, ShardedGeno2D, host_global,
                       sharded_cg_solve, sharded_dgemm,
                       sharded_indicator2_dgemm_t, sharded_loco_cg_solve,
                       sharded_snp_sq_stats)
from .solve.cg import cg, grm_cg_solve, grm_diag, grm_matvec, jacobi_minv
from .streamed import StreamedGeno
from .utils.logging import span


# the least share of sigma2 that the SNPs off one chromosome must carry for
# its LOCO fold (float32 sums of 2pq over a panel agree to ~1e-6)
LOCO_MIN_SHARE = 1e-4


class GWASResult(NamedTuple):
    beta: np.ndarray      # [snps] per-SNP effect estimates
    se: np.ndarray        # [snps] standard errors
    t: np.ndarray         # [snps] t statistics
    p: np.ndarray         # [snps] two-sided p-values
    df: int               # residual degrees of freedom


class MixedGWASResult(NamedTuple):
    beta: np.ndarray      # [snps] GRAMMAR effect estimates (gamma-corrected)
    chi2: np.ndarray      # [snps] 1-df score statistics
    p: np.ndarray         # [snps] p-values (chi2 survival, 1 df)
    gamma: float          # GRAMMAR-gamma correction factor
    cg_iterations: int
    # largest final CG residual norm of each block solve (one per
    # chromosome for LOCO)
    residual_norm: Optional[np.ndarray] = None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _design(n: int, covariates) -> np.ndarray:
    """[1 | covariates] as float64 [n, p]."""
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        if cov.ndim == 1:
            cov = cov[:, None]
        if cov.shape[0] != n:
            raise ValueError(f"covariates have {cov.shape[0]} rows, "
                             f"expected {n}")
        cols.append(cov)
    return np.concatenate(cols, axis=1)


def _scan_container(g):
    """The container of a scan: the reference's scans take a GenoMatrix,
    a StreamedGeno or a ShardedGeno; a ShardedGeno2D raises TypeError."""
    if isinstance(g, ShardedGeno2D):
        raise TypeError("the GWAS scans take a GenoMatrix, StreamedGeno or "
                        "ShardedGeno, not a ShardedGeno2D")
    return _check_container(g)


def _snp_residual_denominators(g, x: np.ndarray,
                               xtx_inv: np.ndarray) -> np.ndarray:
    """d_s = z_s^T M z_s for every SNP (clamped at 0): one packed 't' pass
    (Z^T X) plus the exact sum z^2 per SNP (a pass of its own, chunk by
    chunk, on a streamed panel; row-parallel on a sharded one)."""
    a = _t_pass(g, x)                                           # [snps, p]
    with span("gwas.row_sq_stats"):
        if isinstance(g, ShardedGeno):
            zsq = host_global(sharded_snp_sq_stats(g)).astype(np.float64)
        elif isinstance(g, StreamedGeno):
            zsq = np.concatenate([_host(packed_row_sq_stats(c.zq_t))
                                  [: c.snps]
                                  for c in g.each_chunk(0, row_stats=1)])
        else:
            zsq = _host(packed_row_sq_stats(g.zq_t))[: g.snps]  # diag(Z^T Z)
    with span("gwas.denominators"):
        return np.maximum(zsq - np.einsum("sp,pq,sq->s", a, xtx_inv, a),
                          0.0)


def _t_pass(g, v: np.ndarray) -> np.ndarray:
    """Z^T v (uncentered) as one packed 't' pass, numpy f64 [snps, k]."""
    with span("gwas.t_pass"):
        if v.ndim == 1:
            v = v[:, None]
        if isinstance(g, ShardedGeno):
            return host_global(sharded_dgemm(
                g, v.astype(np.float32), trans="t",
                center=False)).astype(np.float64)
        if isinstance(g, StreamedGeno):
            return g.dgemm(v.astype(np.float32), trans="t",
                           center=False).astype(np.float64)
        return _host(dgemm(g, v.astype(np.float32), trans="t",
                           center=False))


def _pvalues(dist: str, stat: np.ndarray, df: int = 1) -> np.ndarray:
    with span("gwas.pvalues"):
        try:
            from scipy import stats
        except ImportError:  # pragma: no cover - scipy is a test dependency
            return np.full_like(stat, np.nan)
        if dist == "t":
            return 2.0 * stats.t.sf(np.abs(stat), df)
        if dist == "norm":
            return 2.0 * stats.norm.sf(np.abs(stat))
        return stats.chi2.sf(stat, 1)


def gwas_linear(g, y: np.ndarray,
                covariates: Optional[np.ndarray] = None) -> GWASResult:
    """Per-SNP linear association scan (see the module docstring).
    ``y``: [indiv] phenotype; ``covariates``: optional [indiv, c] (the
    intercept is always added).  t statistics use the per-SNP residual
    variance (y~^T y~ - beta_s^2 d_s) / (n - p - 1)."""
    with span("gwas_linear"):
        g = _scan_container(g)
        n = g.indiv
        y = np.asarray(y, np.float64).reshape(n)
        x = _design(n, covariates)
        p = x.shape[1]
        df = n - p - 1
        if df <= 0:
            raise ValueError(f"not enough residual df: n={n}, p={p}")
        xtx_inv = np.linalg.inv(x.T @ x)
        y_res = y - x @ (xtx_inv @ (x.T @ y))
        yty = float(y_res @ y_res)

        num = _t_pass(g, y_res)[:, 0]                           # Z^T M y
        d = _snp_residual_denominators(g, x, xtx_inv)
        with span("gwas.epilogue"):
            with np.errstate(divide="ignore", invalid="ignore"):
                beta = np.where(d > 0, num / np.maximum(d, 1e-300), 0.0)
                sigma2 = np.maximum(yty - beta * num, 0.0) / df
                se = np.sqrt(np.where(d > 0, sigma2 / np.maximum(d, 1e-300),
                                      np.inf))
                t = np.where(se > 0, beta / se, 0.0)
                t = np.where(np.isfinite(t), t, 0.0)
            pv = _pvalues("t", t, df)
        return GWASResult(beta=beta, se=se, t=t, p=pv, df=df)


def _sampled_columns(g, snps: np.ndarray) -> np.ndarray:
    """The genotype columns of ``snps`` [n, k]: the subset panel times the
    identity, one packed 'n' pass; a streamed or sharded panel, which has
    no subset, takes a one-hot [snps, k] RHS instead (streamed by chunks,
    or sharded by SNP rows)."""
    k = len(snps)
    if isinstance(g, (StreamedGeno, ShardedGeno)):
        onehot = np.zeros((g.snps, k), np.float32)
        onehot[snps, np.arange(k)] = 1.0
        if isinstance(g, ShardedGeno):
            return _host(sharded_dgemm(g, onehot, trans="n", center=False))
        return g.dgemm(onehot, trans="n", center=False).astype(np.float64)
    return _host(dgemm(subset_snps(g, snps), np.eye(k, dtype=np.float32),
                       trans="n", center=False))


def _gamma(mzcols: np.ndarray, vcols: np.ndarray, ds: np.ndarray) -> float:
    """GRAMMAR gamma: mean of (M z_s)^T V^-1 (M z_s) / d_s."""
    dv = np.einsum("nk,nk->k", mzcols, vcols)
    ok = ds > 0
    return float(np.mean(dv[ok] / ds[ok])) if ok.any() else 1.0


def gwas_mixed(g, y: np.ndarray,
               covariates: Optional[np.ndarray] = None, h2: float = 0.5,
               n_gamma_snps: int = 64, tol: float = 1e-6,
               maxiter: int = 2000, seed: int = 0) -> MixedGWASResult:
    """Mixed-model association scan, GRAMMAR-gamma flavor: one block CG
    against V = G/sigma^2 + lam I, lam = (1 - h2) / h2, over [M y | M z_s]
    for ``n_gamma_snps`` sampled SNPs, then

        U_s = z_s^T (M V^-1 M y),   chi2_s = U_s^2 / (gamma d_s).

    ``tol`` bounds each CG column's residual norm (absolute; relative on
    a :class:`StreamedGeno`, whose Jacobi-preconditioned host PCG takes
    the block CG's place, as in the reference; a ShardedGeno's CG is
    Jacobi-preconditioned too, as there)."""
    g = _scan_container(g)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    x = _design(n, covariates)
    xtx_inv = np.linalg.inv(x.T @ x)

    def proj(v):
        return v - x @ (xtx_inv @ (x.T @ v))

    y_res = proj(y)
    rng = np.random.default_rng(seed)
    k = min(n_gamma_snps, g.snps)
    sample = np.sort(rng.choice(g.snps, size=k, replace=False))
    mzcols = proj(_sampled_columns(g, sample))

    rhs = np.concatenate([y_res[:, None], mzcols], axis=1)
    if isinstance(g, StreamedGeno):
        solved, iters, rel = g.cg_solve(rhs, lam=lam, scale=True, tol=tol,
                                        maxiter=maxiter, precondition=True)
        resid = float((rel * np.linalg.norm(rhs, axis=0)).max())
    elif isinstance(g, ShardedGeno):
        res = sharded_cg_solve(g, rhs.astype(np.float32), lam=lam,
                               scale=True, tol=tol, maxiter=maxiter,
                               precondition=True)
        solved, iters = _host(res.x), int(res.iterations)
        resid = float(res.residual_norm.max())
    else:
        res = grm_cg_solve(g, rhs.astype(np.float32), lam=lam, scale=True,
                           tol=tol, maxiter=maxiter)
        solved, iters = _host(res.x), int(res.iterations)
        resid = float(res.residual_norm.max())
    ystar = proj(solved[:, 0])
    d = _snp_residual_denominators(g, x, xtx_inv)
    gamma = _gamma(mzcols, solved[:, 1:], d[sample])

    u = _t_pass(g, ystar)[:, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        chi2 = np.where(d > 0, u * u / (gamma * np.maximum(d, 1e-300)), 0.0)
        beta = np.where(d > 0, u / (gamma * np.maximum(d, 1e-300)), 0.0)
    return MixedGWASResult(
        beta=beta, chi2=chi2, p=_pvalues("chi2", chi2), gamma=gamma,
        cg_iterations=iters, residual_norm=np.array([resid]))


def gwas_logistic(g, y: np.ndarray,
                  covariates: Optional[np.ndarray] = None,
                  max_irls: int = 50, irls_tol: float = 1e-10) -> GWASResult:
    """Case-control per-SNP logistic score test, the null model fit once
    (IRLS on the covariates, host):

        U_s = z_s^T (y - mu),   V_s = sum_i w_i z_is^2 - a_s^T (X^T W X)^-1 a_s

    with w = mu (1 - mu) and a_s = X^T W z_s.  sum w z^2 = sum w z +
    2 sum w 1(z = 2): the z = 2 indicator is itself a packed panel
    (``packed_indicator2``), so every term is a packed product.  ``beta`` is
    the one-step U/V, se = 1/sqrt(V), and t the signed score statistic.
    On a streamed panel each chunk's indicator packing is made and
    multiplied on the compute device; on a sharded one the indicator
    product is row-parallel over the shards."""
    g = _scan_container(g)
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    if not np.isin(y, (0.0, 1.0)).all():
        raise ValueError("gwas_logistic needs a 0/1 phenotype")
    x = _design(n, covariates)
    beta0 = np.zeros(x.shape[1])
    for _ in range(max_irls):
        eta = x @ beta0
        mu = 1.0 / (1.0 + np.exp(-eta))
        w = np.maximum(mu * (1.0 - mu), 1e-12)
        wx = x * w[:, None]
        new = np.linalg.solve(x.T @ wx, wx.T @ (eta + (y - mu) / w))
        done = np.abs(new - beta0).max() < irls_tol
        beta0 = new
        if done:
            break
    mu = 1.0 / (1.0 + np.exp(-(x @ beta0)))
    w = np.maximum(mu * (1.0 - mu), 1e-12)
    wx = x * w[:, None]
    xtwx_inv = np.linalg.inv(x.T @ wx)

    zt = _t_pass(g, np.concatenate([(y - mu)[:, None], w[:, None], wx],
                                   axis=1))
    wcol = torch.as_tensor(w[:, None], dtype=torch.float32, device=g.device)
    if isinstance(g, ShardedGeno):
        s2 = host_global(sharded_indicator2_dgemm_t(g, wcol))[:, 0]
    elif isinstance(g, StreamedGeno):
        s2 = np.concatenate([
            _host(packed_matmul_tall(packed_indicator2(c.zq_n),
                                     wcol))[: c.snps, 0]
            for c in g.each_chunk()])
    else:
        s2 = _host(packed_matmul_tall(packed_indicator2(g.zq_n),
                                      wcol))[: g.snps, 0]
    u, zw, a = zt[:, 0], zt[:, 1], zt[:, 2:]
    v = np.maximum(zw + 2.0 * s2 - np.einsum("sp,pq,sq->s", a, xtwx_inv, a),
                   0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        zstat = np.where(v > 0, u / np.sqrt(np.maximum(v, 1e-300)), 0.0)
        beta = np.where(v > 0, u / np.maximum(v, 1e-300), 0.0)
        se = np.where(v > 0, 1.0 / np.sqrt(np.maximum(v, 1e-300)), np.inf)
    return GWASResult(beta=beta, se=se, t=zstat, p=_pvalues("norm", zstat),
                      df=1)


def _loco_cg(g: GenoMatrix, g_c: GenoMatrix, rhs: torch.Tensor,
             s2_loco: float, lam: float, *, tol: float, maxiter: int):
    """Jacobi-PCG on the LOCO operator (G_full - G_c) / s2_loco + lam I,
    the difference of two packed operators, preconditioned by the matching
    diagonal difference."""
    def op(v):
        gv = grm_matvec(g, v) - grm_matvec(g_c, v)
        return gv / s2_loco + lam * v

    minv = jacobi_minv((grm_diag(g) - grm_diag(g_c)) / s2_loco + lam)
    return cg(op, rhs, tol=tol, maxiter=maxiter, minv=minv)


def gwas_mixed_loco(g, y: np.ndarray, chrom: np.ndarray,
                    covariates: Optional[np.ndarray] = None, h2: float = 0.5,
                    n_gamma_snps: int = 32, tol: float = 1e-6,
                    maxiter: int = 2000, seed: int = 0) -> MixedGWASResult:
    """GRAMMAR-gamma with leave-one-chromosome-out relatedness.  ``chrom``:
    per-SNP chromosome labels.  Per chromosome c the rotation solves
    V_(-c) = G_(-c)/sigma2_(-c) + lam I, whose matvec is the full panel's
    minus the chromosome subset's (built with the full panel's frequencies,
    so the difference is exact); gamma is re-estimated per chromosome from
    SNPs sampled within it, and d_s is computed once.  On a ShardedGeno the
    subset is not repacked (it would be ragged across shards): the LOCO
    operator multiplies the 't' output by a 0/1 off-chromosome mask between
    the packed passes (:func:`parallel.sharded_loco_cg_solve`), so every
    chromosome runs the same shards, as in the reference.  A
    :class:`StreamedGeno` raises TypeError: the LOCO operator subsets the
    panel per chromosome."""
    if isinstance(g, StreamedGeno):
        raise TypeError(
            "gwas_mixed_loco needs a device GenoMatrix (the LOCO operator "
            "subsets the packed panel per chromosome); for out-of-core "
            "panels run gwas_mixed per chromosome with a pre-split panel, "
            "or materialize the panel")
    g = _scan_container(g)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    chrom = np.asarray(chrom)
    if chrom.shape != (g.snps,):
        raise ValueError(f"chrom must have one label per SNP "
                         f"({g.snps}), got {chrom.shape}")
    x = _design(n, covariates)
    xtx_inv = np.linalg.inv(x.T @ x)

    def proj(v):
        return v - x @ (xtx_inv @ (x.T @ v))

    # fold(idx) -> (solve(rhs, s2_loco), u_of(ystar) = Z_c^T ystar) for the
    # chromosome whose SNPs are idx
    if isinstance(g, ShardedGeno):
        freq = g.global_freq()[: g.snps].astype(np.float64)

        def fold(idx):
            w = np.ones(g.padded_snps, np.float32)
            w[g.snps:] = 0.0                    # padding (zero rows already)
            w[idx] = 0.0                        # leave chromosome c out
            return (lambda rhs, s2_loco: sharded_loco_cg_solve(
                        g, w, rhs.astype(np.float32), s2_loco, lam, tol=tol,
                        maxiter=maxiter),
                    lambda ystar: _t_pass(g, ystar)[idx, 0])
    else:
        freq = _host(g.freq)

        def fold(idx):
            g_c = subset_snps(g, idx)
            return (lambda rhs, s2_loco: _loco_cg(
                        g, g_c, torch.as_tensor(rhs, dtype=torch.float32,
                                                device=g.device),
                        s2_loco, lam, tol=tol, maxiter=maxiter),
                    lambda ystar: _t_pass(g_c, ystar)[:, 0])

    y_res = proj(y)
    d = _snp_residual_denominators(g, x, xtx_inv)
    sigma2 = float(g.sigma2)

    rng = np.random.default_rng(seed)
    u = np.zeros(g.snps)
    gamma_by = {}
    iters_total = 0
    resid = []
    for c in np.unique(chrom):
        idx = np.flatnonzero(chrom == c)
        solve, u_of = fold(idx)
        s2_loco = sigma2 - float(2.0 * np.sum(freq[idx] * (1.0 - freq[idx])))
        # sigma2 is a float32 sum: a chromosome that holds every SNP leaves
        # rounding noise of either sign, never a GRM to scale by
        if s2_loco <= LOCO_MIN_SHARE * sigma2:
            raise ValueError(f"chromosome {c!r} carries the whole panel")
        k = min(n_gamma_snps, len(idx))
        sample_local = np.sort(rng.choice(len(idx), size=k, replace=False))
        mzcols = proj(_sampled_columns(g, idx[sample_local]))

        rhs = np.concatenate([y_res[:, None], mzcols], axis=1)
        res = solve(rhs, s2_loco)
        solved = _host(res.x)
        iters_total += int(res.iterations)
        resid.append(float(res.residual_norm.max()))
        ystar = proj(solved[:, 0])
        gamma_by[c] = _gamma(mzcols, solved[:, 1:], d[idx][sample_local])
        u[idx] = u_of(ystar) / gamma_by[c]   # per-chromosome gamma

    with np.errstate(divide="ignore", invalid="ignore"):
        gam = np.array([gamma_by[c] for c in chrom])
        chi2 = np.where(d > 0, u * u * gam / np.maximum(d, 1e-300), 0.0)
        beta = np.where(d > 0, u / np.maximum(d, 1e-300), 0.0)
    return MixedGWASResult(
        beta=beta, chi2=chi2, p=_pvalues("chi2", chi2),
        gamma=float(np.mean(list(gamma_by.values()))),
        cg_iterations=iters_total, residual_norm=np.array(resid))
