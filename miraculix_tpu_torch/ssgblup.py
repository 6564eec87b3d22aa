"""Single-step GBLUP (ssGBLUP): the H-matrix mixed-model equations that
combine pedigree and genomic information, solved matrix-free on the device.

Torch twin of ``miraculix_tpu.ssgblup``.  Following Aguilar et al. (2010) /
Christensen & Lund (2010):

    H^-1 = A^-1 + [ 0   0                              ]
                  [ 0   tau * Gw^-1  -  omega * A22^-1 ]

with A^-1 the sparse pedigree inverse (Henderson's rules,
:mod:`miraculix_tpu_torch.pedigree`), Gw = (1-blend) * G_VanRaden + blend * I
the blended genomic relationship of the genotyped subset, and A22 the
pedigree relationship among genotyped animals.  Nothing is densified:

- A^-1 v      : one COO gather and ``index_add_``;
- Gw^-1 v2    : Jacobi-preconditioned CG whose matvec is two packed
                products over the SNP panel (G never formed);
- A22^-1 v2   : A22^-1 = A22blk - A21blk (A11blk)^-1 A12blk on the blocks
                of the sparse A^-1, with the inner (A11)^-1 again a Jacobi
                CG;
- the MME     : one outer block CG over [beta; u].

The CGs are the port's :func:`solve.cg.cg`, nested three deep (the MME CG,
and Gw^-1's and A11^-1's inside every H^-1 apply); each reads its stop test
to the host once an iteration.  The device work is float32, the REML glue
numpy float64, as in the reference.  On an out-of-core
:class:`StreamedGeno` (``SingleStepHInv._kind == "streamed"``), Gw^-1 is
the container's host PCG and the MME's outer CG is
:func:`solve.cg.host_pcg`, each matvec streaming the chunks, as in the
reference.  On a SNP-sharded :class:`parallel.ShardedGeno`
(``_kind == "sharded"``) the Gw products are the sharded operator (one
psum each) and diag(G) the sharded exact diagonal, also as in the
reference; a ShardedGeno2D raises TypeError, as there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .gblup import _check_container
from .geno import from_bed
from .parallel import (ShardedGeno, ShardedGeno2D, sharded_grm_diag,
                       sharded_grm_matvec)
from .pedigree import SparseCOO, a_inverse, check_pedigree, read_pedigree
from .solve.cg import cg, grm_diag, grm_matvec, host_pcg
from .streamed import StreamedGeno


def _normalized_cg(matvec, b, tol, maxiter, minv=None):
    """CG with a per-column normalized RHS so the absolute tolerance of
    :func:`solve.cg.cg` acts relatively: the inner solves of a nested
    operator must not change character with the outer iterate's scale."""
    norm = torch.linalg.norm(b, dim=0, keepdim=True)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    r = cg(matvec, b / safe, tol=tol, maxiter=maxiter, minv=minv)
    return r.x * safe


def _a22_inv_impl(a11, a12, a22, a11_minv, v2, *, tol, maxiter):
    t = a12.matvec(v2)                            # A12blk v2   [n1, k]
    w = _normalized_cg(a11.matvec, t, tol, maxiter, minv=a11_minv)
    return a22.matvec(v2) - a12.matvec(w, trans="t")


def _split_coo(rows, cols, vals, group, pos):
    """Split symmetric COO by the (group[row], group[col]) block."""
    gr, gc = group[rows], group[cols]
    out = {}
    for name, mr, mc in (("11", 0, 0), ("12", 0, 1), ("22", 1, 1)):
        m = (gr == mr) & (gc == mc)
        out[name] = (pos[rows[m]], pos[cols[m]], vals[m])
    return out


class SingleStepHInv:
    """Matrix-free H^-1 over all pedigree animals, on the panel's device.

    ``geno_ids``: 1-based pedigree ids of the SNP panel's rows (so
    ``geno_ids[i]`` is the animal whose genotypes are row i of ``g``).
    ``blend`` is the identity fraction mixed into G (VanRaden 2008's
    0.95*G + 0.05*I default guards a singular G); ``tau``/``omega`` are
    the Aguilar scaling knobs (1, 1 = standard ssGBLUP).
    """

    def __init__(self, sire, dam, g, geno_ids, *,
                 blend: float = 0.05, tau: float = 1.0, omega: float = 1.0,
                 inner_tol: float = 1e-6, inner_maxiter: int = 1000,
                 f: Optional[np.ndarray] = None):
        if isinstance(g, ShardedGeno2D):
            raise TypeError("SingleStepHInv takes a GenoMatrix, StreamedGeno "
                            "or ShardedGeno, not a ShardedGeno2D")
        g = _check_container(g)
        self._kind = ("streamed" if isinstance(g, StreamedGeno) else
                      "sharded" if isinstance(g, ShardedGeno) else "geno")
        n = check_pedigree(sire, dam)
        geno_ids = np.asarray(geno_ids, np.int64)
        if geno_ids.min() < 1 or geno_ids.max() > n:
            raise ValueError("geno_ids must be 1-based pedigree ids")
        if len(np.unique(geno_ids)) != len(geno_ids):
            raise ValueError("geno_ids must be unique")
        if g.indiv != len(geno_ids):
            raise ValueError(f"panel has {g.indiv} rows, geno_ids has "
                             f"{len(geno_ids)}")
        self.n, self.g, self.device = n, g, g.device
        self.tau, self.omega, self.blend = tau, omega, blend
        self.inner_tol, self.inner_maxiter = inner_tol, inner_maxiter

        rows, cols, vals = a_inverse(sire, dam, f=f)
        self.ainv = SparseCOO(rows, cols, vals, (n, n), device=self.device)

        # group: 0 = non-genotyped, 1 = genotyped; pos = index within group
        group = np.zeros(n, np.int64)
        group[geno_ids - 1] = 1
        pos = np.zeros(n, np.int64)
        pos[group == 0] = np.arange(n - len(geno_ids))
        # genotyped animals are positioned by panel row, so block vectors
        # align with the GenoMatrix without any further permutation
        pos[geno_ids - 1] = np.arange(len(geno_ids))
        n2 = len(geno_ids)
        n1 = n - n2
        self.n1, self.n2 = n1, n2
        blocks = _split_coo(rows, cols, vals, group, pos)
        self.a11 = SparseCOO(*blocks["11"], (n1, n1), device=self.device)
        self.a12 = SparseCOO(*blocks["12"], (n1, n2), device=self.device)
        self.a22 = SparseCOO(*blocks["22"], (n2, n2), device=self.device)
        self.geno_rows = torch.as_tensor(geno_ids - 1, device=self.device)

        self._sigma2 = float(g.sigma2)
        gd = (self._vec(g.grm_diag(center=True)) if self._kind == "streamed"
              else sharded_grm_diag(g) if self._kind == "sharded"
              else grm_diag(g, center=True))
        self._gw_diag = (1.0 - blend) * gd / self._sigma2 + blend
        self._gw_minv = 1.0 / self._gw_diag
        a11d = self.a11.diag()
        self._a11_minv = torch.where(a11d > 0, 1.0 / a11d,
                                     torch.ones_like(a11d))

    def _vec(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    # -- block operators (v2: [n2, k]) ------------------------------------
    def _gw(self, v2):
        gv = (sharded_grm_matvec(self.g, v2) if self._kind == "sharded"
              else grm_matvec(self.g, v2, center=True, scale=False)
              ) / self._sigma2
        return (1.0 - self.blend) * gv + self.blend * v2

    def gw_inv(self, v2) -> torch.Tensor:
        """Gw^-1 v2 by Jacobi-preconditioned CG on the packed panel.

        A streamed panel solves on the container's host PCG (each matvec
        one pass over the chunks): Gw x = b rewrites to (G / sigma2 +
        blend / (1 - blend) I) x = b / (1 - blend), its operator."""
        if self._kind == "streamed":
            if self.blend >= 1.0:              # Gw = I
                return self._vec(v2)
            b = torch.as_tensor(v2).cpu().numpy().astype(np.float64)
            x, _, _ = self.g.cg_solve(
                b / (1.0 - self.blend),
                lam=self.blend / (1.0 - self.blend), scale=True,
                tol=self.inner_tol, maxiter=self.inner_maxiter,
                precondition=True)
            return self._vec(x)
        return _normalized_cg(self._gw, self._vec(v2), self.inner_tol,
                              self.inner_maxiter, minv=self._gw_minv)

    def a22_inv(self, v2) -> torch.Tensor:
        """A22^-1 v2 from the blocks of the sparse A^-1:
        A22^-1 = A22blk - A21blk (A11blk)^-1 A12blk."""
        v2 = self._vec(v2)
        if self.n1 == 0:
            return self.a22.matvec(v2)
        return _a22_inv_impl(self.a11, self.a12, self.a22, self._a11_minv,
                             v2, tol=self.inner_tol,
                             maxiter=self.inner_maxiter)

    def matvec(self, v) -> torch.Tensor:
        """H^-1 v for v [n] or [n, k]."""
        v = self._vec(v)
        squeeze = v.dim() == 1
        vv = v[:, None] if squeeze else v
        out = self.ainv.matvec(vv)
        v2 = vv[self.geno_rows]
        corr = self.tau * self.gw_inv(v2) - self.omega * self.a22_inv(v2)
        out.index_add_(0, self.geno_rows, corr)
        return out[:, 0] if squeeze else out

    def diag_approx(self) -> torch.Tensor:
        """Positive diagonal surrogate for Jacobi preconditioning of the
        MME (diag(A^-1) plus the genotyped blocks' diagonal surrogates,
        not the exact diag(H^-1), which has no cheap closed form)."""
        d = self.ainv.diag()
        # diag(Gw^-1) ~ 1/diag(Gw); diag(A22^-1) ~ 1 (relationship diag
        # ~ 1+F): crude, but it only steers Jacobi convergence
        corr = self.tau * self._gw_minv - self.omega
        d.index_add_(0, self.geno_rows, torch.clamp(corr, min=0.0))
        return torch.clamp(d, min=1e-3)


class SSGBLUPResult(NamedTuple):
    beta: np.ndarray          # fixed effects [p]
    u: np.ndarray             # breeding values, ALL animals [n]
    iterations: int           # outer CG iterations
    residual_norm: float


def _design(y, obs_ids, x):
    """Checked records: (y float64 [n_obs], 1-based obs_ids, x float64
    [n_obs, p]) with the reference's defaults (animals 1..n_obs, an
    intercept)."""
    y = np.asarray(y, np.float64).reshape(-1)
    n_obs = len(y)
    if obs_ids is None:
        obs_ids = np.arange(1, n_obs + 1)
    obs_ids = np.asarray(obs_ids, np.int64)
    if x is None:
        x = np.ones((n_obs, 1))
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    return y, obs_ids, x


def _mme_host(hinv, obs0, x, lam):
    """z [p + n, k] -> C(lam) z in numpy float64, every H^-1 apply on the
    device: the operator of a streamed panel's host outer CG."""
    n, p = hinv.n, x.shape[1]

    def mme(z):
        beta, u = z[:p], z[p:]
        fitted = x @ beta + u[obs0]
        bottom = np.zeros((n, z.shape[1]))
        np.add.at(bottom, obs0, fitted)
        hu = hinv.matvec(u).cpu().numpy().astype(np.float64)
        return np.concatenate([x.T @ fitted, bottom + lam * hu])

    return mme


def _mme_operator(hinv, obs, xj):
    """z [p + n, k] -> C(lam) z for the MME [[X'X, X'W], [W'X, W'W + lam
    H^-1]], and the Jacobi diagonal's parts (X'X's, W'W's and
    diag_approx), all float32 on the device."""
    n, p = hinv.n, xj.shape[1]

    def mme(z, lam):
        beta, u = z[:p], z[p:]
        fitted = xj @ beta + u[obs]
        bottom = fitted.new_zeros((n, z.shape[1])).index_add_(0, obs, fitted)
        return torch.cat([xj.T @ fitted, bottom + lam * hinv.matvec(u)])

    counts = torch.bincount(obs, minlength=n).to(torch.float32)
    return mme, torch.sum(xj * xj, dim=0), counts, hinv.diag_approx()


def ssgblup(
    y: np.ndarray,
    hinv: SingleStepHInv,
    obs_ids: Optional[np.ndarray] = None,
    x: Optional[np.ndarray] = None,
    h2: float = 0.5,
    tol: float = 1e-5,
    maxiter: int = 2000,
) -> SSGBLUPResult:
    """Solve Henderson's MME for y = X beta + W u + e with u over ALL
    pedigree animals and var(u) = sigma_u^2 H:

        [ X'X   X'W            ] [beta]   [X'y]
        [ W'X   W'W + lam H^-1 ] [ u  ] = [W'y],   lam = (1-h2)/h2

    ``obs_ids``: 1-based animal of each phenotype record (defaults to
    1..n_obs); repeated records per animal are allowed.  ``x``: fixed
    design [n_obs, p] (default intercept).  One outer Jacobi block-CG on
    the normalized RHS; every H^-1 application is the nested operator
    above.  On a streamed panel the outer CG is :func:`solve.cg.host_pcg` in
    numpy float64 (each H^-1 apply streams the chunks), as in the
    reference.
    """
    n = hinv.n
    y, obs_ids, x = _design(y, obs_ids, x)
    if obs_ids.min() < 1 or obs_ids.max() > n:
        raise ValueError("obs_ids must be 1-based pedigree ids")
    p = x.shape[1]
    lam = (1.0 - h2) / h2

    obs = torch.as_tensor(obs_ids - 1, device=hinv.device)
    xj = torch.as_tensor(x, dtype=torch.float32, device=hinv.device)
    yj = torch.as_tensor(y, dtype=torch.float32, device=hinv.device)
    mme, xdiag, counts, dapp = _mme_operator(hinv, obs, xj)
    rhs = torch.cat([xj.T @ yj, yj.new_zeros(n).index_add_(0, obs, yj)])
    minv = 1.0 / torch.cat([xdiag, counts + lam * dapp])

    if hinv._kind == "streamed":
        b = rhs.cpu().numpy().astype(np.float64)
        scale = float(np.linalg.norm(b))
        xs, iters, resid = host_pcg(
            _mme_host(hinv, obs_ids - 1, x, lam), b / scale, tol, maxiter,
            minv=minv.cpu().numpy().astype(np.float64))
        z = xs * scale
        return SSGBLUPResult(z[:p], z[p:], int(iters),
                             float(np.max(resid)) * scale)

    scale = float(torch.linalg.norm(rhs))
    res = cg(lambda z: mme(z, lam), rhs / scale, tol=tol, maxiter=maxiter,
             minv=minv)
    z = res.x.cpu().numpy().astype(np.float64) * scale
    return SSGBLUPResult(z[:p], z[p:], int(res.iterations),
                         float(torch.max(res.residual_norm)) * scale)


def _mme_solver(hinv: SingleStepHInv, obs, xj, tol: float, maxiter: int):
    """The MME solve C(lam) Z = RHS for a block RHS and a runtime lambda,
    columns normalized so the absolute CG tolerance acts relatively.
    Returns ``solve(lam, rhs) -> (Z, iterations)``, float32 on the
    device; on a streamed panel the host outer CG's float64 on the CPU."""
    mme, xdiag, counts, dapp = _mme_operator(hinv, obs, xj)

    if hinv._kind == "streamed":
        obs0 = obs.cpu().numpy()
        x = xj.cpu().numpy().astype(np.float64)
        parts = [t.cpu().numpy().astype(np.float64)
                 for t in (xdiag, counts, dapp)]

        def solve_host(lam, rhs):
            lam = float(lam)
            rhs = rhs.cpu().numpy().astype(np.float64)
            minv = 1.0 / np.concatenate([parts[0], parts[1] + lam * parts[2]])
            norm = np.linalg.norm(rhs, axis=0, keepdims=True)
            safe = np.where(norm > 0, norm, 1.0)
            xs, iters, _ = host_pcg(_mme_host(hinv, obs0, x, lam),
                                    rhs / safe, tol, maxiter, minv=minv)
            return torch.from_numpy(xs * safe), iters

        return solve_host

    def solve(lam, rhs):
        lam = float(lam)
        minv = 1.0 / torch.cat([xdiag, counts + lam * dapp])
        norm = torch.linalg.norm(rhs, dim=0, keepdim=True)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        r = cg(lambda z: mme(z, lam), rhs / safe, tol=tol, maxiter=maxiter,
               minv=minv)
        return r.x * safe, r.iterations

    return solve


def estimate_h2_reml_ss(
    y: np.ndarray,
    hinv: SingleStepHInv,
    obs_ids: Optional[np.ndarray] = None,
    x: Optional[np.ndarray] = None,
    n_probes: int = 8,
    probes: Optional[np.ndarray] = None,
    max_iter: int = 30,
    tol: float = 5e-4,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 3000,
    seed: int = 0,
    init_h2: float = 0.5,
    verbose: bool = False,
):
    """REML variance components for the single-step model: stochastic
    AI-REML on y = X beta + W u + e with var(u) = sigma_u^2 H, entirely
    from MME solves and H^-1 matvecs:

        P y           = e_hat / s2e           (MME residual)
        y'P V_u P y   = t' u_hat / s2u,  t = W' P y
        tr(P V_u)     = (q - lam * tr(C^uu H^-1)) / s2u
        tr(P)         = (n - p - q + lam * tr(C^uu H^-1)) / s2e

    with tr(C^uu H^-1) the one stochastic trace: Hutchinson probes [0; z]
    through the MME, dotted with H^-1 z (one matvec, reused across
    iterations).  The AI matrix is exact (one extra 2-column MME solve),
    with an EM step as fallback.  The solves run on the device in float32,
    the rest in numpy float64.

    ``probes=np.eye(q)`` makes the trace exact (small problems, tests).
    Returns ``(h2, details)`` as :func:`gblup.estimate_h2_reml`.
    """
    n = hinv.n
    q = n
    y, obs_ids, x = _design(y, obs_ids, x)
    n_obs = len(y)
    p = x.shape[1]
    yvar = float(y.var())
    yt = (y - y.mean()) / max(y.std(), 1e-12)

    if probes is None:
        rng = np.random.default_rng(seed)
        z = rng.choice((-1.0, 1.0), size=(q, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        n_probes = z.shape[1]
        exact_traces = (z.shape[1] == q and np.array_equal(z, np.eye(q)))

    obs = torch.as_tensor(obs_ids - 1, device=hinv.device)
    xj = torch.as_tensor(x, dtype=torch.float32, device=hinv.device)
    solve = _mme_solver(hinv, obs, xj, cg_tol, cg_maxiter)

    def host(t):
        return t.cpu().numpy().astype(np.float64)

    # H^-1 z: lambda-independent, one batched matvec for all iterations
    hz = host(hinv.matvec(z))

    wty = np.zeros(q)
    np.add.at(wty, obs_ids - 1, yt)
    rhs_y = np.concatenate([x.T @ yt, wty])
    rhs_z = np.concatenate([np.zeros((p, n_probes)), z], axis=0)
    block_a = torch.as_tensor(np.column_stack([rhs_y, rhs_z]),
                              dtype=torch.float32, device=hinv.device)

    s2u = float(np.clip(init_h2, 0.05, 0.95))
    s2e = 1.0 - s2u
    floor = 1e-6
    converged = False
    cg_total = 0
    ai = np.eye(2)
    for it in range(max_iter):
        lam = s2e / s2u
        sol, iters = solve(np.float32(lam), block_a)
        sol = host(sol)
        cg_total += int(iters)
        beta, u = sol[:p, 0], sol[p:, 0]
        su = sol[p:, 1:]                       # (C^-1 [0; z])_u
        if exact_traces:
            # z = I: hz = H^-1, su = C^uu, both symmetric ->
            # tr(H^-1 C^uu) = sum_ij (H^-1)_ij (C^uu)_ij
            tr_ch = float(np.sum(hz * su))
        else:
            tr_ch = float(np.mean(np.sum(hz * su, axis=0)))
        ehat = yt - x @ beta - u[obs_ids - 1]
        py = ehat / s2e
        wtpy = np.zeros(q)
        np.add.at(wtpy, obs_ids - 1, py)
        quad_u = float(wtpy @ u) / s2u
        quad_e = float(py @ py)
        tr_u = (q - lam * tr_ch) / s2u
        tr_e = (n_obs - p - q + lam * tr_ch) / s2e
        score = np.array([-0.5 * (tr_u - quad_u), -0.5 * (tr_e - quad_e)])

        r_u = u[obs_ids - 1] / s2u             # W u_hat / s2u = V_u P y
        r_e = py
        rhs_b = np.zeros((p + q, 2))
        rhs_b[:p, 0] = x.T @ r_u
        np.add.at(rhs_b[p:, 0], obs_ids - 1, r_u)
        rhs_b[:p, 1] = x.T @ r_e
        np.add.at(rhs_b[p:, 1], obs_ids - 1, r_e)
        solb, itb = solve(np.float32(lam), torch.as_tensor(
            rhs_b, dtype=torch.float32, device=hinv.device))
        solb = host(solb)
        cg_total += int(itb)
        pr = np.empty((n_obs, 2))
        for k, r in enumerate((r_u, r_e)):
            pr[:, k] = (r - x @ solb[:p, k]
                        - solb[p:, k][obs_ids - 1]) / s2e
        ai = 0.5 * np.array([
            [r_u @ pr[:, 0], r_u @ pr[:, 1]],
            [r_e @ pr[:, 0], r_e @ pr[:, 1]],
        ])
        ai = 0.5 * (ai + ai.T)

        theta = np.array([s2u, s2e])
        try:
            new = theta + np.linalg.solve(ai, score)
        except np.linalg.LinAlgError:
            new = np.array([np.nan, np.nan])
        if not np.all(np.isfinite(new)) or (new < floor).any() or \
                new.sum() > 10.0:
            # EM step: theta_i += theta_i^2 (quad_i - tr_i) / df_i
            new = theta + theta ** 2 * np.array(
                [(quad_u - tr_u) / q, (quad_e - tr_e) / n_obs])
            new = np.clip(new, floor, 10.0)
        step = float(np.abs(new - theta).max() / max(new.sum(), 1e-12))
        s2u, s2e = float(new[0]), float(new[1])
        if verbose:
            print(f"  ss-reml iter {it + 1}: s2u={s2u:.4f} s2e={s2e:.4f} "
                  f"score=({score[0]:+.3e},{score[1]:+.3e}) "
                  f"step={step:.2e}", flush=True)
        if step < tol:
            converged = True
            break

    h2 = s2u / (s2u + s2e)
    se_h2 = float("nan")
    try:
        cov_theta = np.linalg.inv(ai)
        grad = np.array([s2e, -s2u]) / (s2u + s2e) ** 2
        v = float(grad @ cov_theta @ grad)
        se_h2 = float(np.sqrt(v)) if v > 0 else float("nan")
    except np.linalg.LinAlgError:
        pass
    return float(h2), {
        "s2u": s2u, "s2e": s2e,
        "vu": s2u * yvar, "ve": s2e * yvar,
        "se_h2": se_h2, "iterations": it + 1, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces,
    }


def run_ssgblup(bed_path: str, pedigree_path: str,
                pheno_path: Optional[str] = None, out: str = "ebv.tsv",
                h2: float = 0.5, blend: float = 0.05, tau: float = 1.0,
                omega: float = 1.0, tol: float = 1e-5,
                inner_tol: float = 1e-6, no_inbreeding: bool = False,
                estimate_h2: bool = False, stream_chunk: int = 0,
                device=None) -> int:
    """Single-step evaluation from files.

    - ``bed_path``: PLINK fileset of the genotyped animals; the .fam
      within-family id (column 2) must match the pedigree labels.
    - ``pedigree_path``: animal/sire/dam per line, arbitrary labels
      (:func:`pedigree.read_pedigree`); genotyped animals absent from the
      file are appended as founders (warned).
    - ``pheno_path``: two-column file (animal label, value); phenotypes
      may cover any pedigree animal, genotyped or not.  Defaults to the
      .fam 6th column (genotyped animals only; -9 = missing).
    - ``stream_chunk`` > 0: ingest the panel as a :class:`StreamedGeno` in
      SNP chunks of that size: panels beyond the card's memory solve out of
      core (the host-driven outer CG).
    - ``device``: where the panel goes, or computes when streamed (the
      CUDA card unless named).

    Writes a TSV of EBVs for every pedigree animal.
    """
    sire, dam, labels = read_pedigree(pedigree_path)
    if stream_chunk > 0:
        g = StreamedGeno.from_bed(bed_path, chunk_snps=stream_chunk,
                                  device=device)
    else:
        g = from_bed(bed_path, device=device)
    with open(bed_path[:-4] + ".fam") as fh:
        fam = [ln.split() for ln in fh if ln.strip()]
    iids = [f[1] for f in fam]
    if len(iids) != g.indiv:
        raise SystemExit(f".fam has {len(iids)} animals, panel {g.indiv}")

    code = {lab: i + 1 for i, lab in enumerate(labels)}
    extra = [iid for iid in iids if iid not in code]
    if extra:
        print(f"warning: {len(extra)} genotyped animals missing from the "
              f"pedigree — appended as founders (e.g. {extra[:3]})")
        n0 = len(labels)
        labels = labels + extra
        sire = np.concatenate([sire, np.zeros(len(extra), np.int64)])
        dam = np.concatenate([dam, np.zeros(len(extra), np.int64)])
        code.update({lab: n0 + i + 1 for i, lab in enumerate(extra)})
    geno_ids = np.array([code[iid] for iid in iids], np.int64)

    if pheno_path:
        obs_l, y_l = [], []
        with open(pheno_path) as fh:
            for lineno, ln in enumerate(fh, 1):
                ln = ln.split("#", 1)[0].strip()
                if not ln:
                    continue
                parts = ln.split()
                if len(parts) < 2:
                    raise SystemExit(f"{pheno_path}:{lineno}: need "
                                     "'animal value' (got 1 token)")
                a, v = parts[:2]
                if a not in code:
                    raise SystemExit(f"{pheno_path}:{lineno}: animal {a!r} "
                                     "not in the pedigree")
                obs_l.append(code[a])
                try:
                    y_l.append(float(v))
                except ValueError:
                    raise SystemExit(f"{pheno_path}:{lineno}: non-numeric "
                                     f"phenotype {v!r}")
        obs_ids = np.array(obs_l, np.int64)
        y = np.array(y_l)
    else:
        y_all = np.array([f[5] for f in fam], np.float64)
        keep = y_all != -9
        if not keep.any():
            raise SystemExit("no phenotypes: .fam column 6 is all -9 and "
                             "no --pheno file given")
        obs_ids = geno_ids[keep]
        y = y_all[keep]
    print(f"{len(labels)} pedigree animals, {g.indiv} genotyped, "
          f"{len(y)} records")

    f = np.zeros(len(labels)) if no_inbreeding else None
    hinv = SingleStepHInv(sire, dam, g, geno_ids, blend=blend, tau=tau,
                          omega=omega, inner_tol=inner_tol, f=f)
    if estimate_h2:
        h2_hat, det = estimate_h2_reml_ss(y, hinv, obs_ids=obs_ids)
        print(f"ss-AI-REML h2 = {h2_hat:.3f} (SE {det['se_h2']:.3f}, "
              f"{det['iterations']} AI steps, converged="
              f"{det['converged']}; replacing --h2 {h2})")
        h2 = min(max(h2_hat, 0.01), 0.99)
    res = ssgblup(y, hinv, obs_ids=obs_ids, h2=h2, tol=tol)
    with open(out, "w") as fh:
        fh.write("animal\tebv\tgenotyped\n")
        gset = set(geno_ids.tolist())
        for i, lab in enumerate(labels):
            fh.write(f"{lab}\t{res.u[i]:.6g}\t{int(i + 1 in gset)}\n")
    print(f"wrote {out}: EBVs for {len(labels)} animals "
          f"(outer CG iterations: {res.iterations}, "
          f"residual {res.residual_norm:.2e})")
    print(f"fixed effects: {np.round(res.beta, 4)}")
    return 0
