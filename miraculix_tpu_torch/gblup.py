"""GBLUP pipeline: randomized GRM PCA -> BLUE/BLUP, and the variance
components that feed it.

Torch twin of ``miraculix_tpu.gblup`` on a :class:`GenoMatrix`, with the
reference's three solvers: block CG in f32 ("cg"), that CG inside float64
iterative refinement ("refined"), and a formed GRM with a Cholesky solve
("dense").  With lam = (1 - h2) / h2 and G VanRaden-scaled:

    beta_hat = (X^T (G + lam I)^-1 X)^-1 X^T (G + lam I)^-1 y     (BLUE)
    u        = (G + lam I)^-1 (y - X beta_hat)
    g_hat    = G u                                                (BLUP)

Outside "dense", G is never formed: every product with it is two packed
products.  The random draws (PCA test matrix, simulated phenotypes, trace
probes, fold permutations) are numpy's, seeded as in the reference, so
both packages see the same inputs.

The variance-component layer (Haseman-Elston, AI-REML, bivariate and
multi-trait REML), cross-validation, multi-trait GBLUP, GBLUP from a formed
GRM and the ``run_gblup`` pipeline keep the reference's split: every
product with G and every CG runs on the panel's device in f32, and the
glue around them (projections, traces, the average-information matrix and
its updates) stays numpy float64 on the host.

Every function takes a :class:`GenoMatrix` (a host-resident one gets one
device copy per call), an out-of-core :class:`StreamedGeno`, whose G
products stream its chunks and whose solves are its host float64 PCG, or a
sharded :class:`parallel.ShardedGeno` / :class:`parallel.ShardedGeno2D`,
whose G products and CGs run across the mesh (one or two psums an
iteration), as in the reference.  GBLUP on a streamed or sharded panel
takes ``solver="cg"`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .geno import GenoMatrix, _device, from_bed, on_compute
from .ops.dgemm import dgemm
from .ops.grm import grm
from .parallel import (ShardedGeno, ShardedGeno2D, host_global,
                       pad_indiv_vec, sharded_cg_solve, sharded_cg_solve_2d,
                       sharded_dgemm, sharded_dgemm_2d, sharded_grm_diag,
                       sharded_grm_diag_2d, sharded_grm_matvec)
from .parallel.sharded2d import grm_matvec_2d
from .solve.cg import (cg, grm_cg_solve, grm_cg_solve_refined, grm_diag,
                       grm_matvec, grm_matvec_f64, jacobi_minv)
from .solve.dense import dense_solve
from .streamed import StreamedGeno
from .utils.logging import span


CONTAINERS = (GenoMatrix, StreamedGeno, ShardedGeno, ShardedGeno2D)


def _check_container(g):
    """``g`` ready to compute on: a GenoMatrix with its words on its
    compute device (:func:`geno.on_compute`); a StreamedGeno, ShardedGeno
    or ShardedGeno2D as it is.  Anything else raises TypeError."""
    if isinstance(g, GenoMatrix):
        return on_compute(g)
    if isinstance(g, CONTAINERS):
        return g
    raise TypeError(
        f"{type(g).__name__} is not a genotype container: pass a "
        + ", ".join(c.__name__ for c in CONTAINERS))


def _grm_matvec_of(g):
    """G v operator (torch f32 in and out, on the panel's compute device,
    replicated on every process of a mesh): two packed products, one
    streamed pass over the chunks, or the sharded operator."""
    g = _check_container(g)
    if isinstance(g, StreamedGeno):
        return g.grm_matvec
    if isinstance(g, ShardedGeno):
        return lambda v: sharded_grm_matvec(g, v)
    if isinstance(g, ShardedGeno2D):
        return lambda v: grm_matvec_2d(g, v)
    return lambda v: grm_matvec(g, v)


def _grm_diag_of(g) -> np.ndarray:
    """Exact diag(Z_c Z_c^T) as numpy float64."""
    g = _check_container(g)
    if isinstance(g, StreamedGeno):
        return g.grm_diag(center=True)
    if isinstance(g, ShardedGeno):
        d = host_global(sharded_grm_diag(g))
    elif isinstance(g, ShardedGeno2D):
        d = host_global(sharded_grm_diag_2d(g))[: g.indiv]
    else:
        d = grm_diag(g, center=True, scale=False).cpu().numpy()
    return d.astype(np.float64)


def _scaled_matvec_of(g):
    """G_s W for numpy [n, m] blocks: float64 in, one f32 device matvec,
    float64 out divided by sigma2 (the REML machinery's building block).
    A streamed panel first caches what fits on the device
    (``cache_to_device``, idempotent): every pass over a streamed chunk
    copies it again."""
    g = _check_container(g)
    if isinstance(g, StreamedGeno):
        g.cache_to_device()
    raw = _grm_matvec_of(g)
    sigma2 = float(g.sigma2)
    return lambda w: raw(torch.as_tensor(
        w, dtype=torch.float32, device=g.device)).cpu().numpy().astype(
        np.float64) / sigma2


def randomized_grm_pca(g, k: int = 10, oversample: int = 8,
                       power_iters: int = 2,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k eigenpairs of the (unscaled, centered) GRM by the Halko
    randomized range finder, G applied as Z_c (Z_c^T .).  Returns
    (eigenvalues [k], eigenvectors [indiv, k]) as numpy arrays."""
    g = _check_container(g)
    matvec = _grm_matvec_of(g)
    rng = np.random.default_rng(seed)
    omega = torch.as_tensor(rng.standard_normal((g.indiv, k + oversample)),
                            dtype=torch.float32, device=g.device)
    y = matvec(omega)
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(y)
        y = matvec(q)
    q, _ = torch.linalg.qr(y)
    t = q.T @ matvec(q)
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


def gblup(g, y: np.ndarray, h2: float = 0.5, n_pcs: int = 10,
          covariates: Optional[np.ndarray] = None, solver: str = "cg",
          tol: float = 1e-4, maxiter: int = 2000,
          seed: int = 0, verbose: bool = False) -> GBLUPResult:
    """Full GBLUP estimation (reference ``gblup`` semantics).

    ``solver``: "cg" (f32 block CG on the device; ``tol`` bounds each
    column's residual norm of the unscaled system (Z_c Z_c^T + lam sigma2 I)
    b' = rhs), "refined" (float64-grade solves by iterative refinement,
    ``tol`` the relative f64 residual, e.g. 1e-10; g_hat by the f64
    matvec), or "dense" (the scaled GRM formed by :func:`grm` and solved by
    Cholesky in f32).  A :class:`StreamedGeno` takes "cg" only, solved
    by its host float64 PCG (``tol`` relative there, as in the reference;
    ``verbose`` prints its iterations, and nothing on a ``GenoMatrix``); a
    ShardedGeno / ShardedGeno2D takes "cg" only, each solve one CG across
    the mesh."""
    with span("gblup"):
        if solver not in ("cg", "refined", "dense"):
            raise ValueError(
                f"solver must be cg/refined/dense, got {solver!r}")
        g = _check_container(g)
        streamed = isinstance(g, StreamedGeno)
        if not isinstance(g, GenoMatrix) and solver != "cg":
            raise ValueError(
                "sharded/streamed GBLUP supports solver='cg' only")
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
            """(Z_c Z_c^T + lam sigma2 I) b' = rhs; returns
            (sigma2 b', iters)."""
            nonlocal converged
            if streamed:
                xs, iters, rel = g.cg_solve(rhs, lam=lam * sigma2, scale=False,
                                            tol=tol, maxiter=maxiter,
                                            verbose=verbose)
                converged &= bool(np.all(rel <= tol))
                return xs * sigma2, iters
            if solver == "refined":
                xs, _, inner, rel = grm_cg_solve_refined(
                    g, rhs, lam=lam * sigma2, scale=False, tol=tol,
                    inner_maxiter=maxiter)
                converged &= bool(rel.max() <= tol)
                return xs * sigma2, inner
            if isinstance(g, ShardedGeno):
                res = sharded_cg_solve(g, rhs, lam=lam * sigma2, tol=tol,
                                       maxiter=maxiter)
            elif isinstance(g, ShardedGeno2D):
                res = sharded_cg_solve_2d(g, rhs, lam=lam * sigma2, tol=tol,
                                          maxiter=maxiter)
            else:
                res = grm_cg_solve(g, rhs, lam=lam * sigma2, scale=False,
                                   tol=tol, maxiter=maxiter)
            converged &= bool(torch.all(res.residual_norm <= tol))
            return (host_global(res.x)[:n].astype(np.float64) * sigma2,
                    res.iterations)

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
            with span("gblup.solve"):
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
            with span("gblup.solve"):
                u, it_u = _cg((y - x @ beta)[:, None])
            u = u[:, 0]
            iters += it_u
            if solver == "refined":
                g_hat = grm_matvec_f64(g, u[:, None])[:, 0] / sigma2
            else:
                g_hat = _grm_matvec_of(g)(torch.as_tensor(
                    u[:, None], dtype=torch.float32, device=g.device))
                g_hat = g_hat.cpu().numpy().astype(np.float64)[:, 0] / sigma2
        return GBLUPResult(beta=beta, g_hat=g_hat, fitted=x @ beta + g_hat,
                           pcs=pcs, cg_iterations=iters, u=u,
                           converged=converged)


def snp_effects(g, res: GBLUPResult) -> np.ndarray:
    """Per-SNP marker effects alpha = Z_c^T u / sigma2 (g_hat = Z_c alpha):
    one packed 't' pass, streamed on a :class:`StreamedGeno`, row-sharded
    on a sharded panel."""
    g = _check_container(g)
    if res.u is None:
        raise ValueError("GBLUPResult has no random-effect solutions")
    u = res.u[:, None].astype(np.float32)
    if isinstance(g, StreamedGeno):
        a = g.dgemm(u, trans="t", center=True).astype(np.float64)
    elif isinstance(g, ShardedGeno):
        a = host_global(sharded_dgemm(g, u, trans="t")).astype(np.float64)
    elif isinstance(g, ShardedGeno2D):
        a = host_global(sharded_dgemm_2d(g, pad_indiv_vec(g, u), trans="t")
                        )[: g.snps].astype(np.float64)
    else:
        a = dgemm(g, u, trans="t", center=True).cpu().numpy().astype(
            np.float64)
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


def run_gblup(bed_path: str, h2: float = 0.5, pcs: int = 10,
              solver: str = "cg", stream_chunk: int = 0,
              tol: float = 1e-4, verbose: bool = False,
              estimate_h2: bool = False, h2_method: str = "he",
              maxiter: int = 2000, effects_out: Optional[str] = None,
              device=None) -> int:
    """The whole pipeline on a .bed fileset: phenotypes from the .fam's 6th
    column when present, else simulated with known breeding values;
    optionally h2 by HE or AI-REML first, and the marker effects written
    to ``effects_out``.  The panel goes to ``device`` (the CUDA card unless
    named).  ``stream_chunk`` > 0 reads it as the out-of-core
    :class:`StreamedGeno` in SNP chunks of that size, host-resident with
    ``device`` its compute device, and caches on the device what fits."""
    from .io import bed as bedio
    from .io import codec

    if stream_chunk > 0:
        g = StreamedGeno.from_bed(bed_path, chunk_snps=stream_chunk,
                                  verbose=True, device=device)
        cached = g.cache_to_device()
        print(f"streamed panel: {g.snps} snps x {g.indiv} indiv, "
              f"{g.n_chunks} chunks, {g.nbytes() / 1e9:.1f} GB packed "
              f"({cached} chunks pinned in HBM, rest host-streamed)")
    else:
        g = from_bed(bed_path, device=device)
    # phenotype = 6th whitespace column of each .fam line (parsed per line,
    # so extra columns or odd spacing cannot shift the stride)
    with open(bed_path[:-4] + ".fam") as fh:
        pheno_col = [ln.split()[5] for ln in fh if ln.strip()]
    bv_true = None
    # parsed per value: one bad token stops the run instead of flipping it
    # to simulated phenotypes, and the string 'nan' cannot pass as a value
    y = np.full(len(pheno_col), np.nan)
    for k, sv in enumerate(pheno_col):
        if sv.upper() in ("NA", "NAN", ".", "-9"):
            continue                       # missing codes -> NaN
        try:
            y[k] = float(sv)
        except ValueError:
            raise SystemExit(
                f".fam line {k + 1}: unparseable phenotype {sv!r} "
                "(numeric, or NA/./-9 for missing)")
    y[y == -9.0] = np.nan                  # "-9.0" parses numerically
    n_miss = int(np.isnan(y).sum())
    if 0 < n_miss < len(y):
        raise SystemExit(
            f"{n_miss} individuals have missing phenotype (-9/NA) in the "
            ".fam; subset the panel to phenotyped individuals before "
            "running GBLUP")
    if n_miss == len(y):                   # no phenotypes at all: simulate
        if stream_chunk > 0:
            # out of core: QTLs from the first SNP window only, never the
            # whole panel decoded
            plink, _, _ = bedio.read_bed_slice(bed_path, 0,
                                               min(1024, g.snps))
            geno = codec.plink_to_dense(plink, g.indiv)
        else:
            geno, _ = bedio.read_bed_genotypes(bed_path)
        y, bv_true = simulate_phenotypes(geno, h2=h2)
        del geno
        print("(.fam has no phenotypes — simulated with known BVs)")

    if estimate_h2:
        if h2_method == "reml":
            h2_hat, det = estimate_h2_reml(g, y, verbose=verbose)
            print(f"AI-REML h2 = {h2_hat:.3f} (SE {det['se_h2']:.3f}, "
                  f"{det['iterations']} AI steps, converged="
                  f"{det['converged']}; replacing --h2 {h2})")
        else:
            h2_hat, _ = estimate_h2_he(g, y)
            print(f"HE-estimated h2 = {h2_hat:.3f} (replacing --h2 {h2})")
        h2 = min(max(h2_hat, 0.01), 0.99)

    res = gblup(g, y, h2=h2, n_pcs=pcs, solver=solver, tol=tol,
                maxiter=maxiter, verbose=verbose or stream_chunk > 0)
    print(f"beta: {np.round(res.beta[:3], 4)}... "
          f"(CG iterations: {res.cg_iterations})")
    if bv_true is not None:
        cor = np.corrcoef(res.g_hat, bv_true)[0, 1]
        print(f"cor(estimated BV, true BV) = {cor:.3f}")
    cor_fit = np.corrcoef(res.fitted, y)[0, 1]
    print(f"cor(fitted, phenotype)     = {cor_fit:.3f}")
    if effects_out:
        # SNP id and effect allele from the .bim, the backsolved dosage
        # effect and the training allele frequency.  Dosage counts copies
        # of A2 (0b00, hom A1, decodes to 0), so the effect allele is the
        # .bim's 6th column, as plink --score needs it.
        alpha = snp_effects(g, res)
        freq = np.asarray(g.freq if stream_chunk > 0 else g.freq.cpu(),
                          np.float64)
        bim = bedio.read_bim(bed_path)
        if len(bim) != len(alpha):
            raise SystemExit(f".bim has {len(bim)} SNPs but the panel has "
                             f"{len(alpha)} — fileset out of sync")
        with open(effects_out, "w") as fh:
            fh.write("snp\tallele\teffect\tfreq_train\n")
            for row, a, f in zip(bim, alpha, freq):
                fh.write(f"{row[1]}\t{row[5]}\t{a:.10g}\t{f:.10g}\n")
        print(f"wrote {effects_out}: {len(alpha)} marker effects "
              "(score new panels with `cli score`)")
    return 0


def cross_validate(g, y: np.ndarray, h2: float = 0.5, k: int = 5,
                   tol: float = 1e-5, maxiter: int = 2000, seed: int = 0):
    """K-fold cross-validated prediction accuracy, one CG per fold on a
    masked operator that never slices G:

        op(v) = m (G (m v)) / sigma2 + lam m v + (1 - m) v

    (m the training mask; SPD, the held-out rows decoupled), then
    yhat_test = (G u) / sigma2 on the test rows.  Phenotypes are centered
    by each fold's training mean.  ``tol`` bounds each CG's absolute
    residual norm.  Returns ``(per_fold_correlations, mean_correlation)``.
    """
    g = _check_container(g)
    matvec = _grm_matvec_of(g)
    n = g.indiv
    lam = (1.0 - h2) / h2
    y = np.asarray(y, np.float64).reshape(n)
    rng = np.random.default_rng(seed)
    folds = np.array_split(rng.permutation(n), k)
    sigma2 = float(g.sigma2)
    cors = []
    for test_idx in folds:
        mask = np.ones(n, np.float32)
        mask[test_idx] = 0.0
        mj = torch.as_tensor(mask[:, None], device=g.device)
        ybar = y[mask.astype(bool)].mean()
        b = torch.as_tensor(((y - ybar) * mask)[:, None],
                            dtype=torch.float32, device=g.device)

        def op(v, mj=mj):
            gv = matvec(mj * v) / sigma2
            return mj * gv + lam * (mj * v) + (1.0 - mj) * v

        u = cg(op, b, tol=tol, maxiter=maxiter).x
        pred = matvec(u).cpu().numpy().astype(np.float64)[:, 0]
        yhat = pred[test_idx] / sigma2 + ybar
        cors.append(float(np.corrcoef(yhat, y[test_idx])[0, 1]))
    return np.asarray(cors), float(np.mean(cors))


def _ridge_solver(g, tol: float, maxiter: int):
    """``solve(rhs, lam) -> (x float64, iterations)``: (Z_c Z_c^T + lam I)
    x = rhs for a numpy block by Jacobi-preconditioned CG on the device
    (a streamed panel's host PCG, a sharded panel's CG across the mesh),
    ``lam`` taken at run time."""
    g = _check_container(g)

    if isinstance(g, StreamedGeno):
        def solve(rhs, lam):
            x, iters, _ = g.cg_solve(rhs, lam=float(lam), scale=False,
                                     tol=tol, maxiter=maxiter,
                                     precondition=True)
            return np.asarray(x, np.float64), int(iters)
        return solve
    cg_solve = (sharded_cg_solve if isinstance(g, ShardedGeno)
                else sharded_cg_solve_2d if isinstance(g, ShardedGeno2D)
                else None)

    def solve(rhs, lam):
        if cg_solve is None:
            r = grm_cg_solve(g, rhs, lam=lam, scale=False, tol=tol,
                             maxiter=maxiter, precondition=True)
        else:
            r = cg_solve(g, rhs, lam=float(lam), tol=tol, maxiter=maxiter,
                         precondition=True)
        x = host_global(r.x)[: g.indiv]
        return x.astype(np.float64), int(r.iterations)

    return solve


def estimate_h2_reml(g, y: np.ndarray,
                     covariates: Optional[np.ndarray] = None,
                     n_probes: int = 16, probes: Optional[np.ndarray] = None,
                     max_iter: int = 30, tol: float = 5e-4,
                     cg_tol: float = 1e-5, cg_maxiter: int = 2000,
                     seed: int = 0, init_h2: Optional[float] = None,
                     verbose: bool = False):
    """REML variance components by stochastic AI-REML (the GCTA ``--reml``
    role), from matvecs only: G is never formed.

    Model: y = X beta + u + e, u ~ N(0, s2g G_s), e ~ N(0, s2e I).  Since
    V = (s2g / sigma2) (Z_c Z_c^T + lam I) with lam = s2e sigma2 / s2g,
    every V^-1 is one ridge block CG.  tr(P) and tr(P G_s) are Hutchinson
    estimates over ``n_probes`` Rademacher probes shared by every iteration
    (``probes=np.eye(n)`` gives exact traces); the update is the
    average-information step theta += AI^-1 score, with an EM step where
    AI leaves the bounds.  Per iteration: one block CG of p + 1 + n_probes
    columns, one of 2, and one G_s matvec.  ``init_h2`` defaults to the
    Haseman-Elston estimate.

    Returns ``(h2, details)``: ``s2g``/``s2e`` on the standardized-y scale,
    ``vg``/``ve`` on y's scale, the delta-method ``se_h2``, the AI steps
    (``iterations``), ``converged`` and the CG total.
    """
    g = _check_container(g)
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    yvar = float(y.var())
    yt = (y - y.mean()) / max(y.std(), 1e-12)
    sigma2 = float(g.sigma2)

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    if probes is None:
        rng = np.random.default_rng(seed)
        z = rng.choice((-1.0, 1.0), size=(n, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        if z.shape[0] != n:
            raise ValueError(f"probes have {z.shape[0]} rows, expected {n}")
        n_probes = z.shape[1]
        # identity probes = exact traces (tr A = sum of diag(A I))
        exact_traces = z.shape[1] == n and np.array_equal(z, np.eye(n))

    gs_mv = _scaled_matvec_of(g)
    solve = _ridge_solver(g, cg_tol, cg_maxiter)

    if init_h2 is None:
        init_h2, _ = estimate_h2_he(g, y, seed=seed)
        if not np.isfinite(init_h2):
            init_h2 = 0.5
    s2g = float(np.clip(init_h2, 0.05, 0.95))
    s2e = 1.0 - s2g
    floor = 1e-6

    gz = gs_mv(z)                       # G_s probes, reused every iteration
    cg_total = 0
    converged = False
    ai = np.eye(2)
    for it in range(max_iter):
        lam = s2e * sigma2 / s2g
        sol, iters = solve(np.concatenate([x, yt[:, None], z], axis=1), lam)
        cg_total += iters
        sol *= sigma2 / s2g             # (Z Z^T + lam I)^-1 -> V^-1
        vinv_x, vinv_y, vinv_z = sol[:, :p], sol[:, p], sol[:, p + 1:]

        xtvx = x.T @ vinv_x
        c = np.linalg.inv(0.5 * (xtvx + xtvx.T))

        def proj(vinv_w):
            return vinv_w - vinv_x @ (c @ (x.T @ vinv_w))

        py = proj(vinv_y[:, None])[:, 0]
        pz = proj(vinv_z)

        gspy = gs_mv(py[:, None])[:, 0]
        ypgpy = float(py @ gspy)
        yppy = float(py @ py)
        if exact_traces:
            # pz = P, gz = G_s: tr(P G_s) = sum_ij P_ij (G_s)_ij
            tr_pg = float((pz * gz).sum())
            tr_p = float(np.trace(pz))
        else:
            tr_pg = float(np.mean(np.sum(pz * gz, axis=0)))
            tr_p = float(np.mean(np.sum(z * pz, axis=0)))

        score = np.array([-0.5 * (tr_pg - ypgpy), -0.5 * (tr_p - yppy)])

        sol2, iters2 = solve(np.stack([gspy, py], axis=1), lam)
        cg_total += iters2
        sol2 *= sigma2 / s2g
        pw = proj(sol2)                 # [P G_s P y, P P y]
        ai = 0.5 * np.array([
            [gspy @ pw[:, 0], gspy @ pw[:, 1]],
            [py @ pw[:, 0], py @ pw[:, 1]],
        ])
        ai = 0.5 * (ai + ai.T)

        theta = np.array([s2g, s2e])
        try:
            new = theta + np.linalg.solve(ai, score)
        except np.linalg.LinAlgError:
            new = np.array([np.nan, np.nan])
        if not np.all(np.isfinite(new)) or (new < floor).any() or \
                new.sum() > 10.0:
            # EM: theta_i += theta_i^2 (y'P V_i P y - tr(P V_i)) / n
            quad = np.array([ypgpy, yppy])
            tr = np.array([tr_pg, tr_p])
            new = np.clip(theta + theta ** 2 * (quad - tr) / n, floor, 10.0)
        step = float(np.abs(new - theta).max() / max(new.sum(), 1e-12))
        s2g, s2e = float(new[0]), float(new[1])
        if verbose:
            print(f"  reml iter {it + 1}: s2g={s2g:.4f} s2e={s2e:.4f} "
                  f"score=({score[0]:+.3e},{score[1]:+.3e}) step={step:.2e}",
                  flush=True)
        if step < tol:
            converged = True
            break

    h2 = s2g / (s2g + s2e)
    se_h2 = float("nan")
    try:
        cov_theta = np.linalg.inv(ai)
        grad = np.array([s2e, -s2g]) / (s2g + s2e) ** 2
        v = float(grad @ cov_theta @ grad)
        se_h2 = float(np.sqrt(v)) if v > 0 else float("nan")
    except np.linalg.LinAlgError:
        pass
    return float(h2), {
        "s2g": s2g, "s2e": s2e,
        "vg": s2g * yvar, "ve": s2e * yvar,
        "se_h2": se_h2, "iterations": it + 1, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces,
    }


def estimate_h2_he(g, y: np.ndarray, n_probes: int = 16,
                   seed: int = 0):
    """Haseman-Elston regression estimate of SNP heritability, G never
    formed:

        h2 = (y~' G y~ - sum_i G_ii y~_i^2) / (tr(G^2) - sum_i G_ii^2)

    with y~ standardized, y~' G y~ one device matvec, the diagonal the exact
    ``grm_diag``, and tr(G^2) a Hutchinson estimate (mean of |G z|^2 over
    ``n_probes`` Rademacher probes, one block).  Returns
    ``(h2_hat clipped to [0, 1], details)``.
    """
    g = _check_container(g)
    n = g.indiv
    y = np.asarray(y, np.float64).reshape(n)
    yt = (y - y.mean()) / max(y.std(), 1e-12)
    sigma2 = float(g.sigma2)

    diag = _grm_diag_of(g) / sigma2
    mv = _scaled_matvec_of(g)

    gy = mv(yt[:, None])[:, 0]
    num = float(yt @ gy - (diag * yt * yt).sum())

    rng = np.random.default_rng(seed)
    gz = mv(rng.choice((-1.0, 1.0), size=(n, n_probes)))
    tr_g2 = float(np.mean(np.sum(gz * gz, axis=0)))
    den = tr_g2 - float((diag * diag).sum())
    h2 = num / den if den > 0 else float("nan")
    return float(np.clip(h2, 0.0, 1.0)), {
        "numerator": num, "trace_g2_estimate": tr_g2,
        "diag_sq_sum": float((diag * diag).sum()), "n_probes": n_probes,
    }


def _multi_v_solver(g, t: int, dG: np.ndarray, cg_tol: float,
                    cg_maxiter: int):
    """Device block CG for V = (Sg x G_s) + (Se x I) over trait pages
    [n, t, m], the inner solve of :func:`estimate_multi_reml`.  One
    operator application is one batched G pass over the t m flattened
    columns plus two [t, t] mixes; Jacobi from diag(V) = diag(G_s) diag(Sg)
    + diag(Se).  Each RHS column is scaled to unit norm, so the generic
    CG's absolute ``cg_tol`` reads as the relative one of the host loop.

    Returns ``solve(b3 [n, t, m] float64, sg, se) -> (x3 float64,
    iterations)``.  A :class:`StreamedGeno` takes
    :func:`_multi_v_solver_streamed`; a ShardedGeno or ShardedGeno2D (the
    reference's kinds "sharded" and "sharded2d") runs the same CG on its
    sharded G operator (:func:`_grm_matvec_of`), its vectors replicated
    on every process."""
    g = _check_container(g)
    if isinstance(g, StreamedGeno):
        return _multi_v_solver_streamed(g, t, dG, cg_tol, cg_maxiter)
    return _multi_v_cg(_grm_matvec_of(g), g, t, dG, cg_tol, cg_maxiter)


def _multi_v_cg(raw, g, t: int, dG: np.ndarray, cg_tol: float,
                cg_maxiter: int):
    """The body of :func:`_multi_v_solver` on the G operator ``raw``: one
    device CG a solve, every vector on ``g``'s compute device."""
    n = g.indiv
    sigma2 = float(g.sigma2)
    dev = g.device
    dgj = torch.as_tensor(np.array(dG, np.float32), device=dev)

    def solve(b3, sg, se):
        m = int(b3.shape[2])
        sgj = torch.as_tensor(sg, dtype=torch.float32, device=dev)
        sej = torch.as_tensor(se, dtype=torch.float32, device=dev)

        def op(v):                                # v [n t, m], vec(n, t)
            pages = v.reshape(n, t, m)
            flat = pages.permute(0, 2, 1).reshape(n, t * m)
            gw = (raw(flat) / sigma2).reshape(n, m, t).permute(0, 2, 1)
            out = (torch.einsum("ab,nbm->nam", sgj, gw)
                   + torch.einsum("ab,nbm->nam", sej, pages))
            return out.reshape(n * t, m)

        d = dgj[:, None] * torch.diagonal(sgj)[None, :] \
            + torch.diagonal(sej)[None, :]        # [n, t]
        minv = 1.0 / torch.clamp(d, min=1e-12)
        b = torch.as_tensor(b3, dtype=torch.float32,
                            device=dev).reshape(n * t, m)
        norm = torch.linalg.norm(b, dim=0, keepdim=True)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        r = cg(op, b / safe, tol=cg_tol, maxiter=cg_maxiter,
               minv=minv.reshape(n * t))
        x3 = (r.x * safe).reshape(n, t, m)
        return x3.cpu().numpy().astype(np.float64), int(r.iterations)

    return solve


def _multi_v_solver_streamed(g: StreamedGeno, t: int, dG: np.ndarray,
                             cg_tol: float, cg_maxiter: int):
    """The V-solve on a streamed panel: :func:`_multi_v_cg` on the
    container's ``grm_matvec``, after ``cache_to_device`` has cached what
    fits.  Its vectors stay on the device in both of the reference's
    regimes; with every chunk cached no pass copies, and where chunks
    overflow each pass streams them, with one host read of the stop test
    an iteration."""
    g.cache_to_device()
    return _multi_v_cg(g.grm_matvec, g, t, dG, cg_tol, cg_maxiter)


def estimate_multi_reml(g, ys: np.ndarray, covariates=None,
                        n_probes: int = 8, probes=None, max_iter: int = 40,
                        tol: float = 5e-4, cg_tol: float = 1e-5,
                        cg_maxiter: int = 2000, seed: int = 0,
                        verbose: bool = False, device_cg: bool = True):
    """Multivariate (t-trait) REML on the implicit Kronecker operator,
    G never formed.  Model (traits standardized internally):

        vec(Y) = X beta + u + e,  u ~ N(0, Sg x G_s),  e ~ N(0, Se x I)

    with Sg, Se the t x t genetic and residual covariances: t (t + 1)
    components.  V W for W [n, t, m] is G_s W Sg^T + W Se^T, one batched
    packed matvec over [n, t m] columns.  As :func:`estimate_h2_reml`:
    Hutchinson traces with shared probes (``probes=np.eye(t n)``, vec order
    trait-major per individual, gives exact traces), exact AI quadratic
    forms, AI^-1 score steps halved into the PSD cone (eigenvalue-clipped
    projection as the last resort).

    ``device_cg=True`` runs every inner V^-1 as one block CG on the
    device (:func:`_multi_v_solver`); ``False`` runs the host float64 loop,
    the oracle of the device path.  On a :class:`StreamedGeno` the device
    path is :func:`_multi_v_solver_streamed`.

    Returns ``(Sg, Se, details)``: per-trait ``h2``, genetic correlations
    ``rg`` [t, t], delta-method SEs, AI steps, ``converged`` and the CG
    total.
    """
    g = _check_container(g)
    n = g.indiv
    ys = np.asarray(ys, np.float64)
    if ys.ndim != 2 or ys.shape[0] != n:
        raise ValueError(f"ys must be [n_indiv, n_traits]; got {ys.shape}")
    t = ys.shape[1]
    if t < 2:
        raise ValueError("need >= 2 traits (univariate: estimate_h2_reml)")
    if not np.isfinite(ys).all():
        raise ValueError("estimate_multi_reml needs complete records on "
                         "every trait (no NaN)")
    yt = (ys - ys.mean(axis=0)) / np.maximum(ys.std(axis=0), 1e-12)

    gs_mv = _scaled_matvec_of(g)
    dG = _grm_diag_of(g) / float(g.sigma2)   # exact diag(G_s), for Jacobi

    # components: (kind, a, b) for kind in (g, e), pairs a <= b row-major
    pairs = [(a, b) for a in range(t) for b in range(a, t)]
    ncomp = 2 * len(pairs)

    # fixed effects: a per-trait intercept (+ shared covariate columns)
    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    xc = np.concatenate(cols, axis=1)
    p = xc.shape[1]
    x3 = np.zeros((n, t, t * p))
    for a in range(t):
        x3[:, a, a * p:(a + 1) * p] = xc

    if probes is None:
        rng = np.random.default_rng(seed)
        z3 = rng.choice((-1.0, 1.0), size=(n, t, n_probes))
        exact_traces = False
    else:
        z = np.asarray(probes, np.float64)
        if z.shape[0] != t * n:
            raise ValueError(f"probes must have {t * n} rows (vec order: "
                             "trait-major per individual)")
        n_probes = z.shape[1]
        z3 = z.reshape(n, t, n_probes)
        exact_traces = (n_probes == t * n and np.array_equal(z, np.eye(t * n)))

    def batched_g(w3):
        """G_s over every trait slice: [n, t, m] -> [n, t, m], one pass."""
        m = w3.shape[2]
        flat = w3.transpose(0, 2, 1).reshape(n, t * m)
        gflat = gs_mv(np.ascontiguousarray(flat))
        return gflat.reshape(n, m, t).transpose(0, 2, 1)

    def v_op(w3, sg, se):
        gw = batched_g(w3)
        return (np.einsum("ab,nbm->nam", sg, gw)
                + np.einsum("ab,nbm->nam", se, w3))

    def v_solve_host(b3, sg, se):
        """Host float64 Jacobi block CG: stops when every column has
        |r| / |b| < cg_tol, tested after the update."""
        d = (np.outer(dG, np.diag(sg)) + np.diag(se)[None, :])  # [n, t]
        minv = (1.0 / np.maximum(d, 1e-12))[:, :, None]
        x = np.zeros_like(b3)
        r = b3.copy()
        zv = minv * r
        pv = zv.copy()
        rz = np.einsum("ntm,ntm->m", r, zv)
        bnorm = np.sqrt(np.einsum("ntm,ntm->m", b3, b3))
        bnorm[bnorm == 0] = 1.0
        it = 0
        for it in range(1, cg_maxiter + 1):
            vp = v_op(pv, sg, se)
            pvp = np.einsum("ntm,ntm->m", pv, vp)
            alpha = np.where(pvp > 0, rz / np.maximum(pvp, 1e-300), 0.0)
            x += alpha[None, None, :] * pv
            r -= alpha[None, None, :] * vp
            rn = np.sqrt(np.einsum("ntm,ntm->m", r, r))
            if (rn / bnorm < cg_tol).all():
                break
            znew = minv * r
            rz_new = np.einsum("ntm,ntm->m", r, znew)
            beta = np.where(rz > 0, rz_new / np.maximum(rz, 1e-300), 0.0)
            pv = znew + beta[None, None, :] * pv
            rz = rz_new
        return x, it

    v_solve = (_multi_v_solver(g, t, dG, cg_tol, cg_maxiter) if device_cg
               else v_solve_host)

    def vi_apply(w3, gw=None):
        """[V_i w] for every component, order: g-pairs then e-pairs."""
        if gw is None:
            gw = batched_g(w3)
        out = []
        for src in (gw, w3):
            for a, b in pairs:
                o = np.zeros_like(w3)
                o[:, a, :] += src[:, b, :]
                if a != b:
                    o[:, b, :] += src[:, a, :]
                out.append(o)
        return out

    # start: per-trait HE diagonals and cross-trait HE covariances
    rngd = np.random.default_rng(seed)
    zh = rngd.choice((-1.0, 1.0), size=(n, max(n_probes, 8)))
    gzh = gs_mv(zh)
    den = float(np.mean(np.sum(gzh * gzh, axis=0)) - (dG * dG).sum())
    gy = gs_mv(yt)                                    # G_s Y, one pass
    sg0 = np.empty((t, t))
    for a in range(t):
        for b in range(a, t):
            num = float(yt[:, a] @ gy[:, b] - (dG * yt[:, a] * yt[:, b]).sum())
            sg0[a, b] = sg0[b, a] = num / den if den > 0 else (0.5 if a == b
                                                               else 0.0)
    sg = _project_psd(sg0, floor=0.05, cap=0.95)
    se = _project_psd(np.corrcoef(yt.T) - sg, floor=0.05, cap=None)

    theta = np.concatenate([[sg[a, b] for a, b in pairs],
                            [se[a, b] for a, b in pairs]])

    def unpack(th):
        sgm = np.zeros((t, t))
        sem = np.zeros((t, t))
        for k, (a, b) in enumerate(pairs):
            sgm[a, b] = sgm[b, a] = th[k]
            sem[a, b] = sem[b, a] = th[len(pairs) + k]
        return sgm, sem

    floor = 1e-6

    def valid(th):
        if not np.all(np.isfinite(th)):
            return False
        sgm, sem = unpack(th)
        return (np.diag(sgm).max() + np.diag(sem).max() < 10.0
                and np.linalg.eigvalsh(sgm)[0] >= -1e-9
                and np.linalg.eigvalsh(sem)[0] >= floor / 2)

    y3 = yt.reshape(n, t, 1)
    gz3 = None
    cg_total = 0
    converged = False
    ai = np.eye(ncomp)
    it_outer = 0
    for it_outer in range(1, max_iter + 1):
        sg, se = unpack(theta)
        sol, iters = v_solve(np.concatenate([x3, y3, z3], axis=2), sg, se)
        cg_total += iters
        vinv_x = sol[:, :, : t * p]
        vinv_y = sol[:, :, t * p: t * p + 1]
        vinv_z = sol[:, :, t * p + 1:]

        xtvx = np.einsum("ntp,ntq->pq", x3, vinv_x)
        cmat = np.linalg.inv(0.5 * (xtvx + xtvx.T))

        def proj(vw):
            return vw - np.einsum(
                "ntp,pm->ntm", vinv_x,
                cmat @ np.einsum("ntp,ntm->pm", x3, vw))

        py3 = proj(vinv_y)
        pz3 = proj(vinv_z)

        u_list = vi_apply(py3)
        quad = np.array([float(np.einsum("ntm,ntm->", py3, u))
                         for u in u_list])

        if gz3 is None:
            gz3 = batched_g(z3)
        viz = vi_apply(z3, gw=gz3)
        red = np.sum if exact_traces else np.mean
        tr = np.array([float(red(np.einsum("ntm,ntm->m", pz3, vz)))
                       for vz in viz])
        score = -0.5 * (tr - quad)

        u3 = np.concatenate(u_list, axis=2)
        solu, iters2 = v_solve(u3, sg, se)
        cg_total += iters2
        ai = 0.5 * np.einsum("nti,ntj->ij", u3, proj(solu))
        ai = 0.5 * (ai + ai.T)

        try:
            delta = np.linalg.solve(ai, score)
        except np.linalg.LinAlgError:
            delta = score / max(n, 1)
        new = theta + delta
        halvings = 0
        # step-halve into the PSD cone (at a boundary optimum this stops a
        # little short of the constrained optimum, as in the reference)
        while not valid(new) and halvings < 12:
            delta *= 0.5
            new = theta + delta
            halvings += 1
        if not valid(new):
            sgm, sem = unpack(theta + delta)
            sgm = _project_psd(sgm, floor=0.0, cap=None)
            sem = _project_psd(sem, floor=floor, cap=None)
            new = np.concatenate([[sgm[a, b] for a, b in pairs],
                                  [sem[a, b] for a, b in pairs]])
        step = float(np.abs(new - theta).max()
                     / max(float(np.abs(new).sum()), 1e-12))
        theta = new
        if verbose:
            sgm, sem = unpack(theta)
            print(f"  multi-reml iter {it_outer}: diag(Sg)="
                  f"{np.round(np.diag(sgm), 3)} diag(Se)="
                  f"{np.round(np.diag(sem), 3)} step={step:.2e} "
                  f"halvings={halvings}", flush=True)
        if step < tol:
            converged = True
            break

    sg, se = unpack(theta)
    dg_, de_ = np.diag(sg), np.diag(se)
    h2 = dg_ / np.maximum(dg_ + de_, 1e-24)
    rg = sg / np.sqrt(np.maximum(np.outer(dg_, dg_), 1e-24))
    np.fill_diagonal(rg, 1.0)

    se_h2 = np.full(t, np.nan)
    se_rg = np.full((t, t), np.nan)
    try:
        cov_t = np.linalg.inv(ai)
        gidx = {pr: k for k, pr in enumerate(pairs)}
        for a in range(t):
            gr = np.zeros(ncomp)
            tot = dg_[a] + de_[a]
            gr[gidx[(a, a)]] = de_[a] / tot ** 2
            gr[len(pairs) + gidx[(a, a)]] = -dg_[a] / tot ** 2
            v = float(gr @ cov_t @ gr)
            se_h2[a] = np.sqrt(v) if v > 0 else np.nan
        for a in range(t):
            for b in range(a + 1, t):
                sq = np.sqrt(dg_[a] * dg_[b])
                gr = np.zeros(ncomp)
                gr[gidx[(a, a)]] = -0.5 * sg[a, b] / (dg_[a] * sq)
                gr[gidx[(b, b)]] = -0.5 * sg[a, b] / (dg_[b] * sq)
                gr[gidx[(a, b)]] = 1.0 / sq
                v = float(gr @ cov_t @ gr)
                se_rg[a, b] = se_rg[b, a] = np.sqrt(v) if v > 0 else np.nan
    except np.linalg.LinAlgError:
        pass
    return sg, se, {
        "h2": h2, "rg": rg, "se_h2": se_h2, "se_rg": se_rg,
        "iterations": it_outer, "converged": converged,
        "cg_iterations": cg_total, "n_probes": n_probes,
        "exact_traces": exact_traces, "n_traits": t,
    }


def _project_psd(m, floor=0.0, cap=None):
    """Nearest (Frobenius) symmetric PSD matrix with eigenvalues clipped
    to [floor, cap]."""
    m = 0.5 * (m + m.T)
    w, v = np.linalg.eigh(m)
    w = np.clip(w, floor, cap)
    return (v * w) @ v.T


def estimate_bivar_reml(g, y1: np.ndarray, y2: np.ndarray,
                        covariates=None, n_probes: int = 8, probes=None,
                        max_iter: int = 40, tol: float = 5e-4,
                        cg_tol: float = 1e-5, cg_maxiter: int = 2000,
                        seed: int = 0, verbose: bool = False):
    """Bivariate REML, the genetic correlation of two traits (the gcta64
    ``--reml-bivar`` role): :func:`estimate_multi_reml` at t = 2.  Returns
    ``(rg, details)`` with the components g11/g22/g12/e11/e22/e12 and
    scalar SEs."""
    ys = np.stack([np.asarray(y1, np.float64).reshape(-1),
                   np.asarray(y2, np.float64).reshape(-1)], axis=1)
    sg, se, det = estimate_multi_reml(
        g, ys, covariates=covariates, n_probes=n_probes, probes=probes,
        max_iter=max_iter, tol=tol, cg_tol=cg_tol, cg_maxiter=cg_maxiter,
        seed=seed, verbose=verbose)
    return float(det["rg"][0, 1]), {
        "g11": float(sg[0, 0]), "g22": float(sg[1, 1]),
        "g12": float(sg[0, 1]),
        "e11": float(se[0, 0]), "e22": float(se[1, 1]),
        "e12": float(se[0, 1]),
        "h2_1": float(det["h2"][0]), "h2_2": float(det["h2"][1]),
        "se_rg": float(det["se_rg"][0, 1]),
        "se_h2_1": float(det["se_h2"][0]),
        "se_h2_2": float(det["se_h2"][1]),
        "iterations": det["iterations"], "converged": det["converged"],
        "cg_iterations": det["cg_iterations"],
        "n_probes": det["n_probes"], "exact_traces": det["exact_traces"],
    }


@dataclasses.dataclass
class MTGBLUPResult:
    beta: np.ndarray        # fixed effects [p, t]
    g_hat: np.ndarray       # breeding values [n, t]
    fitted: np.ndarray      # [n, t]
    cg_iterations: int = 0


def multi_trait_gblup(g, y: np.ndarray, su: np.ndarray,
                      se: np.ndarray, covariates: Optional[np.ndarray] = None,
                      tol: float = 1e-5, maxiter: int = 2000) -> MTGBLUPResult:
    """Multi-trait GBLUP with known covariances, t traits on the same
    animals:

        vec(U) ~ N(0, Su x G_s),   vec(E) ~ N(0, Se x I)

    The Kronecker operator is never formed: (Su x G) vec(V) = vec(G V Su'),
    one batched packed G pass over all traits plus two [t, t] mixes.  The
    GLS equations and the BLUP are solved by one Jacobi block CG each over
    the normalized RHS (diag(V) = Su_jj diag(G_s) + Se_jj).  NaN cells of
    ``y`` are missing: the solve restricts V to the observed cells, and the
    BLUP predicts every cell.  A :class:`StreamedGeno` raises TypeError,
    as in the reference."""
    g = _check_container(g)
    if isinstance(g, StreamedGeno):
        raise TypeError(
            "multi_trait_gblup takes a GenoMatrix, not a StreamedGeno: its "
            "solves are device CGs over the whole panel; materialize the "
            "panel instead")
    n = g.indiv
    y = np.asarray(y, np.float64)
    if y.ndim != 2 or y.shape[0] != n:
        raise ValueError(f"y must be [indiv, traits], got {y.shape}")
    t = y.shape[1]
    su = np.asarray(su, np.float64)
    se = np.asarray(se, np.float64)
    if su.shape != (t, t) or se.shape != (t, t):
        raise ValueError("su/se must be [t, t]")
    mask = ~np.isnan(y)
    if not mask.any():
        raise ValueError("y has no observed cells")
    mf = mask.astype(np.float64)
    y0 = np.where(mask, y, 0.0)
    dev = g.device
    maskj = torch.as_tensor(mf, dtype=torch.float32, device=dev)[:, :, None]

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    gmv = _grm_matvec_of(g)
    sigma2 = float(g.sigma2)
    suj = torch.as_tensor(su, dtype=torch.float32, device=dev)
    sej = torch.as_tensor(se, dtype=torch.float32, device=dev)

    def op(v):  # [n t, k], zero at the unobserved cells
        pages = v.reshape(n, t, -1) * maskj
        gp = (gmv(pages.reshape(n, -1)) / sigma2).reshape(n, t, -1)
        out = (torch.einsum("ntk,ts->nsk", gp, suj)
               + torch.einsum("ntk,ts->nsk", pages, sej))
        return (out * maskj).reshape(n * t, -1)

    gdiag = _grm_diag_of(g) / sigma2
    dv = gdiag[:, None] * np.diag(su)[None, :] + np.diag(se)[None, :]
    minv = torch.as_tensor(1.0 / dv.reshape(n * t), dtype=torch.float32,
                           device=dev)

    def solve(rhs2, scale):
        res = cg(op, torch.as_tensor(rhs2 / scale, dtype=torch.float32,
                                     device=dev),
                 tol=tol, maxiter=maxiter, minv=minv)
        return res.x.cpu().numpy().astype(np.float64) * scale, res.iterations

    # RHS pages: the t p fixed-effect columns (X column j in trait q, 0
    # elsewhere) and the observation page Y
    k = t * p + 1
    rhs = np.zeros((n, t, k))
    for q in range(t):
        for j in range(p):
            rhs[:, q, q * p + j] = x[:, j] * mf[:, q]
    rhs[:, :, -1] = y0
    norms = np.linalg.norm(rhs.reshape(n * t, k), axis=0)
    sol, iters = solve(rhs.reshape(n * t, k), np.where(norms > 0, norms, 1.0))
    sol = sol.reshape(n, t, k)

    vix = sol[:, :, :-1]                           # V^-1 (I x X) pages
    viy = sol[:, :, -1]                            # V^-1 Y
    # GLS: (X~' V^-1 X~) beta = X~' V^-1 y, X~ = I_t x X
    xtvx = np.empty((t * p, t * p))
    xtvy = np.empty(t * p)
    for q in range(t):
        for j in range(p):
            xtvx[q * p + j] = vix[:, q, :].T @ x[:, j]
            xtvy[q * p + j] = float(x[:, j] @ viy[:, q])
    xtvx = 0.5 * (xtvx + xtvx.T)
    beta = np.linalg.solve(xtvx, xtvy).reshape(t, p).T   # [p, t]

    resid = mf * (y0 - x @ beta)
    w, iters2 = solve(resid.reshape(n * t, 1),
                      max(np.linalg.norm(resid), 1e-30))
    gw = gmv(torch.as_tensor(w.reshape(n, t), dtype=torch.float32,
                             device=dev)).cpu().numpy().astype(np.float64)
    g_hat = gw / sigma2 @ su                       # (Su x G) V^-1 resid
    return MTGBLUPResult(beta=beta, g_hat=g_hat, fitted=x @ beta + g_hat,
                         cg_iterations=iters + iters2)


def gblup_from_grm(grm_matrix, y: np.ndarray, h2: float = 0.5,
                   covariates: Optional[np.ndarray] = None, tol: float = 1e-6,
                   maxiter: int = 2000, device=None) -> GBLUPResult:
    """GBLUP from a formed relationship matrix (a GCTA .grm.bin read back,
    an H-matrix of another tool, or :func:`grm`'s output): the BLUE/BLUP of
    :func:`gblup` by Jacobi block CG on the dense operator G v + lam v,
    each RHS normalized, ``tol`` the relative residual.  G goes to
    ``device`` as f32 (the CUDA card unless named; a tensor stays on its
    own device); the BLUP g_hat = G u is a host float64 product."""
    if isinstance(grm_matrix, torch.Tensor):
        dev = grm_matrix.device if device is None else torch.device(device)
        gj = grm_matrix.detach().to(device=dev, dtype=torch.float32)
        g = grm_matrix.detach().cpu().numpy().astype(np.float64)
    else:
        g = np.asarray(grm_matrix, np.float64)
        gj = torch.as_tensor(g, dtype=torch.float32, device=_device(device))
        dev = gj.device
    n = g.shape[0]
    if g.shape != (n, n):
        raise ValueError(f"grm must be square, got {g.shape}")
    y = np.asarray(y, np.float64).reshape(n)
    lam = (1.0 - h2) / h2

    cols = [np.ones((n, 1))]
    if covariates is not None:
        cov = np.asarray(covariates, np.float64)
        cols.append(cov[:, None] if cov.ndim == 1 else cov)
    x = np.concatenate(cols, axis=1)
    p = x.shape[1]

    minv = jacobi_minv(torch.diagonal(gj) + lam)
    converged = True

    def run(rhs, scale):
        nonlocal converged
        res = cg(lambda v: gj @ v + lam * v,
                 torch.as_tensor(rhs / scale, dtype=torch.float32, device=dev),
                 tol=tol, maxiter=maxiter, minv=minv)
        converged &= bool(torch.all(res.residual_norm <= tol))
        return res.x.cpu().numpy().astype(np.float64) * scale, res.iterations

    rhs = np.concatenate([x, y[:, None]], axis=1)
    b, iters = run(rhs, np.linalg.norm(rhs, axis=0))
    beta = np.linalg.solve(x.T @ b[:, :p], x.T @ b[:, p])
    resid = y - x @ beta
    u, iters_u = run(resid[:, None], max(np.linalg.norm(resid), 1e-30))
    u = u[:, 0]
    g_hat = g @ u
    return GBLUPResult(beta=beta, g_hat=g_hat, fitted=x @ beta + g_hat,
                       pcs=None, cg_iterations=iters + iters_u, u=u,
                       converged=converged)
