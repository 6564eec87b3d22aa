"""Multi-trait REML (bivariate and t-trait), its device V-solve and
multi-trait GBLUP against miraculix_tpu.gblup, on the tests/test_gblup.py
REML panel (160 x 800, seed 11) with correlated traits.

Tolerances: Sg, Se, h2, rg and the SEs within 1e-3 absolute of the
reference; equal AI-step counts; CG totals within 2 a solve; g_hat, fitted
and beta within 1e-3 relative (the RTOL of test_torch_gblup.py).  Without
the reference: the device V-solve and ``multi_trait_gblup`` against dense
float64 Kronecker solves (3e-4 and 5e-3, the reference's own tests'
limits), and ``device_cg=True`` within 1e-4 of its host float64 oracle
``device_cg=False``.  Each reference function is called once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests
RTOL = 1e-3
ATOL = 1e-3  # variance components, h2, rg and their SEs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


def _scaled_grm(geno, freq):
    z = np.where(geno == 3, 0, geno).astype(np.float64)
    zc = z - 2.0 * freq
    return zc @ zc.T / (2.0 * (freq * (1.0 - freq)).sum())


@pytest.fixture(scope="module")
def panel():
    """The panel in both packages and three traits: y2 shares y1's
    genetic values in part, y3 is independent."""
    geno = bed.simulate_genotypes(160, 800, seed=11)
    y1, _ = ref_gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=400, seed=5)
    y2, _ = ref_gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=400, seed=6)
    y3, _ = ref_gblup.simulate_phenotypes(geno, h2=0.4, n_qtl=400, seed=7)
    ys = np.stack([y1, y2 + 0.5 * y1, y3], axis=1)
    return geno, mx.from_dense(geno), mt.from_dense(geno, device=CPU), ys


@pytest.fixture(scope="module")
def bivar(panel):
    _, ref, port, ys = panel
    kw = dict(n_probes=8, seed=2)
    return (ref_gblup.estimate_bivar_reml(ref, ys[:, 0], ys[:, 1], **kw),
            pt_gblup.estimate_bivar_reml(port, ys[:, 0], ys[:, 1], **kw))


@pytest.fixture(scope="module")
def multi(panel):
    """t = 3 with a covariate: the reference's device CG, the port's
    device CG and its host float64 oracle."""
    _, ref, port, ys = panel
    kw = dict(covariates=np.random.default_rng(3).standard_normal(160),
              n_probes=6, seed=1)
    return (ref_gblup.estimate_multi_reml(ref, ys, **kw),
            pt_gblup.estimate_multi_reml(port, ys, **kw),
            pt_gblup.estimate_multi_reml(port, ys, device_cg=False, **kw))


def test_bivar_matches_reference(bivar):
    (rg_ref, d_ref), (rg, d) = bivar
    assert d["converged"] and d_ref["converged"]
    assert abs(rg - rg_ref) < ATOL
    for k in ("g11", "g22", "g12", "e11", "e22", "e12", "h2_1", "h2_2",
              "se_rg", "se_h2_1", "se_h2_2"):
        assert abs(d[k] - d_ref[k]) < ATOL, k
    assert d["iterations"] == d_ref["iterations"]
    assert abs(d["cg_iterations"] - d_ref["cg_iterations"]) \
        <= 2 * 2 * d["iterations"]
    assert d["n_probes"] == 8 and not d["exact_traces"]


@pytest.mark.parametrize("which", ["device_cg", "host"])
def test_multi_reml_matches_reference(multi, which):
    (sg_r, se_r, d_r) = multi[0]
    sg, se, d = multi[1] if which == "device_cg" else multi[2]
    assert d["converged"] and d_r["converged"] and d["n_traits"] == 3
    np.testing.assert_allclose(sg, sg_r, atol=ATOL)
    np.testing.assert_allclose(se, se_r, atol=ATOL)
    np.testing.assert_allclose(d["h2"], d_r["h2"], atol=ATOL)
    np.testing.assert_allclose(d["rg"], d_r["rg"], atol=ATOL)
    np.testing.assert_allclose(d["se_h2"], d_r["se_h2"], atol=ATOL)
    off = ~np.eye(3, dtype=bool)
    np.testing.assert_allclose(d["se_rg"][off], d_r["se_rg"][off],
                               atol=ATOL)
    assert d["iterations"] == d_r["iterations"]
    assert abs(d["cg_iterations"] - d_r["cg_iterations"]) \
        <= 2 * 2 * d["iterations"]


def test_multi_reml_device_cg_matches_host(multi):
    """The device V-solve against the host float64 loop, in the port."""
    (sg_d, se_d, d_d), (sg_h, se_h, d_h) = multi[1], multi[2]
    np.testing.assert_allclose(sg_d, sg_h, atol=1e-4)
    np.testing.assert_allclose(se_d, se_h, atol=1e-4)
    np.testing.assert_allclose(d_d["h2"], d_h["h2"], atol=1e-4)
    assert d_d["iterations"] == d_h["iterations"]


def test_multi_reml_rejects_bad_traits(panel):
    _, _, port, ys = panel
    with pytest.raises(ValueError, match=">= 2 traits"):
        pt_gblup.estimate_multi_reml(port, ys[:, :1])
    bad = ys.copy()
    bad[0, 1] = np.nan
    with pytest.raises(ValueError, match="no NaN"):
        pt_gblup.estimate_multi_reml(port, bad)
    with pytest.raises(ValueError, match="probes"):
        pt_gblup.estimate_multi_reml(port, ys, probes=np.eye(10))


def test_multi_v_solver_matches_dense_kron(panel):
    """The device V-solve against a dense float64 solve of V = Sg x G_s +
    Se x I (vec order individual-major: V = kron(G_s, Sg) + kron(I, Se)),
    at two component pairs."""
    geno, _, port, _ = panel
    n, t, m = 160, 3, 5
    gs = _scaled_grm(geno, port.freq.numpy().astype(np.float64))
    sg = np.array([[1.0, 0.5, 0.2], [0.5, 1.2, 0.1], [0.2, 0.1, 0.8]])
    se = np.array([[1.0, 0.3, 0.0], [0.3, 0.9, 0.2], [0.0, 0.2, 1.1]])
    b3 = np.random.default_rng(0).standard_normal((n, t, m))
    solve = pt_gblup._multi_v_solver(port, t, np.diag(gs), cg_tol=1e-6,
                                     cg_maxiter=4000)
    for a, b in ((sg, se), (0.6 * sg, 1.3 * se)):
        x3, iters = solve(b3, a, b)
        v = np.kron(gs, a) + np.kron(np.eye(n), b)
        want = np.linalg.solve(v, b3.reshape(n * t, m))
        rel = (np.linalg.norm(x3.reshape(n * t, m) - want, axis=0)
               / np.linalg.norm(want, axis=0))
        assert rel.max() < 3e-4, rel
        assert 0 < iters <= 4000


@pytest.fixture(scope="module")
def mt_fits(panel):
    """(reference, port) multi_trait_gblup on two traits with a covariate
    and trait 2 missing on every 7th animal."""
    _, ref, port, ys = panel
    y = ys[:, :2].copy()
    y[::7, 1] = np.nan
    su = np.array([[0.6, 0.3], [0.3, 0.5]])
    se = np.array([[0.4, 0.1], [0.1, 0.5]])
    cov = np.random.default_rng(9).standard_normal(160)
    kw = dict(covariates=cov, tol=1e-6)
    return y, su, se, cov, (ref_gblup.multi_trait_gblup(ref, y, su, se, **kw),
                            pt_gblup.multi_trait_gblup(port, y, su, se, **kw))


def test_multi_trait_gblup_matches_reference(mt_fits):
    *_, (want, got) = mt_fits
    assert got.g_hat.shape == (160, 2) and got.beta.shape == (2, 2)
    assert _rel(got.g_hat, want.g_hat) < RTOL
    assert _rel(got.fitted, want.fitted) < RTOL
    assert _rel(got.beta, want.beta) < RTOL
    assert abs(got.cg_iterations - want.cg_iterations) <= 2 * 2


def test_multi_trait_gblup_matches_dense_kron(mt_fits, panel):
    """GLS and BLUP against a dense float64 oracle restricted to the
    observed cells; the missing cells are predicted."""
    geno, _, port, _ = panel
    y, su, se, cov, (_, got) = mt_fits
    n, t = y.shape
    gs = _scaled_grm(geno, port.freq.numpy().astype(np.float64))
    obs = np.flatnonzero(~np.isnan(y.T.reshape(-1)))   # trait-major vec
    v = np.kron(su, gs) + np.kron(se, np.eye(n))
    xt = np.kron(np.eye(t), np.column_stack([np.ones(n), cov]))
    vio = np.linalg.inv(v[np.ix_(obs, obs)])
    xo, yo = xt[obs], y.T.reshape(-1)[obs]
    beta = np.linalg.solve(xo.T @ vio @ xo, xo.T @ vio @ yo)
    w = vio @ (yo - xo @ beta)
    ghat = (np.kron(su, gs)[:, obs] @ w).reshape(t, n).T
    assert np.abs(got.beta.T.reshape(-1) - beta).max() < 5e-3
    assert _rel(got.g_hat, ghat) < 5e-3
    assert np.isfinite(got.g_hat[::7, 1]).all()


def test_multi_trait_gblup_rejects_bad_inputs(panel):
    _, _, port, ys = panel
    su = np.eye(2)
    with pytest.raises(ValueError, match="indiv, traits"):
        pt_gblup.multi_trait_gblup(port, ys[:, 0], su, su)
    with pytest.raises(ValueError, match="su/se"):
        pt_gblup.multi_trait_gblup(port, ys[:, :2], np.eye(3), su)
    with pytest.raises(ValueError, match="no observed"):
        pt_gblup.multi_trait_gblup(port, np.full((160, 2), np.nan), su, su)


@pytest.mark.parametrize("fn", [
    lambda g, y: pt_gblup.estimate_multi_reml(g, y),
    lambda g, y: pt_gblup.estimate_bivar_reml(g, y[:, 0], y[:, 1]),
    lambda g, y: pt_gblup.multi_trait_gblup(g, y, np.eye(3), np.eye(3)),
    lambda g, y: pt_gblup._multi_v_solver(g, 3, np.ones(160), 1e-5, 10),
], ids=["multi_reml", "bivar_reml", "multi_trait_gblup", "multi_v_solver"])
def test_unported_containers_raise(panel, fn):
    """Anything but a genotype container is refused with a TypeError
    naming the accepted ones."""
    with pytest.raises(TypeError, match="not a genotype container"):
        fn(object(), panel[3])
