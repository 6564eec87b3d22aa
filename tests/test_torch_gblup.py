"""The whole slice against miraculix_tpu.gblup on the tests/test_gblup.py
panel (150 x 1200): PCA, both CG block solves and the BLUP matvec.

fitted, g_hat and the intercept agree within 1e-3 relative.  PC signs are
arbitrary, so the PCs are compared by the subspace they span.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host (several test workers
    each starting one thread per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-3


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(150, 1200, seed=60)
    return g, mx.from_dense(g), mt.from_dense(g, device=CPU)


def test_simulate_phenotypes_same_draws(panel):
    g = panel[0]
    for a, b in zip(pt_gblup.simulate_phenotypes(g, h2=0.3, seed=2),
                    ref_gblup.simulate_phenotypes(g, h2=0.3, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_randomized_pca_matches_reference(panel):
    _, ref, port = panel
    w_ref, v_ref = ref_gblup.randomized_grm_pca(ref, k=4, seed=1)
    w, v = pt_gblup.randomized_grm_pca(port, k=4, seed=1)
    np.testing.assert_allclose(w, w_ref, rtol=1e-3)
    # same subspace: the projection of each port PC onto the reference PCs
    # keeps its norm
    proj = np.linalg.norm(v_ref.T @ v, axis=0)
    np.testing.assert_allclose(proj, 1.0, atol=1e-3)


@pytest.mark.parametrize("n_pcs,tol", [(2, 1e-4), (0, 1e-6)])
def test_gblup_matches_reference(panel, n_pcs, tol):
    g, ref, port = panel
    y, bv = ref_gblup.simulate_phenotypes(g, h2=0.5, seed=2)
    want = ref_gblup.gblup(ref, y, h2=0.5, n_pcs=n_pcs, tol=tol, seed=3,
                           verbose=False)
    got = pt_gblup.gblup(port, y, h2=0.5, n_pcs=n_pcs, tol=tol, seed=3,
                         verbose=False)
    assert got.converged
    assert _rel(got.fitted, want.fitted) < RTOL
    assert _rel(got.g_hat, want.g_hat) < RTOL
    assert abs(got.beta[0] - want.beta[0]) < RTOL * abs(want.beta[0])
    assert _rel(got.u, want.u) < RTOL
    assert abs(got.cg_iterations - want.cg_iterations) <= 2
    assert np.corrcoef(got.g_hat, bv)[0, 1] > 0.5


def test_snp_effects_and_predict_match_reference(panel):
    g, ref, port = panel
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.5, seed=4)
    res_ref = ref_gblup.gblup(ref, y, h2=0.5, n_pcs=0, tol=1e-6)
    res = pt_gblup.gblup(port, y, h2=0.5, n_pcs=0, tol=1e-6)
    alpha_ref = ref_gblup.snp_effects(ref, res_ref)
    alpha = pt_gblup.snp_effects(port, res)
    assert _rel(alpha, alpha_ref) < RTOL
    # g_hat = Z_c alpha on the training panel
    assert _rel(pt_gblup.predict(port, alpha, port.freq.numpy()),
                res.g_hat) < RTOL
    new = bed.simulate_genotypes(40, 1200, seed=61)
    want = ref_gblup.predict(mx.from_dense(new), alpha_ref,
                             np.asarray(ref.freq))
    got = pt_gblup.predict(mt.from_dense(new, device=CPU), alpha,
                           port.freq.numpy())
    assert _rel(got, want) < RTOL


def test_gblup_rejects_unported_paths(panel):
    """solver="dense" is ported (the reference at 1e-4); unknown solvers and
    objects that are no genotype container are rejected."""
    g, ref, port = panel
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.5, seed=5)
    want = ref_gblup.gblup(ref, y, h2=0.5, n_pcs=2, solver="dense", seed=3)
    got = pt_gblup.gblup(port, y, h2=0.5, n_pcs=2, solver="dense", seed=3)
    assert _rel(got.g_hat, want.g_hat) < 1e-4
    assert _rel(got.fitted, want.fitted) < 1e-4
    assert np.abs(got.beta - want.beta).max() < 1e-4 * np.abs(want.beta).max()
    assert got.cg_iterations == 0 and got.converged
    with pytest.raises(ValueError, match="solver"):
        pt_gblup.gblup(port, y, solver="lu")
    with pytest.raises(TypeError, match="not a genotype container"):
        pt_gblup.randomized_grm_pca(object())
