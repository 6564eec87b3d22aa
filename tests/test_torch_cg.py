"""The port's CG layer against miraculix_tpu.solve.cg.

grm_diag within 1e-5 relative; grm_matvec and grm_cg_solve (plain and
Jacobi-preconditioned) within 1e-4 relative; the block CG takes the same
number of iterations as the reference, give or take one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import solve as ref_solve  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402

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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(96, 600, seed=12)
    return g, mx.from_dense(g), mt.from_dense(g, device=CPU)


@pytest.mark.parametrize("center,scale", [(True, False), (True, True),
                                          (False, False)])
def test_grm_diag_matches_reference(panel, center, scale):
    _, ref, port = panel
    want = ref_solve.grm_diag(ref, center=center, scale=scale)
    got = mt.grm_diag(port, center=center, scale=scale).numpy()
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("scale", [False, True])
def test_grm_matvec_matches_reference(panel, scale):
    _, ref, port = panel
    v = np.random.default_rng(1).standard_normal((96, 3)).astype(np.float32)
    want = ref_solve.grm_matvec(ref, v, scale=scale)
    got = mt.grm_matvec(port, torch.from_numpy(v), scale=scale).numpy()
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("precondition", [False, True])
@pytest.mark.parametrize("scale,lam", [(False, 50.0), (True, 0.7)])
def test_grm_cg_solve_matches_reference(panel, precondition, scale, lam):
    g, ref, port = panel
    b = np.random.default_rng(2).standard_normal((96, 2)).astype(np.float32)
    tol = 1e-5 * float(np.linalg.norm(b))
    want = ref_solve.grm_cg_solve(ref, b, lam=lam, scale=scale, tol=tol,
                                  maxiter=500, precondition=precondition)
    got = mt.grm_cg_solve(port, b, lam=lam, scale=scale, tol=tol,
                          maxiter=500, precondition=precondition)
    assert _rel(got.x.numpy(), want.x) < 1e-4
    assert abs(got.iterations - int(want.iterations)) <= 1
    # and it solved the system: (Zc Zc^T [/ sigma2] + lam I) x = b
    f = np.asarray(ref.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    a = zc @ zc.T / (float(ref.sigma2) if scale else 1.0) + lam * np.eye(96)
    assert _rel(got.x.numpy(), np.linalg.solve(a, b)) < 1e-4


def test_cg_generic_and_vector_rhs():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((40, 40))
    a = torch.as_tensor(m @ m.T + 40 * np.eye(40), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(40), dtype=torch.float32)
    res = mt.cg(lambda v: a @ v, b, tol=1e-4, maxiter=200)
    assert res.x.shape == (40,)
    assert float(torch.linalg.norm(a @ res.x - b)) < 1e-3
    want = ref_solve.cg(lambda v: np.asarray(a) @ v, np.asarray(b),
                        tol=1e-4, maxiter=200)
    assert abs(res.iterations - int(want.iterations)) <= 1
    d = torch.tensor([2.0, 0.0, -1.0])
    np.testing.assert_array_equal(mt.jacobi_minv(d).numpy(), [0.5, 1.0, 1.0])
