"""The port's f64 tier, refined solves and dense solvers against miraculix_tpu.

The reference runs as its own tests run it (Pallas interpret mode on the
CPU, x64 on); the port runs the plain version of its digit kernel, so the
digit products are exact on both sides and the f64 tier agrees bit for bit
or to one f64 rounding per addition.  Tolerances: the reference's own
(tests/test_dgemm.py, tests/test_solve.py, tests/test_gblup.py), 1e-12
relative for the f64 dgemm, 1e-10 for the dense solvers in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import solve as ref_solve  # noqa: E402
from miraculix_tpu.io import bed, codec  # noqa: E402
from miraculix_tpu.ops import dgemm as ref_dgemm  # noqa: E402
from miraculix_tpu.ops import ref_impl  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch import solve as pt_solve  # noqa: E402
from miraculix_tpu_torch.ops import dgemm as pt_dgemm  # noqa: E402

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


def _zq(g):
    """(reference packing as numpy, the port's int32 tensor of it)."""
    zq = codec.pack_planar16(g)
    return zq, torch.from_numpy(zq.view(np.int32))


@pytest.fixture(scope="module")
def wide():
    g = np.random.default_rng(7).integers(0, 3, size=(64, 1500)).astype(
        np.uint8)
    return (g, *_zq(g))


@pytest.mark.parametrize("cols", [1500, 700])
def test_packed_matmul_int8_plain_equals_reference(wide, cols):
    """Digits over [-64, 64]; 1500 SNPs pack to 16*128 = 2048 columns, and
    700 leaves most of the plane rows of the RHS absent."""
    g, zq, port_zq = wide
    d = np.random.default_rng(cols).integers(-64, 65, size=(cols, 5))
    want = np.asarray(ref_dgemm.packed_matmul_int8(
        jnp.asarray(zq), jnp.asarray(d, jnp.int32), interpret=True))
    got = pt_dgemm.packed_matmul_int8(port_zq, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, g[:, :cols].astype(np.int64) @ d)
    with pytest.raises(ValueError, match=r"\[-128, 127\]"):
        pt_dgemm.packed_matmul_int8(port_zq, d * 3)


@pytest.mark.parametrize("snps,kw_cap", [(1500, 2 ** 19), (8192, 128)])
def test_packed_matmul_exact_matches_reference(snps, kw_cap):
    """Per-column dynamic range 2^+-20 (tests/test_dgemm.py); at 8192 SNPs
    and _kw_cap=128 the packed-word axis splits into 4 chunks."""
    rng = np.random.default_rng(snps)
    g = rng.integers(0, 3, size=(64, snps)).astype(np.uint8)
    zq, port_zq = _zq(g)
    b = rng.standard_normal((snps, 3)) * np.exp2(
        rng.integers(-20, 20, size=(1, 3)))
    want = ref_dgemm.packed_matmul_exact(zq, b, _kw_cap=kw_cap,
                                         interpret=True)
    got = pt_dgemm.packed_matmul_exact(port_zq, b, _kw_cap=kw_cap)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert _rel(got, want) < 1e-13
    assert _rel(got, g.astype(np.float64) @ b) < 1e-13
    dev = pt_dgemm.packed_matmul_f64(port_zq, b, _kw_cap=kw_cap)
    assert dev.dtype == torch.float64
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.fixture(scope="module")
def missing_panel():
    g = bed.simulate_genotypes(100, 2000, seed=13, missing_rate=0.03)
    return (g, mx.from_dense(g, keep_missing_info=True),
            mt.from_dense(g, keep_missing_info=True, device=CPU))


@pytest.mark.parametrize("kind", [False, True, "colmeans", "user"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_f64_matches_reference(missing_panel, trans, kind):
    """Both orientations and the four centerings (a float64 user vector),
    with the missing correction (ignore_missings=False) and with
    normalize; numpy float64 within 1e-12 of the reference.  ``normalize``
    divides by the root of the panel's stored f32 scale, which each package
    sums in its own order (~1e-7 apart): there each result is compared
    times its own scale."""
    g, ref, port = missing_panel
    rng = np.random.default_rng(len(str(kind)))
    b = rng.standard_normal((2000 if trans == "n" else 100, 4))
    center = rng.standard_normal(2000) if kind == "user" else kind
    for ignore, normalize in ((False, False), (True, True)):
        want = mx.dgemm(ref, b, trans=trans, center=center, precision="f64",
                        ignore_missings=ignore, normalize=normalize)
        got = mt.dgemm(port, b, trans=trans, center=center, precision="f64",
                       ignore_missings=ignore, normalize=normalize)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        if normalize:
            name = "sigma2" if trans == "t" else "pseudo_sigma2"
            assert _rel(got, want) < 1e-6
            got = got * np.sqrt(float(getattr(port, name)))
            want = want * np.sqrt(float(getattr(ref, name)))
        assert _rel(got, want) < 1e-12
    if kind in (True, "user") and trans == "n":
        oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                       center=center, respect_missings=True)
        got = mt.dgemm(port, b, trans="n", center=center, precision="f64",
                       ignore_missings=False)
        assert _rel(got, oracle) < 1e-12


@pytest.fixture(scope="module")
def small():
    g = bed.simulate_genotypes(80, 500, seed=22)
    f = np.asarray(mx.from_dense(g).freq, np.float64)
    return g, mt.from_dense(g, device=CPU), g.astype(np.float64) - 2.0 * f


def test_grm_matvec_f64_true_double(small):
    g, port, zc = small
    v = np.random.default_rng(1).standard_normal((80, 3))
    got = pt_solve.grm_matvec_f64(port, v)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert _rel(got, zc @ (zc.T @ v)) < 1e-11
    ref = mx.from_dense(g)
    # scaled: each side divides by its own stored f32 sigma2
    want = ref_solve.grm_matvec_f64(ref, v, scale=True) * float(ref.sigma2)
    got = pt_solve.grm_matvec_f64(port, v, scale=True) * float(port.sigma2)
    assert _rel(got, want) < 1e-12
    assert pt_solve.grm_matvec_f64(port, v[:, 0]).shape == (80,)


def test_grm_cg_solve_refined_f64_grade(small):
    """Refinement reaches f64-class accuracy that the f32 CG alone cannot
    (tests/test_solve.py)."""
    _, port, zc = small
    lam = 25.0
    b = np.random.default_rng(2).standard_normal((80, 2))
    x, outer, inner, rel = pt_solve.grm_cg_solve_refined(
        port, b, lam=lam, tol=1e-10, outer=6)
    want = np.linalg.solve(zc @ zc.T + lam * np.eye(80), b)
    assert np.abs(x - want).max() / np.abs(want).max() < 1e-9
    assert rel.max() < 1e-10 and outer >= 2 and inner > 0
    with pytest.raises(ValueError, match="rows"):
        pt_solve.grm_cg_solve_refined(port, b[:70])


@pytest.fixture(scope="module")
def gblup_panel():
    g = bed.simulate_genotypes(150, 1200, seed=60)
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.5, seed=2)
    return g, y, mx.from_dense(g), mt.from_dense(g, device=CPU)


def test_gblup_refined_matches_reference(gblup_panel):
    g, y, ref, port = gblup_panel
    want = ref_gblup.gblup(ref, y, h2=0.5, n_pcs=0, solver="refined",
                           tol=1e-10)
    got = pt_gblup.gblup(port, y, h2=0.5, n_pcs=0, solver="refined",
                         tol=1e-10)
    assert got.converged
    assert _rel(got.beta, want.beta) < 1e-8
    assert _rel(got.g_hat, want.g_hat) < 1e-8
    assert _rel(got.fitted, want.fitted) < 1e-8


def test_gblup_refined_is_f64_grade(gblup_panel):
    """The whole refined pipeline against a float64 replication of its
    algebra with the run's own PCs (tests/test_gblup.py)."""
    g, y, ref, port = gblup_panel
    h2 = 0.5
    res = pt_gblup.gblup(port, y, h2=h2, n_pcs=2, solver="refined",
                         tol=1e-11, maxiter=4000, seed=3)
    f = np.asarray(ref.freq, np.float64)
    zc = g.astype(np.float64) - 2.0 * f[None, :]
    sigma2 = float(port.sigma2)
    lam = (1.0 - h2) / h2
    n = g.shape[0]
    x = np.concatenate([np.ones((n, 1)), res.pcs], axis=1)
    a = zc @ zc.T + lam * sigma2 * np.eye(n)
    b = np.linalg.solve(a, np.concatenate([x, y[:, None]], axis=1)) * sigma2
    beta = np.linalg.solve(x.T @ b[:, :-1], x.T @ b[:, -1])
    u = np.linalg.solve(a, (y - x @ beta)[:, None])[:, 0] * sigma2
    g_hat = (zc @ (zc.T @ u)) / sigma2
    np.testing.assert_allclose(res.beta, beta, rtol=1e-8, atol=1e-10)
    assert np.abs(res.g_hat - g_hat).max() / np.abs(g_hat).max() < 1e-8


def _spd(rng, n, shift):
    m = rng.standard_normal((n, n))
    return m @ m.T + shift * np.eye(n)


DENSE_CASES = ["dense_solve", "dense_solve_vector", "chol2inv",
               "x_cinv_y_logdet", "solve_relmat", "sqrt_posdef", "sqrt_rhs",
               "solve_posdef_cholesky", "solve_posdef_eigh", "solve_posdef_lu",
               "solve_posdef_auto", "solve_posdef_auto_singular"]


@pytest.mark.parametrize("case", DENSE_CASES)
def test_dense_solvers_match_reference(case):
    """solve/dense against the reference's in float64 at 1e-10."""
    rng = np.random.default_rng(DENSE_CASES.index(case))
    a = _spd(rng, 20, 20.0)
    b = rng.standard_normal((20, 3))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    pairs = []
    if case == "dense_solve":
        w = ref_solve.dense_solve(ja, jb, calc_logdet=True, jitter=0.5)
        p = pt_solve.dense_solve(ta, tb, calc_logdet=True, jitter=0.5)
        pairs = [(p.x, w.x), (p.logdet, w.logdet)]
    elif case == "dense_solve_vector":
        w = ref_solve.dense_solve(ja, jb[:, 0])
        p = pt_solve.dense_solve(ta, tb[:, 0])
        pairs = [(p.x, w.x)]
        assert p.logdet is None
    elif case == "chol2inv":
        pairs = [(pt_solve.chol2inv(ta), ref_solve.chol2inv(ja))]
    elif case == "x_cinv_y_logdet":
        x = rng.standard_normal((20, 2))
        pairs = list(zip(pt_solve.x_cinv_y_logdet(torch.as_tensor(x), ta, tb),
                         ref_solve.x_cinv_y_logdet(jnp.asarray(x), ja, jb)))
    elif case == "solve_relmat":
        p = pt_solve.solve_relmat(ta, 0.7, tb[:, 0], beta=1.5)
        w = ref_solve.solve_relmat(ja, 0.7, jb[:, 0], beta=1.5)
        pairs = [(p.x, w.x), (p.yhat, w.yhat)]
    elif case == "sqrt_posdef":
        pairs = [(pt_solve.sqrt_posdef(ta), ref_solve.sqrt_posdef(ja))]
    elif case == "sqrt_rhs":
        pairs = [(pt_solve.sqrt_rhs(ta, tb), ref_solve.sqrt_rhs(ja, jb))]
    elif case == "solve_posdef_auto_singular":
        # rank-deficient PSD: Cholesky fails (NaN), auto falls back to eigh
        m = rng.standard_normal((20, 12))
        a = m @ m.T
        b = a @ rng.standard_normal((20, 3))
        p = pt_solve.solve_posdef(torch.as_tensor(a), torch.as_tensor(b),
                                  calc_logdet=True, eigen_floor=1e-8)
        w = ref_solve.solve_posdef(jnp.asarray(a), jnp.asarray(b),
                                   calc_logdet=True, eigen_floor=1e-8)
        assert bool(torch.isnan(pt_solve.solve_posdef(
            torch.as_tensor(a), torch.as_tensor(b), method="cholesky").x
        ).any())
        pairs = [(p.x, w.x), (p.logdet, w.logdet)]
    else:
        method = case.rsplit("_", 1)[1]
        p = pt_solve.solve_posdef(ta, tb, method=method, calc_logdet=True)
        w = ref_solve.solve_posdef(ja, jb, method=method, calc_logdet=True)
        pairs = [(p.x, w.x), (p.logdet, w.logdet)]
    for got, want in pairs:
        assert got.dtype == torch.float64
        assert _rel(got.numpy(), want) < 1e-10


def test_dense_solvers_put_arrays_on_the_requested_device(monkeypatch):
    """numpy inputs go to ``device`` (the card unless another is named),
    tensors stay on their own device."""
    rng = np.random.default_rng(11)
    a, b = _spd(rng, 20, 20.0), rng.standard_normal((20, 3))
    x = pt_solve.dense_solve(a, b, device=CPU).x
    assert x.device.type == "cpu" and x.dtype == torch.float64
    assert _rel(x.numpy(), np.linalg.solve(a, b)) < 1e-10
    for fn, args in ((pt_solve.chol2inv, (a,)), (pt_solve.sqrt_posdef, (a,)),
                     (pt_solve.sqrt_rhs, (a, b)),
                     (pt_solve.solve_posdef, (a, b)),
                     (pt_solve.solve_relmat, (a, 0.7, b[:, 0])),
                     (pt_solve.x_cinv_y_logdet, (b, a, b))):
        assert fn(*args, device=CPU)[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_solve.dense_solve(a, b)
    assert pt_solve.dense_solve(torch.as_tensor(a), b).x.device.type == "cpu"
