"""The blocked sparse triangular solver against
miraculix_tpu.solve.sparse and dense float64 oracles.

Factors from ``simulate_pedigree_factor`` (n = 1,500 and 3,000), block sizes
1, 64, 300 and 512 (ragged against n).  Tolerances, relative to max |x|:
1e-12 of the reference in float64 (both packages analyse on the host in
float64), 1e-5 in float32 with the device analysis (float32 block-doubling
inverses in both); ``solve_f64`` / ``solve_lltx_f64`` reach residual 1e-12
with x within 1e-10 of the reference's.  Each reference solver is built once
per module.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from miraculix_tpu.solve import sparse as ref  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.solve import sparse as ps  # noqa: E402

CPU = "cpu"
N = 1500
BLOCKS = (1, 64, 300, 512)
PRECISIONS = {"f64": (None, None, 1e-12), "f32": (jnp.float32, torch.float32,
                                                  1e-5)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _dense(r, c, v, n):
    d = np.zeros((n, n))
    np.add.at(d, (np.asarray(r) - 1, np.asarray(c) - 1), v)
    return d


@pytest.fixture(scope="module")
def factor():
    r, c, v = ref.simulate_pedigree_factor(N, avg_offdiag=6, seed=1)
    rng = np.random.default_rng(5)
    return r, c, v, rng.standard_normal((N, 3)), rng.permutation(N) + 1


@pytest.fixture(scope="module")
def pairs(factor):
    """(bs, triangle, precision) -> (reference solver, port solver)."""
    r, c, v, _, _ = factor
    out = {}
    for bs in BLOCKS:
        for tri in ("lower", "upper"):
            rr, cc = (r, c) if tri == "lower" else (c, r)
            for prec, (rdt, pdt, _) in PRECISIONS.items():
                kw = dict(bs=bs, lower=tri == "lower")
                out[bs, tri, prec] = (
                    ref.SparseTriangularSolver(rr, cc, v, N, dtype=rdt, **kw),
                    ps.SparseTriangularSolver(rr, cc, v, N, dtype=pdt,
                                              device=CPU, **kw))
    return out


def test_simulate_pedigree_factor_equals_reference():
    for args in (dict(n=N, avg_offdiag=6, seed=1),
                 dict(n=3000, avg_offdiag=9, bandwidth=200, seed=4,
                      index_base=0)):
        for got, want in zip(ps.simulate_pedigree_factor(**args),
                             ref.simulate_pedigree_factor(**args)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prec", sorted(PRECISIONS))
@pytest.mark.parametrize("tri", ["lower", "upper"])
@pytest.mark.parametrize("bs", BLOCKS)
def test_solve_matches_reference(pairs, factor, bs, tri, prec):
    r_slv, p_slv = pairs[bs, tri, prec]
    b = factor[3]
    tol = PRECISIONS[prec][2]
    assert p_slv._dtype == (torch.float64 if prec == "f64" else torch.float32)
    assert (p_slv.nb, p_slv.npad) == (r_slv.nb, r_slv.npad)
    for trans in ("n", "t"):
        got = p_slv.solve(b, trans=trans)
        assert got.shape == (N, 3) and got.dtype == p_slv._dtype
        assert _rel(got, r_slv.solve(b, trans=trans)) < tol, trans
        # one column, squeezed as the reference does
        assert _rel(p_slv.solve(b[:, 0], trans=trans),
                    r_slv.solve(b[:, 0], trans=trans)) < tol, trans


@pytest.mark.parametrize("tri", ["lower", "upper"])
@pytest.mark.parametrize("bs", [64, 300])
def test_solve_matches_dense_oracle(pairs, factor, bs, tri):
    """The float64 solver against dense float64 solves of L and L^T."""
    r, c, v, b, _ = factor
    d = _dense(r, c, v, N)
    d = d if tri == "lower" else d.T
    p_slv = pairs[bs, tri, "f64"][1]
    for trans, a in (("n", d), ("t", d.T)):
        x = p_slv.solve(b, trans=trans).numpy()
        assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-12


@pytest.mark.parametrize("bs", [64, 512])
def test_refine_and_solve_lltx_perm_match_reference(pairs, factor, bs):
    r, c, v, b, perm = factor
    for prec in ("f64", "f32"):
        r_slv, p_slv = pairs[bs, "lower", prec]
        tol = PRECISIONS[prec][2]
        for trans in ("n", "t"):
            assert _rel(p_slv.solve(b, trans=trans, refine=1),
                        r_slv.solve(b, trans=trans, refine=1)) < tol
        assert _rel(p_slv.solve_lltx(b, perm=perm),
                    r_slv.solve_lltx(b, perm=perm)) < tol
        assert _rel(p_slv.solve_lltx(b[:, 1]), r_slv.solve_lltx(b[:, 1])) < tol
        # 0-based permutation
        assert _rel(p_slv.solve_lltx(b, perm=perm - 1, index_base=0),
                    r_slv.solve_lltx(b, perm=perm)) < tol
    # the permuted normal equations, densely
    d = _dense(r, c, v, N)
    p = perm - 1
    want = np.zeros((N, 3))
    want[p] = np.linalg.solve(d @ d.T, b[p])
    got = pairs[bs, "lower", "f64"][1].solve_lltx(b, perm=perm).numpy()
    assert _rel(got, want) < 1e-10


def test_refinement_tightens_f32(pairs, factor):
    r, c, v, b, _ = factor
    d = _dense(r, c, v, N)
    slv = pairs[64, "lower", "f32"][1]
    x0 = slv.solve(b[:, 0]).double().numpy()
    x1 = slv.solve(b[:, 0], refine=1).double().numpy()
    r0 = np.linalg.norm(d @ x0 - b[:, 0])
    r1 = np.linalg.norm(d @ x1 - b[:, 0])
    assert r1 <= r0 and r1 / np.linalg.norm(b[:, 0]) < 1e-5


def test_matvec_matches_reference_and_dense(pairs, factor):
    r, c, v, b, _ = factor
    d = _dense(r, c, v, N)
    for prec in ("f64", "f32"):
        r_slv, p_slv = pairs[300, "lower", prec]
        for trans, a in (("n", d), ("t", d.T)):
            got = p_slv.matvec(b, trans=trans)
            assert _rel(got, r_slv.matvec(b, trans=trans)) < \
                PRECISIONS[prec][2]
            assert _rel(got, a @ b) < (1e-14 if prec == "f64" else 1e-6)
            assert p_slv.matvec(b[:, 0], trans=trans).shape == (N,)


@pytest.fixture(scope="module")
def f64_grade():
    """(reference, port) float32 solvers at n = 3,000 and their float64-grade
    results: solve_f64 'n' and 't' on 3 columns, solve_lltx_f64 with and
    without a permutation."""
    n = 3000
    r, c, v = ref.simulate_pedigree_factor(n, avg_offdiag=9, seed=3)
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, 3))
    perm = rng.permutation(n) + 1
    out = {}
    for name, slv in (
            ("ref", ref.SparseTriangularSolver(r, c, v, n, bs=128,
                                               dtype=jnp.float32)),
            ("port", ps.SparseTriangularSolver(r, c, v, n, bs=128,
                                               dtype=torch.float32,
                                               device=CPU))):
        out[name] = {"n": slv.solve_f64(b, trans="n"),
                     "t": slv.solve_f64(b, trans="t"),
                     "lltx": slv.solve_lltx_f64(b[:, 0]),
                     "lltx perm": slv.solve_lltx_f64(b, perm=perm)}
    return (r, c, v, b, perm), out


@pytest.mark.parametrize("case", ["n", "t", "lltx", "lltx perm"])
def test_f64_grade_matches_reference(f64_grade, case):
    (r, c, v, b, perm), out = f64_grade
    n = len(b)
    x, rel = out["port"][case]
    x_ref, rel_ref = out["ref"][case]
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    assert x.shape == x_ref.shape
    assert rel <= 1e-12 and rel_ref <= 1e-12
    assert _rel(x, x_ref) < 1e-10
    # the residual, recomputed against the float64 triplets
    from scipy import sparse as sp
    a = sp.csr_matrix((v, (r - 1, c - 1)), shape=(n, n))
    if case == "n":
        res = b - a @ x
    elif case == "t":
        res = b - a.T @ x
    elif case == "lltx":
        res = b[:, 0] - a @ (a.T @ x)
    else:
        p = perm - 1
        res = b[p] - a @ (a.T @ x[p])
    bn = np.linalg.norm(b[:, 0] if case == "lltx" else b)
    assert np.linalg.norm(res) / bn <= 1e-12


def test_f64_solver_skips_inner_refinement(pairs, factor):
    """A float64 solver is already exact grade: one sweep, no refinement."""
    b = factor[3]
    slv = pairs[300, "lower", "f64"][1]
    x, rel = slv.solve_f64(b)
    assert rel <= 1e-12
    np.testing.assert_array_equal(x, slv.solve(b).numpy())


@pytest.mark.parametrize("bs", [96, 128])   # 96 pads to a power of two
def test_device_analysis_matches_host_and_scipy(bs):
    import scipy.sparse as sp
    from scipy.sparse import linalg as spl

    n = 3000
    r, c, v = ps.simulate_pedigree_factor(n, avg_offdiag=5, seed=9)
    b = np.random.default_rng(7).standard_normal((n, 3)).astype(np.float32)
    s_dev = ps.SparseTriangularSolver(r, c, v, n, bs=bs, dtype=torch.float32,
                                      device=CPU)
    s_host = ps.SparseTriangularSolver(r, c, v, n, bs=bs, dtype=torch.float32,
                                       device_analysis=False, device=CPU)
    x_dev = s_dev.solve_lltx(b, refine=1).double().numpy()
    x_host = s_host.solve_lltx(b, refine=1).double().numpy()
    ll = sp.coo_matrix((v, (r - 1, c - 1)), shape=(n, n)).tocsr()
    want = spl.spsolve_triangular(
        sp.csr_matrix(ll.T),
        spl.spsolve_triangular(ll, b.astype(np.float64), lower=True),
        lower=False)
    assert _rel(x_dev, want) < 1e-4
    assert _rel(x_dev, x_host) < 1e-4


@pytest.mark.parametrize("bs,lower", [(64, True), (300, True), (300, False)])
def test_assemble_invert_device_matches_host_inverse(bs, lower):
    """The float32 device analysis (scatter, batched inverse of 32 x 32
    bases, doubling, one Newton step) against the float64 host inversion
    and the reference's float32 device analysis; the host inversion equals
    the reference's bit for bit."""
    n = 1000
    r, c, v = ps.simulate_pedigree_factor(n, avg_offdiag=8, seed=2,
                                          index_base=0)
    if not lower:
        r, c = c, r
    nb = -(-n // bs)
    diag = (r // bs) == (c // bs)
    dr, dc, dv = r[diag], c[diag], v[diag]
    pad = np.arange(n, nb * bs)
    blocks = np.zeros((nb, bs, bs))
    np.add.at(blocks, (dr // bs, dr % bs, dc % bs), dv)
    blocks[pad // bs, pad % bs, pad % bs] = 1.0
    host = ps._invert_tri_batched(blocks, lower)
    np.testing.assert_array_equal(host, ref._invert_tri_batched(blocks, lower))
    np.testing.assert_allclose(np.einsum("bij,bjk->bik", blocks, host),
                               np.broadcast_to(np.eye(bs), blocks.shape),
                               atol=1e-12)
    got = ps._assemble_invert_tri_device(
        torch.as_tensor(dr), torch.as_tensor(dc),
        torch.as_tensor(dv, dtype=torch.float32), torch.as_tensor(pad),
        nb=nb, bs=bs, lower=lower)
    assert got.dtype == torch.float32 and got.shape == (nb, bs, bs)
    assert _rel(got, host) < 1e-6
    want = ref._assemble_invert_tri_device(
        jnp.asarray(dr.astype(np.int32)), jnp.asarray(dc.astype(np.int32)),
        jnp.asarray(dv.astype(np.float32)), jnp.asarray(pad.astype(np.int32)),
        nb=nb, bs=bs, lower=lower)
    assert _rel(got, want) < 1e-6


def test_analysis_and_sweeps_turn_tf32_off_and_restore_it(factor):
    """The solver's float32 products never take TF32: the cuBLAS flag reads
    False inside the guard and the caller's value after it (the card tests
    hold the results with the caller's TF32 on)."""
    r, c, v, b, _ = factor
    matmul = torch.backends.cuda.matmul
    was = matmul.allow_tf32
    seen = []
    real_mm = torch.mm

    def mm(*args, **kw):
        seen.append(matmul.allow_tf32)
        return real_mm(*args, **kw)

    want = ps.SparseTriangularSolver(r, c, v, N, bs=64, dtype=torch.float32,
                                     device=CPU).solve(b)
    matmul.allow_tf32 = True
    try:
        ps.torch.mm = mm
        got = ps.SparseTriangularSolver(r, c, v, N, bs=64,
                                        dtype=torch.float32,
                                        device=CPU).solve(b)
        assert matmul.allow_tf32 is True
    finally:
        ps.torch.mm = real_mm
        matmul.allow_tf32 = was
    assert seen and not any(seen)
    assert torch.equal(got, want)


def test_duplicate_coo_entries_coalesce():
    n = 20
    r = np.array([1, 5, 5, 5] + list(range(1, n + 1)))
    c = np.array([1, 2, 2, 3] + list(range(1, n + 1)))
    v = np.array([0.0, 0.3, 0.4, -0.2] + [2.0] * n)
    b = np.random.default_rng(3).standard_normal(n)
    slv = ps.SparseTriangularSolver(r, c, v, n, bs=8, device=CPU)
    np.testing.assert_allclose(_dense(r, c, v, n) @ slv.solve(b).numpy(), b,
                               atol=1e-12)


@pytest.mark.parametrize("args,match", [
    (([], [], [], 3), "empty"),
    (([1, 4], [1, 1], [1.0, 0.5], 3), "out of range"),
    (([0, 1], [1, 1], [1.0, 0.5], 3), "out of range"),
    (([1, 1, 2], [1, 2, 2], [1.0, 0.5, 1.0], 2), "outside the lower"),
    (([1, 2], [1, 1], [1.0, 0.5], 2), "zero diagonal"),
    (([1, 2, 2], [1, 1, 2], [1.0, 0.5, 0.0], 2), "zero diagonal"),
], ids=["empty", "high", "low", "triangle", "missing_diag", "zero_diag"])
def test_constructor_errors_equal_reference(args, match):
    with pytest.raises(ValueError, match=match) as want:
        ref.SparseTriangularSolver(*args)
    with pytest.raises(ValueError) as got:
        ps.SparseTriangularSolver(*args, device=CPU)
    assert str(got.value) == str(want.value)


def test_upper_entries_outside_triangle_and_singular_block():
    with pytest.raises(ValueError, match="outside the upper"):
        ps.SparseTriangularSolver([1, 2, 2], [1, 1, 2], [1.0, 0.5, 1.0], 2,
                                  lower=False, device=CPU)
    with pytest.raises(np.linalg.LinAlgError, match="singular"):
        # a diagonal that coalesces to zero
        ps.SparseTriangularSolver([1, 1, 2], [1, 1, 2], [1.0, -1.0, 1.0], 2,
                                  device=CPU)
    slv = ps.SparseTriangularSolver([1, 2], [1, 2], [1.0, 1.0], 2, device=CPU)
    with pytest.raises(ValueError, match="trans"):
        slv.solve(np.ones(2), trans="x")


def test_free_releases_and_defaults():
    r, c, v = ps.simulate_pedigree_factor(10, seed=0)
    slv = ps.SparseTriangularSolver(r, c, v, 10, device=CPU)
    assert slv._dtype == torch.float64 and slv.bs == 10   # bs capped at n
    slv.free()
    assert slv._dinv is None and slv._host64 is None and slv._fwd is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ps.SparseTriangularSolver(r, c, v, 10)


def test_resilience_repeated_solves():
    """Repeated solves on one handle neither drift nor change."""
    n = 500
    r, c, v = ps.simulate_pedigree_factor(n, avg_offdiag=6, seed=6)
    slv = ps.SparseTriangularSolver(r, c, v, n, bs=64, device=CPU)
    b = np.random.default_rng(2).standard_normal(n)
    first = slv.solve_lltx(b)
    for _ in range(20):
        assert torch.equal(slv.solve_lltx(b), first)


def test_every_public_name_of_the_reference():
    """The public names and parameters of the reference's module (names,
    kinds, defaults); the solver adds ``device`` last; exported by
    ``solve`` and the package."""
    for name in ("SparseTriangularSolver", "simulate_pedigree_factor"):
        want = inspect.signature(getattr(ref, name)).parameters
        got = inspect.signature(getattr(ps, name)).parameters
        assert [(k, p.kind, p.default) for k, p in got.items()][:len(want)] \
            == [(k, p.kind, p.default) for k, p in want.items()], name
        assert list(got)[len(want):] == (
            ["device"] if name == "SparseTriangularSolver" else []), name
    for meth in ("matvec", "solve", "solve_lltx", "solve_f64",
                 "solve_lltx_f64", "free"):
        want = inspect.signature(getattr(ref.SparseTriangularSolver, meth))
        got = inspect.signature(getattr(ps.SparseTriangularSolver, meth))
        assert [(k, p.default) for k, p in got.parameters.items()] == \
            [(k, p.default) for k, p in want.parameters.items()], meth
    from miraculix_tpu_torch import solve
    assert solve.SparseTriangularSolver is ps.SparseTriangularSolver
    assert mt.SparseTriangularSolver is ps.SparseTriangularSolver
