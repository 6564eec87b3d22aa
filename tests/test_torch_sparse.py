"""The port's ops/sparse and the missing-genotype corrections against
miraculix_tpu.

The reference runs as its own tests run it (Pallas interpret mode on the
CPU, x64 on).  ``sparse_times_geno`` is compared over its whole grid of
orientations, methods and tiers at the reference test's atol 1e-4.  The
reference's f64 path rounds S to f32 and the port's keeps it in float64, so
S holds dyadic values (exact in f32) and the f64 tier also meets a float64
oracle at 1e-12.  The corrected GRM/LD family is held to the reference at
its tolerances: 1e-4 (tests/test_missing_grm.py) and 5e-6 relative
(tests/test_grm.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import grm as ref_grm  # noqa: E402
from miraculix_tpu.ops import sparse as ref_sparse  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.ops import sparse as pt_sparse  # noqa: E402

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


def _random_csr(rng, n_rows, n_cols, density=0.25):
    """1-based CSR of a random S with dyadic values (exact in f32)."""
    s = (rng.random((n_rows, n_cols)) < density) * rng.integers(
        -16, 17, size=(n_rows, n_cols)) / 8.0
    ia = np.concatenate([[0], np.cumsum((s != 0).sum(axis=1))]) + 1
    ja = np.nonzero(s)[1] + 1
    return ia, ja, s[s != 0], s


@pytest.fixture(scope="module")
def panels():
    g = bed.simulate_genotypes(40, 48, seed=9)
    return g, mx.from_dense(g), mt.from_dense(g, device=CPU)


METHODS = [("dense", 6), ("segsum", 6), ("auto", 4100)]


@pytest.mark.parametrize("precision", ["f32", "fast", "f64"])
@pytest.mark.parametrize("method,n_idx", METHODS)
@pytest.mark.parametrize("ts,tg", [("n", "n"), ("n", "t"), ("t", "n"),
                                   ("t", "t")])
def test_sparse_times_geno_matches_reference(panels, ts, tg, method, n_idx,
                                             precision):
    """Every orientation x method x tier: "auto" at n_idx > 4096 takes the
    segsum path at f32 and keeps the dense one at the other tiers; "segsum"
    with another tier than f32 raises in both packages."""
    g, ref, port = panels
    rng = np.random.default_rng(n_idx + len(ts + tg + precision))
    contract = 40 if tg == "n" else 48
    if ts == "n":
        ia, ja, a, s = _random_csr(rng, n_idx, contract, density=0.1)
        s_eff = s
    else:
        ia, ja, a, s = _random_csr(rng, contract, n_idx, density=0.1)
        s_eff = s.T
    args = (ia, ja, a, n_idx)
    kw = dict(trans_sparse=ts, trans_geno=tg, precision=precision,
              method=method)
    if method == "segsum" and precision != "f32":
        for fn, panel in ((ref_sparse.sparse_times_geno, ref),
                          (pt_sparse.sparse_times_geno, port)):
            with pytest.raises(ValueError, match="segsum"):
                fn(panel, *args, **kw)
        return
    want = np.asarray(ref_sparse.sparse_times_geno(ref, *args, **kw))
    got = pt_sparse.sparse_times_geno(port, *args, **kw)
    assert got.dtype == (torch.float64 if precision == "f64"
                         else torch.float32)
    z = g.astype(np.float64)
    oracle = s_eff @ (z if tg == "n" else z.T)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4)
    if precision == "f64":
        assert _rel(got.numpy(), oracle) < 1e-12


def test_sparse_errors_and_empty_rows(panels):
    g, ref, port = panels
    rng = np.random.default_rng(3)
    ia, ja, a, _ = _random_csr(rng, 40, 6)
    bad = ja.copy()
    bad[0] = 6 + 1            # 1-based index past n_idx on the output axis
    for fn, panel in ((ref_sparse.sparse_times_geno_segsum, ref),
                      (pt_sparse.sparse_times_geno_segsum, port)):
        with pytest.raises(ValueError, match="out of range"):
            fn(panel, ia, bad, a, 6, trans_sparse="t", trans_geno="n")
    ia, ja, a, _ = _random_csr(rng, 6, 48)
    bad = ja.copy()
    bad[0] = 49               # past the 48 contraction SNPs
    with pytest.raises(ValueError, match="contraction"):
        pt_sparse.sparse_times_geno_segsum(port, ia, bad, a, 6,
                                           trans_sparse="n", trans_geno="t")
    # empty rows at both ends of the CSR
    ia, ja, a = np.array([1, 1, 3, 3]), np.array([2, 5]), np.array([1.0, -2.0])
    want = np.zeros((3, 48))
    want[1] = 1.0 * g[1] - 2.0 * g[4]
    for method in ("segsum", "dense"):
        got = pt_sparse.sparse_times_geno(port, ia, ja, a, 3, method=method)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(ref_sparse.sparse_times_geno_segsum(ref, ia, ja, a, 3)),
        want, atol=1e-5)
    dense = pt_sparse.csr_to_dense(ia, ja, a, 3, 40)
    assert dense.shape == (3, 40) and dense[1, 1] == 1.0 and dense[1, 4] == -2


@pytest.fixture(scope="module")
def missing():
    """tests/test_missing_grm.py's panel: 150 x 400, 5% missing."""
    g = bed.simulate_genotypes(150, 400, seed=21, missing_rate=0.05)
    ref = mx.from_dense(g, keep_missing_info=True)
    f = np.asarray(ref.freq, np.float64)
    zc = np.where(g == 3, 0.0, g.astype(np.float64) - 2.0 * f[None, :])
    return g, ref, mt.from_dense(g, keep_missing_info=True, device=CPU), zc


@pytest.mark.parametrize("scale", [True, False])
def test_grm_missing_correction_matches_reference(missing, scale):
    g, ref, port, zc = missing
    want = np.asarray(mx.grm(ref, scale=scale), np.float64)
    got = mt.grm(port, scale=scale).numpy()
    assert _rel(got, want) < 1e-4
    oracle = zc @ zc.T
    if scale:
        f = np.asarray(ref.freq, np.float64)
        oracle = oracle / (2.0 * np.sum(f * (1.0 - f)))
    assert _rel(got, oracle) < 1e-4
    np.testing.assert_array_equal(got, mt.grm(port, scale=scale,
                                              correct_missing=True).numpy())


def test_grm_pair_denominator_matches_reference(missing):
    """plink --make-rel missingness: each pair over its own co-called
    sum of 2pq (tests/test_grm.py, 5e-6 relative)."""
    g, ref, port, zc = missing
    want = np.asarray(mx.grm(ref, pair_denominator=True), np.float64)
    got = mt.grm(port, pair_denominator=True).numpy()
    assert _rel(got, want) < 5e-6
    f = np.asarray(ref.freq, np.float64)
    called = (g != 3).astype(np.float64)
    denom = (called * (2.0 * f * (1.0 - f))) @ called.T
    assert _rel(got, (zc @ zc.T) / denom) < 5e-6


@pytest.mark.parametrize("squared", [False, True])
def test_ld_missing_correction_matches_reference(missing, squared):
    g, ref, port, zc = missing
    want = np.asarray(mx.ld(ref, squared=squared), np.float64)
    got = mt.ld(port, squared=squared).numpy()
    assert np.abs(got - want).max() < 1e-4
    cov = zc.T @ zc
    sd = np.sqrt(np.diag(cov))
    sd[sd == 0] = 1.0
    r = cov / np.outer(sd, sd)
    assert np.abs(got - (r * r if squared else r)).max() < 1e-3
    np.testing.assert_allclose(np.diag(mt.ld(port).numpy()), 1.0, atol=1e-6)


@pytest.mark.parametrize("pair_denominator", [False, True])
def test_grm_yang_missing_matches_reference(pair_denominator):
    """GCTA's estimator on a 5%-missing panel with a monomorphic SNP
    (tests/test_grm.py: 5e-6 relative)."""
    g = bed.simulate_genotypes(110, 600, seed=35, missing_rate=0.05)
    g[:, 7] = 0
    ref = mx.from_dense(g, keep_missing_info=True)
    port = mt.from_dense(g, keep_missing_info=True, device=CPU)
    want = np.asarray(ref_grm.grm_yang(ref, pair_denominator=pair_denominator),
                      np.float64)
    got = mt.grm_yang(port, pair_denominator=pair_denominator).numpy()
    assert _rel(got, want) < 5e-6
    np.testing.assert_array_equal(got, got.T)


def test_missing_aware_entry_points_on_a_clean_panel():
    """keep_missing_info=True on a panel with no missing call
    (tests/test_missing_grm.py): the corrected paths equal the plain ones."""
    g = bed.simulate_genotypes(24, 64, seed=6)
    ref = mx.from_dense(g, keep_missing_info=True)
    port = mt.from_dense(g, keep_missing_info=True, device=CPU)
    plain = mt.from_dense(g, device=CPU)
    assert port.miss_rows_n is not None and port.miss_rows_n.numel() == 0
    np.testing.assert_allclose(mt.grm(port).numpy(), mt.grm(plain).numpy(),
                               atol=1e-4)
    got = mt.grm(port, pair_denominator=True).numpy()
    assert _rel(got, np.asarray(mx.grm(ref, pair_denominator=True))) < 5e-6
    np.testing.assert_allclose(mt.ld(port, correct_missing=True).numpy(),
                               mt.ld(plain).numpy(), atol=1e-6)
    np.testing.assert_allclose(
        mt.grm_yang(port, pair_denominator=True).numpy(),
        mt.grm_yang(plain).numpy(), atol=1e-5)
