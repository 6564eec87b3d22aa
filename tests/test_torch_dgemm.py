"""The port's dgemm against miraculix_tpu.dgemm and the float64 oracle.

The reference runs as its own tests run it (Pallas interpret mode on the
CPU); the port runs the plain version of its tall kernel.  Tolerances: 1e-4
relative to max |reference| (tests/test_dgemm.py) and 1e-5 relative to max
|oracle| (the port's plain product is f32, the reference's a bf16 split).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import ref_impl  # noqa: E402
from miraculix_tpu.ops.dgemm import packed_matmul_tall as ref_tall  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.ops.dgemm import packed_matmul_tall_plain  # noqa: E402

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


REF_RTOL, ORACLE_RTOL = 1e-4, 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _oracle_center(mode, user):
    return {"rowmeans": True, "none": False, "colmeans": "colmeans",
            "user": user}[mode]


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(70, 400, seed=21)
    return g, mx.from_dense(g), mt.from_dense(g, device=CPU)


@pytest.mark.parametrize("n", [1, 8, 64])
@pytest.mark.parametrize("mode", ["none", "rowmeans", "colmeans", "user"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_matches_reference(panel, trans, mode, n):
    g, ref, port = panel
    rng = np.random.default_rng(n)
    b = rng.standard_normal((400 if trans == "n" else 70, n))
    user = rng.uniform(0, 2, size=400)
    center = _oracle_center(mode, user)
    want = np.asarray(mx.dgemm(ref, b, trans=trans, center=center))
    got = mt.dgemm(port, b, trans=trans, center=center).numpy()
    assert _rel(got, want) < REF_RTOL
    oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                   trans=trans, center=center)
    assert _rel(got, oracle) < ORACLE_RTOL


@pytest.mark.parametrize("mode", ["rowmeans", "colmeans", "user"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_missing_corrected(trans, mode):
    g = bed.simulate_genotypes(70, 400, seed=22, missing_rate=0.08)
    ref = mx.from_dense(g, keep_missing_info=True)
    port = mt.from_dense(g, keep_missing_info=True, device=CPU)
    rng = np.random.default_rng(3)
    b = rng.standard_normal((400 if trans == "n" else 70, 3))
    center = _oracle_center(mode, rng.uniform(0, 2, size=400))
    want = np.asarray(mx.dgemm(ref, b, trans=trans, center=center,
                               ignore_missings=False))
    got = mt.dgemm(port, b, trans=trans, center=center,
                   ignore_missings=False).numpy()
    assert _rel(got, want) < REF_RTOL
    if mode == "rowmeans":
        oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                       trans=trans, respect_missings=True)
        assert _rel(got, oracle) < ORACLE_RTOL
    # the default keeps missing entries as genotype 0
    want_ign = np.asarray(mx.dgemm(ref, b, trans=trans, center=center))
    assert _rel(mt.dgemm(port, b, trans=trans, center=center).numpy(),
                want_ign) < REF_RTOL


@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_normalize(panel, trans):
    g, ref, port = panel
    b = np.random.default_rng(4).standard_normal((400 if trans == "n" else 70, 2))
    want = np.asarray(mx.dgemm(ref, b, trans=trans, normalize=True))
    got = mt.dgemm(port, b, trans=trans, normalize=True).numpy()
    assert _rel(got, want) < REF_RTOL
    oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                   trans=trans, normalize=True)
    assert _rel(got, oracle) < ORACLE_RTOL


def test_dgemm_fused_centering_large_k():
    """32 x 65536: the reference's fused-centering kernel (>= 65536
    contraction SNPs) against the port, rowmeans and colmeans."""
    g = bed.simulate_genotypes(32, 65536, seed=3)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    b = np.random.default_rng(5).standard_normal((65536, 4)).astype(np.float32)
    for center in (True, "colmeans"):
        want = np.asarray(mx.dgemm(ref, b, trans="n", center=center))
        got = mt.dgemm(port, b, trans="n", center=center).numpy()
        assert _rel(got, want) < REF_RTOL
    oracle = ref_impl.dgemm_oracle(g, b.astype(np.float64),
                                   np.asarray(ref.freq, np.float64))
    assert _rel(mt.dgemm(port, b, trans="n").numpy(), oracle) < ORACLE_RTOL


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_tall_plain_center_vec_matches_reference(panel, trans, n):
    _, ref, port = panel
    zq_ref = ref.zq_t if trans == "n" else ref.zq_n
    zq = port.zq_t if trans == "n" else port.zq_n
    contract = 400 if trans == "n" else 70
    rng = np.random.default_rng(6)
    b = rng.standard_normal((contract, n)).astype(np.float32)
    cv = rng.uniform(0, 2, size=contract).astype(np.float32)
    want_c, want_v = ref_tall(zq_ref, b, center_vec=cv, interpret=True)
    got_c, got_v = packed_matmul_tall_plain(zq, torch.from_numpy(b),
                                            center_vec=torch.from_numpy(cv))
    assert _rel(got_c.numpy(), want_c) < REF_RTOL
    assert _rel(got_v.numpy(), want_v) < REF_RTOL
    zd = mx.io.codec.unpack_planar16(np.asarray(zq_ref), contract,
                                     16 * zq.shape[1]).astype(np.float64)
    assert _rel(got_c.numpy(), zd.T @ b) < ORACLE_RTOL
    assert _rel(got_v.numpy(), cv.astype(np.float64) @ b) < ORACLE_RTOL


def test_dgemm_vector_rhs_and_errors(panel):
    _, _, port = panel
    assert mt.dgemm(port, np.ones(400)).shape == (70, 1)
    with pytest.raises(ValueError, match="rows"):
        mt.dgemm(port, np.ones((70, 2)), trans="n")
    with pytest.raises(ValueError, match="precision"):
        mt.dgemm(port, np.ones((400, 2)), precision="exact")
    # the f64 tier: the caller's B in float64, numpy float64 out, the
    # reference's digits and epilogue
    b = np.random.default_rng(3).standard_normal((400, 2))
    got = mt.dgemm(port, b, precision="f64")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert _rel(got, mx.dgemm(panel[1], b, precision="f64")) < 1e-12
    # wider RHS run on the wide schedule
    assert mt.dgemm(port, np.ones((400, 65))).shape == (70, 65)
