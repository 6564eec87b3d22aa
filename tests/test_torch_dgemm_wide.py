"""The port's wide schedule and precision tiers against miraculix_tpu and the
float64 oracle.

The reference runs its Pallas kernels in interpret mode, as its own tests
run them; the port runs the plain versions of its kernels.  Tolerances,
relative to max |reference| (or to the sum of |terms| for raw products):

- fast and f32 tiers: 1e-4 against the reference (its fast tier is a bf16
  hi/lo split), 1e-5 against the f64 oracle (the port's fast tier
  multiplies by the same bf16 hi + lo, its f32 tier by B);
- bf16 tier: 1e-5 against the reference's bf16 tier -- both round B once
  to bf16 and sum in f32, so they agree far inside their shared ~2e-3
  error against the oracle;
- the hi||lo split instance (B4): 3e-6 of the sum of |terms| against the
  oracle, i.e. at split grade, not at bf16 grade.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import ref_impl  # noqa: E402
from miraculix_tpu.ops.dgemm import packed_matmul as ref_pmm  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.ops.dgemm import packed_matmul_plain  # noqa: E402

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

INDIV, SNPS = 70, 400
REF_RTOL = {"fast": 1e-4, "f32": 1e-5, "bf16": 1e-5}
ORACLE_RTOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _center(mode, user):
    return {"rowmeans": True, "none": False, "colmeans": "colmeans",
            "user": user}[mode]


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(INDIV, SNPS, seed=23)
    return g, mx.from_dense(g), mt.from_dense(g, device=CPU)


def _rhs(trans, n, seed):
    rows = SNPS if trans == "n" else INDIV
    return np.random.default_rng(seed).standard_normal((rows, n))


@pytest.mark.parametrize("precision", ["fast", "bf16", "f32"])
@pytest.mark.parametrize("n", [65, 130, 600])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_widths_and_tiers(panel, trans, n, precision):
    """n = 65 is wide at the fast tier and tall at bf16/f32 (limit 128)."""
    g, ref, port = panel
    b = _rhs(trans, n, n)
    want = np.asarray(mx.dgemm(ref, b, trans=trans, precision=precision))
    got = mt.dgemm(port, b, trans=trans, precision=precision).numpy()
    assert _rel(got, want) < REF_RTOL[precision]
    if precision != "bf16":
        oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                       trans=trans)
        assert _rel(got, oracle) < ORACLE_RTOL


@pytest.mark.parametrize("precision", ["fast", "bf16", "f32"])
@pytest.mark.parametrize("mode", ["none", "rowmeans", "colmeans", "user"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_wide_centering(panel, trans, mode, precision):
    g, ref, port = panel
    rng = np.random.default_rng(7)
    b = _rhs(trans, 130, 8)
    center = _center(mode, rng.uniform(0, 2, size=SNPS))
    want = np.asarray(mx.dgemm(ref, b, trans=trans, center=center,
                               precision=precision))
    got = mt.dgemm(port, b, trans=trans, center=center,
                   precision=precision).numpy()
    assert _rel(got, want) < REF_RTOL[precision]
    if precision != "bf16":
        oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                       trans=trans, center=center)
        assert _rel(got, oracle) < ORACLE_RTOL


@pytest.mark.parametrize("precision", ["fast", "bf16", "f32"])
@pytest.mark.parametrize("mode", ["rowmeans", "colmeans"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_wide_missing(trans, mode, precision):
    g = bed.simulate_genotypes(INDIV, SNPS, seed=24, missing_rate=0.08)
    ref = mx.from_dense(g, keep_missing_info=True)
    port = mt.from_dense(g, keep_missing_info=True, device=CPU)
    b = _rhs(trans, 130, 9)
    center = _center(mode, None)
    for ignore in (True, False):
        want = np.asarray(mx.dgemm(ref, b, trans=trans, center=center,
                                   precision=precision,
                                   ignore_missings=ignore))
        got = mt.dgemm(port, b, trans=trans, center=center,
                       precision=precision, ignore_missings=ignore).numpy()
        assert _rel(got, want) < REF_RTOL[precision]
    if mode == "rowmeans" and precision != "bf16":
        oracle = ref_impl.dgemm_oracle(g, b, np.asarray(ref.freq, np.float64),
                                       trans=trans, respect_missings=True)
        assert _rel(got, oracle) < ORACLE_RTOL


@pytest.mark.parametrize("n,kw", [
    (32, dict(split=True)),                       # B4: host hi||lo
    (65, dict(split=True)),                       # B3: in-kernel split
    (65, dict(split=True, per_plane=False)),      # B11
    (65, dict(single_bf16=True)),                 # B5 bf16
    (130, dict(split=False)),                     # B5 f32
    (600, dict(split=True)),                      # reference: 512 + 88
])
def test_packed_matmul_matches_reference(panel, n, kw):
    g, ref, port = panel
    b = _rhs("n", n, n + 1).astype(np.float32)
    want = np.asarray(ref_pmm(ref.zq_n, b, interpret=True, **kw))
    got = mt.packed_matmul(port.zq_n, torch.from_numpy(b), **kw)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) < (1e-5 if kw.get("single_bf16")
                                      else 1e-4)
    dense = np.zeros((want.shape[0], SNPS))
    dense[:INDIV] = np.where(g == 3, 0, g)
    if not kw.get("single_bf16"):
        assert _rel(got.numpy(), dense @ b.astype(np.float64)) < ORACLE_RTOL


def test_bf16_tier_really_rounds(panel):
    """The bf16 tier rounds B once to bf16 as the reference does: it agrees
    with the reference's bf16 tier at 1e-5 while both stand ~1e-3 off the
    f32 tier."""
    _, ref, port = panel
    # wide and tall, both orientations (the reference's CPU backend has no
    # bf16 x bf16 -> f32 dot for its tall 'n' bf16 kernel at some widths,
    # e.g. 32 and 128, so those are not compared)
    for n, trans in ((130, "n"), (600, "t"), (65, "n"), (100, "t"),
                     (1, "n"), (8, "t")):
        b = _rhs(trans, n, 3 * n)
        got = mt.dgemm(port, b, trans=trans, precision="bf16").numpy()
        want = np.asarray(mx.dgemm(ref, b, trans=trans, precision="bf16"))
        exact = mt.dgemm(port, b, trans=trans, precision="f32").numpy()
        assert _rel(got, want) < 1e-5
        assert _rel(got, exact) > 1e-4


@pytest.mark.parametrize("n", [1, 32, 64])
def test_hilo_split_does_not_fold(panel, n):
    """B4's hi||lo instance keeps both halves: split-grade error (<= 3e-6
    of the sum of |terms|, measured ~7e-7) where plain bf16 is ~4e-4 off."""
    g, _, port = panel
    b = torch.from_numpy(_rhs("n", n, 5 * n).astype(np.float32))
    got = packed_matmul_plain(port.zq_n, b, split=True).double()[:INDIV]
    z = torch.from_numpy(np.where(g == 3, 0, g).astype(np.float64))
    exact = z @ b.double()
    scale = (z @ b.double().abs()).max()
    assert float((got - exact).abs().max()) <= 3e-6 * float(scale)
    single = packed_matmul_plain(port.zq_n, b, single_bf16=True).double()
    assert float((single[:INDIV] - exact).abs().max()) > 1e-4 * float(scale)
