"""The port's LD family against miraculix_tpu on the same panels.

The reference runs as its own tests run it (Pallas interpret mode on the
CPU); the port runs the plain versions of its crossproduct kernels.  Each
port panel is built both by ``from_dense`` and from the reference
container's state.  Tolerances are the reference tests' (tests/test_grm.py):
ld 1e-4, the banded r 2e-5 (1e-5 on the missing-corrected path), LD scores
rtol 2e-4, ld_blocked 2e-4; prune masks must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import grm as ref_grm  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.ops import grm as pt_grm  # noqa: E402

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

FIELDS = ("zq_n", "zq_t", "freq", "pseudo_freq", "miss_rows_n",
          "miss_cols_n")


def _port(ref, g, build, tracked=False):
    """The port's panel of the reference's ``ref`` (genotypes ``g``)."""
    if build == "from_dense":
        return mt.from_dense(g, keep_missing_info=tracked, device=CPU)
    state = {k: None if getattr(ref, k) is None else np.asarray(getattr(ref, k))
             for k in FIELDS}
    return mt.from_reference_state(dict(state, snps=ref.snps,
                                        indiv=ref.indiv), device=CPU)


def _maxdiff(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


BUILDS = ["from_dense", "from_reference_state"]


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(96, 900, seed=18)
    return g, mx.from_dense(g)


@pytest.fixture(scope="module")
def missing_panel():
    g = bed.simulate_genotypes(120, 900, seed=51, missing_rate=0.05)
    return g, mx.from_dense(g, keep_missing_info=True)


@pytest.mark.parametrize("build", BUILDS)
def test_ld_matches_reference(panel, build):
    g, ref = panel
    port = _port(ref, g, build)
    for squared in (False, True):
        want = np.asarray(mx.ld(ref, squared=squared))
        got = mt.ld(port, squared=squared).numpy()
        assert got.shape == want.shape == (900, 900)
        assert _maxdiff(got, want) < 1e-4
    np.testing.assert_allclose(np.diag(mt.ld(port).numpy()), 1.0, atol=1e-6)


def test_ld_missing_paths(missing_panel):
    g, _ = missing_panel
    tracked = mt.from_dense(g, keep_missing_info=True, device=CPU)
    # corrected by default on a tracked panel, as in the reference
    assert _maxdiff(mt.ld(tracked).numpy(), mx.ld(missing_panel[1])) < 1e-4
    with pytest.raises(ValueError, match="keep_missing_info"):
        mt.ld(mt.from_dense(g, device=CPU), correct_missing=True)
    # the uncorrected path is the reference's
    want = np.asarray(mx.ld(mx.from_dense(g, keep_missing_info=True),
                            correct_missing=False))
    assert _maxdiff(mt.ld(tracked, correct_missing=False).numpy(),
                    want) < 1e-4


@pytest.mark.parametrize("build", BUILDS)
def test_ld_windowed_matches_reference(panel, build):
    g, ref = panel
    port = _port(ref, g, build)
    chrom = np.repeat([3, 1, 2], 300)
    for kw in (dict(), dict(squared=True), dict(chrom=chrom),
               dict(row_block=1024)):
        want = ref_grm.ld_windowed(ref, window=48, **kw)
        got = mt.ld_windowed(port, window=48, **kw)
        assert got.dtype == np.float32 and got.shape == (900, 48)
        assert _maxdiff(got, want) < 2e-5, kw
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("correct", [True, False])
def test_ld_windowed_missing_matches_reference(missing_panel, correct):
    g, ref = missing_panel
    port = _port(ref, g, "from_reference_state")
    want = ref_grm.ld_windowed(ref, window=48, row_block=512,
                               correct_missing=correct)
    got = mt.ld_windowed(port, window=48, row_block=512,
                         correct_missing=correct)
    assert _maxdiff(got, want) < (1e-5 if correct else 2e-5)


def test_missing_indicator_packing_matches_reference(missing_panel):
    g, ref = missing_panel
    port = _port(ref, g, "from_dense", tracked=True)
    for row0, rows in ((0, None), (512, 640)):
        want = ref_grm.missing_indicator_packing_t(ref, row0, rows)
        got = pt_grm.missing_indicator_packing_t(port, row0, rows)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("adjusted", [True, False])
def test_ld_score_matches_reference(panel, adjusted):
    g, ref = panel
    port = _port(ref, g, "from_dense")
    chrom = np.repeat(["b", "a"], 450)
    for kw in (dict(), dict(chrom=chrom), dict(window=2000)):
        kw = dict(dict(window=48, adjusted=adjusted), **kw)
        np.testing.assert_allclose(mt.ld_score(port, **kw),
                                   ref_grm.ld_score(ref, **kw), rtol=2e-4,
                                   atol=2e-4, err_msg=str(kw))


def test_ld_score_corrected_matches_reference(missing_panel):
    g, ref = missing_panel
    port = _port(ref, g, "from_dense", tracked=True)
    for adjusted in (True, False):
        np.testing.assert_allclose(
            mt.ld_score(port, window=32, adjusted=adjusted),
            ref_grm.ld_score(ref, window=32, adjusted=adjusted), rtol=2e-4,
            atol=2e-4)


def _duplicate_panel():
    base = bed.simulate_genotypes(200, 400, seed=5)
    base[:, 100:120] = base[:, 80:100]  # r^2 = 1 pairs, 20 apart
    return base


def _chromosome_panel():
    base = bed.simulate_genotypes(60, 100, seed=3)
    return np.concatenate([base, base], axis=1)  # SNP i == SNP i + 100


@pytest.mark.parametrize("case", ["duplicates", "chromosomes",
                                  "chromosomes_labelled", "missing"])
def test_ld_prune_matches_reference(case, missing_panel):
    kw = dict(window=64, r2_threshold=0.5)
    if case == "duplicates":
        g = _duplicate_panel()
    elif case == "missing":
        g = missing_panel[0]
        kw = dict(window=96, r2_threshold=0.02)
    else:
        g = _chromosome_panel()
        kw = dict(window=128, r2_threshold=0.9)
        if case == "chromosomes_labelled":
            kw["chrom"] = np.array([1] * 100 + [2] * 100)
    tracked = case == "missing"
    ref = mx.from_dense(g, keep_missing_info=tracked)
    want = ref_grm.ld_prune(ref, **kw)
    got = mt.ld_prune(_port(ref, g, "from_reference_state"), **kw)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    if case == "duplicates":
        assert not (got[80:100] & got[100:120]).any()
    elif case == "chromosomes":
        assert (~got).sum() >= 90
    elif case == "chromosomes_labelled":
        assert got.all()
    else:
        assert 0 < (~got).sum() < g.shape[1]   # the threshold bites


@pytest.mark.parametrize("build", BUILDS)
def test_ld_blocked_matches_reference(panel, build):
    g, ref = panel
    port = _port(ref, g, build)
    want = ref_grm.ld_blocked(ref, row_block=512)
    got = mt.ld_blocked(port, row_block=512)
    assert got.dtype == np.float32 and got.shape == (900, 900)
    assert _maxdiff(got, want) < 2e-4
    assert _maxdiff(got, mt.ld(port).numpy()) < 2e-4


def test_ld_slice_end_to_end():
    """ld_windowed -> ld_score -> ld_prune in both packages on one panel
    with planted duplicates and four chromosomes."""
    g = bed.simulate_genotypes(150, 800, seed=61)
    g[:, 1::8] = g[:, 0::8]
    chrom = np.repeat(np.arange(4), 200)
    ref = mx.from_dense(g)
    port = mt.from_dense(g, device=CPU)
    band_ref = ref_grm.ld_windowed(ref, window=64, chrom=chrom)
    band = mt.ld_windowed(port, window=64, chrom=chrom)
    assert _maxdiff(band, band_ref) < 2e-5
    np.testing.assert_allclose(
        mt.ld_score(port, window=64, chrom=chrom),
        ref_grm.ld_score(ref, window=64, chrom=chrom), rtol=2e-4, atol=2e-4)
    keep = mt.ld_prune(port, window=64, r2_threshold=0.2, chrom=chrom)
    np.testing.assert_array_equal(
        keep, ref_grm.ld_prune(ref, window=64, r2_threshold=0.2, chrom=chrom))
    assert (keep[0::8] ^ keep[1::8]).all()   # one of each planted pair
    assert (~keep).sum() == 100
