"""The port's GWAS layer and subset_snps against miraculix_tpu.

One 300 x 2,000 panel with three covariates; gwas_mixed samples 64 SNPs, so
its block CG runs 65 columns: the wide schedule on both sides (the
reference's B3 in interpret mode, the port's plain wide product).  The scan
statistics agree within 1e-4 relative to their largest value (measured
~5e-6: both sides multiply in f32 and finish in numpy float64).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import gwas as ref_gwas  # noqa: E402
from miraculix_tpu.geno import subset_snps as ref_subset  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gwas as pt_gwas  # noqa: E402

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

INDIV, SNPS = 300, 2000
RTOL = 1e-4
CG_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1e-30, np.abs(want).max())


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(INDIV, SNPS, seed=41)
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.5, seed=4)
    cov = np.random.default_rng(5).standard_normal((INDIV, 3))
    return mx.from_dense(g), mt.from_dense(g, device=CPU), y, cov


def _words(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


_SUBSETS = {
    "sorted": lambda rng, s: np.sort(rng.choice(s, 64, replace=False)),
    "unsorted_dups": lambda rng, s: rng.integers(0, s, 50),
    "block": lambda rng, s: np.arange(s // 3, s // 3 + 700),
    "one": lambda rng, s: np.array([s - 1]),
    "all": lambda rng, s: np.arange(s),
}


@pytest.mark.parametrize("missing_rate", [0.0, 0.05])
@pytest.mark.parametrize("which", sorted(_SUBSETS))
def test_subset_snps_matches_reference(which, missing_rate):
    g = bed.simulate_genotypes(37, 1100, seed=43, missing_rate=missing_rate)
    tracked = missing_rate > 0
    ref = mx.from_dense(g, keep_missing_info=tracked)
    port = mt.from_dense(g, keep_missing_info=tracked, device=CPU)
    idx = _SUBSETS[which](np.random.default_rng(44), g.shape[1])
    want, got = ref_subset(ref, idx), mt.subset_snps(port, idx)
    assert (got.snps, got.indiv) == (want.snps, want.indiv)
    np.testing.assert_array_equal(_words(got.zq_n.numpy()),
                                  _words(want.zq_n))
    np.testing.assert_array_equal(_words(got.zq_t.numpy()),
                                  _words(want.zq_t))
    np.testing.assert_array_equal(got.freq.numpy(), np.asarray(want.freq))
    assert got.pseudo_freq is None and want.pseudo_freq is None
    if tracked:
        np.testing.assert_array_equal(got.miss_rows_n.numpy(),
                                      np.asarray(want.miss_rows_n))
        np.testing.assert_array_equal(got.miss_cols_n.numpy(),
                                      np.asarray(want.miss_cols_n))
    else:
        assert got.miss_rows_n is None and want.miss_rows_n is None
    freq = np.linspace(0.1, 0.9, len(idx))
    np.testing.assert_array_equal(
        mt.subset_snps(port, idx, freq=freq).freq.numpy(),
        np.asarray(ref_subset(ref, idx, freq=freq).freq))


def test_subset_snps_rejects_bad_indices(panel):
    port = panel[1]
    for idx in ([], [SNPS], [-1], [[0, 1]]):
        with pytest.raises(ValueError):
            mt.subset_snps(port, idx)


def test_gwas_linear_matches_reference(panel):
    ref, port, y, cov = panel
    want = ref_gwas.gwas_linear(ref, y, covariates=cov)
    got = pt_gwas.gwas_linear(port, y, covariates=cov)
    assert got.df == want.df == INDIV - 4 - 1
    for f in ("beta", "se", "t", "p"):
        assert _rel(getattr(got, f), getattr(want, f)) < RTOL, f


def test_gwas_logistic_matches_reference(panel):
    ref, port, y, cov = panel
    yb = (y > np.median(y)).astype(np.float64)
    want = ref_gwas.gwas_logistic(ref, yb, covariates=cov)
    got = pt_gwas.gwas_logistic(port, yb, covariates=cov)
    for f in ("beta", "se", "t", "p"):
        assert _rel(getattr(got, f), getattr(want, f)) < RTOL, f
    with pytest.raises(ValueError, match="0/1"):
        pt_gwas.gwas_logistic(port, y)


def _same_mixed(got, want):
    for f in ("beta", "chi2", "p"):
        assert _rel(getattr(got, f), getattr(want, f)) < RTOL, f
    assert abs(got.gamma - want.gamma) < RTOL * abs(want.gamma)
    assert abs(got.cg_iterations - int(want.cg_iterations)) <= 1
    assert np.all(got.residual_norm <= CG_TOL)


def test_gwas_mixed_matches_reference(panel):
    ref, port, y, cov = panel
    want = ref_gwas.gwas_mixed(ref, y, covariates=cov, n_gamma_snps=64,
                               tol=CG_TOL, seed=6)
    got = pt_gwas.gwas_mixed(port, y, covariates=cov, n_gamma_snps=64,
                             tol=CG_TOL, seed=6)
    _same_mixed(got, want)


def test_gwas_mixed_loco_matches_reference(panel):
    ref, port, y, cov = panel
    chrom = np.repeat(np.array(["1", "2", "X"]), [700, 700, 600])
    want = ref_gwas.gwas_mixed_loco(ref, y, chrom, covariates=cov,
                                    tol=CG_TOL, seed=7)
    got = pt_gwas.gwas_mixed_loco(port, y, chrom, covariates=cov,
                                  tol=CG_TOL, seed=7)
    _same_mixed(got, want)
    assert len(got.residual_norm) == 3
    with pytest.raises(ValueError, match="one label per SNP"):
        pt_gwas.gwas_mixed_loco(port, y, chrom[:-1])


@pytest.mark.parametrize("scan", ["gwas_linear", "gwas_logistic",
                                  "gwas_mixed", "gwas_mixed_loco"])
def test_gwas_rejects_other_containers(scan):
    args = (np.zeros(4),) if scan != "gwas_mixed_loco" else \
        (np.zeros(4), np.zeros(4))
    with pytest.raises(TypeError, match="not a genotype container"):
        getattr(mt, scan)(object(), *args)
