"""The port's crossproduct and GRM against miraculix_tpu.

Crossproducts are exact integers and must be equal; the 700-row panel pads
to 768 rows, three 256-row tiles, where the reference takes its diagonal and
wrapped off-diagonal kernels.  grm() agrees within atol 1e-4
(tests/test_grm.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed  # noqa: E402
from miraculix_tpu.ops import ref_impl  # noqa: E402
from miraculix_tpu.ops.grm import packed_crossprod as ref_crossprod  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.ops.grm import packed_crossprod_plain  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests


@pytest.mark.parametrize("indiv,snps", [(300, 1000), (700, 1500)])
def test_crossprod_plain_equals_reference(indiv, snps):
    g = bed.simulate_genotypes(indiv, snps, seed=indiv)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    want = np.asarray(ref_crossprod(ref.zq_n, interpret=True))
    got = packed_crossprod_plain(port.zq_n).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mt.snp_crossprod(port).numpy(),
                                  ref_impl.crossprod_oracle(g))


def test_snp_crossprod_snpmajor():
    g = bed.simulate_genotypes(60, 200, seed=8)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    np.testing.assert_array_equal(
        mt.snp_crossprod(port, snpmajor_output=True).numpy(),
        np.asarray(mx.snp_crossprod(ref, snpmajor_output=True)))


@pytest.mark.parametrize("indiv,snps,scale", [(100, 400, True),
                                              (700, 1500, True),
                                              (50, 150, False)])
def test_grm_matches_reference(indiv, snps, scale):
    g = bed.simulate_genotypes(indiv, snps, seed=indiv + 1)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    want = np.asarray(mx.grm(ref, scale=scale), np.float64)
    got = mt.grm(port, scale=scale).numpy().astype(np.float64)
    tol = 1e-4 if scale else 1e-3
    assert np.abs(got - want).max() < tol
    oracle = ref_impl.grm_oracle(g, np.asarray(ref.freq, np.float64),
                                 scale=scale)
    assert np.abs(got - oracle).max() < tol


def test_grm_diag_and_missing_paths():
    # without missing data the sample mean of each SNP is 2f, so grm()'s
    # diagonal is grm_diag's
    clean = mt.from_dense(bed.simulate_genotypes(90, 300, seed=9), device=CPU)
    np.testing.assert_allclose(torch.diagonal(mt.grm(clean)).numpy(),
                               mt.grm_diag(clean, scale=True).numpy(),
                               rtol=1e-5)
    g = bed.simulate_genotypes(90, 300, seed=9, missing_rate=0.05)
    port = mt.from_dense(g, device=CPU)
    tracked = mt.from_dense(g, keep_missing_info=True, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        mt.grm(tracked)
    # as the reference: pair denominators need a panel that tracks missing
    # info (ValueError); on one that does they need ops/sparse
    with pytest.raises(ValueError, match="keep_missing_info"):
        mt.grm(port, pair_denominator=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        mt.grm(tracked, pair_denominator=True)
    with pytest.raises(ValueError, match="keep_missing_info"):
        mt.grm(port, correct_missing=True)
    np.testing.assert_array_equal(mt.grm(tracked, correct_missing=False),
                                  mt.grm(port))


def test_crossprod_capacity_guard():
    with pytest.raises(ValueError, match="overflow"):
        packed_crossprod_plain(torch.zeros((1, 2 ** 25), dtype=torch.int32))
