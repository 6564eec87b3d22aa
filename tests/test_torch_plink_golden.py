"""The port's GRM and LD against the PLINK-formula oracle fixtures in
tests/data/ (an independent numpy implementation of PLINK's documented
formulas, tests/data/make_plink_golden.py), at the criteria of the
reference's tests/test_plink_golden.py: ``plink --make-rel square cov``
(Frobenius < 1e-4), ``plink --r square`` (max < 1e-4), the pair-masked
``--make-rel`` on a 6%-missing panel (max < 3e-5, Frobenius < 1e-3), and
the fixture's frequencies."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from miraculix_tpu_torch import from_bed, grm, grm_yang, ld  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
BED = os.path.join(DATA, "golden_panel.bed")
CPU = "cpu"

if not os.path.exists(BED):   # deterministic, independent of both packages
    import subprocess
    import sys

    subprocess.run([sys.executable, os.path.join(DATA, "make_plink_golden.py")],
                   check=True)


@pytest.fixture(scope="module")
def panel():
    return from_bed(BED, device=CPU)


def test_grm_matches_plink_make_rel_cov(panel):
    g1 = grm(panel, scale=False).numpy().astype(np.float64) / panel.snps
    g2 = np.load(os.path.join(DATA, "golden_rel_cov.npy"))
    assert np.linalg.norm(g1 - g2) < 1e-4


def test_ld_matches_plink_r(panel):
    r1 = ld(panel).numpy().astype(np.float64)
    r2 = np.load(os.path.join(DATA, "golden_r.npy"))
    assert np.abs(r1 - r2).max() < 1e-4


def test_grm_matches_plink_make_rel_pair_masked():
    gm = from_bed(os.path.join(DATA, "golden_panel_missing.bed"),
                  keep_missing_info=True, device=CPU)
    g1 = grm_yang(gm, pair_denominator=True).numpy().astype(np.float64)
    g2 = np.load(os.path.join(DATA, "golden_rel_std_missing.npy"))
    assert np.abs(g1 - g2).max() < 3e-5
    assert np.linalg.norm(g1 - g2) < 1e-3


def test_fixture_freq_roundtrip(panel):
    g, _ = bed.read_bed_genotypes(BED)
    assert (g != 3).all()
    np.testing.assert_allclose(panel.freq.numpy(), g.mean(axis=0) / 2.0,
                               atol=1e-6)
