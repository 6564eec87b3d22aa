"""The sharded branches of the port's four GWAS scans on a ShardedGeno (2
CPU shards) against the reference's sharded scans on the same panel (its
virtual CPU devices: the sharded indicator product of the logistic scan,
the sharded Jacobi-PCG of the mixed scan, LOCO's off-chromosome mask
between the passes), and against the port's resident GenoMatrix.

Tolerances, as the port's resident tests hold the scans: every statistic
within 1e-4 of max |reference|, gamma within 1e-4 relative, CG totals
within 2 a solve.  Each reference call is made once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import gwas as ref_gwas  # noqa: E402
from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gwas as pt_gwas  # noqa: E402
from miraculix_tpu_torch import parallel  # noqa: E402

CPU = "cpu"
N, S = 120, 700
SCANS = ("gwas_linear", "gwas_logistic", "gwas_mixed", "gwas_mixed_loco")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def scans():
    """{scan: (reference sharded, port sharded, port resident)} on the
    120 x 700 panel of test_torch_sharded_paths.py."""
    g = ref_bed.simulate_genotypes(N, S, seed=12)
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.6, n_qtl=300, seed=5)
    r = rpar.shard_genotypes(g, rpar.make_mesh(2))
    p = parallel.shard_genotypes(g, parallel.make_mesh(devices=[CPU] * 2))
    res = mt.from_dense(g, device=CPU)
    yb = (y > np.median(y)).astype(np.float64)
    cov = np.random.default_rng(7).standard_normal((N, 2))
    chrom = np.repeat([1, 2, 3], [300, 250, 150])
    calls = {
        "gwas_linear": lambda m, c: m.gwas_linear(c, y, covariates=cov),
        "gwas_logistic": lambda m, c: m.gwas_logistic(c, yb, covariates=cov),
        "gwas_mixed": lambda m, c: m.gwas_mixed(c, y, covariates=cov,
                                                tol=1e-6, maxiter=3000,
                                                seed=3),
        "gwas_mixed_loco": lambda m, c: m.gwas_mixed_loco(
            c, y, chrom, covariates=cov, tol=1e-6, maxiter=3000, seed=3)}
    return {k: (fn(ref_gwas, r), fn(pt_gwas, p), fn(pt_gwas, res))
            for k, fn in calls.items()}


@pytest.mark.parametrize("scan", SCANS)
def test_gwas_matches_reference(scans, scan):
    want, got, resident = scans[scan]
    stats = ("beta", "se", "t") if not scan.startswith("gwas_mixed") \
        else ("beta", "chi2")
    for k in stats:
        x = getattr(got, k)
        assert np.isfinite(x).all(), k
        assert _rel(x, getattr(want, k)) < 1e-4, k
        assert _rel(x, getattr(resident, k)) < 1e-4, k
    if scan.startswith("gwas_mixed"):
        solves = 3 if scan.endswith("loco") else 1
        for w in (want, resident):
            assert abs(got.gamma - w.gamma) < 1e-4 * abs(w.gamma)
            assert abs(got.cg_iterations - w.cg_iterations) <= 2 * solves
        assert got.residual_norm.shape == (solves,)
