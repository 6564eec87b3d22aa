"""One-column products on CPU tensors over long contractions.

A one-column RHS makes a CPU matmul one long dot; summed in float32 over
tens of thousands of positive terms on one thread it drifts 5e-6 to 2e-5
from the float64 product.  The plain versions sum in float64 and round
once, so ``dgemm`` at the fast and f32 tiers and ``grm_yang`` (whose
u = Z W (2f) is such a product) stay within the reference tests' 5e-6 of
max of their float64 definitions on a panel of 64,000 SNPs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.io import bed as pt_bed  # noqa: E402

CPU = "cpu"
RTOL = 5e-6          # tests/test_grm.py's grm_yang bound, relative to max
N_INDIV, N_SNPS = 200, 64000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread, as the suite's other port tests run: a CPU matmul
    on several threads splits the long dot into shorter sums."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def panel():
    g = pt_bed.simulate_genotypes(N_INDIV, N_SNPS, seed=2)
    return g, mt.from_dense(g, device=CPU)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("precision", ["fast", "f32"])
@pytest.mark.parametrize("trans", ["n", "t"])
def test_dgemm_one_positive_column_float64_grade(panel, trans, precision):
    g, gm = panel
    rows = N_SNPS if trans == "n" else N_INDIV
    b = np.random.default_rng(3).uniform(0.5, 1.0, (rows, 1))
    z = g.astype(np.float64)
    want = z @ b if trans == "n" else z.T @ b
    got = mt.dgemm(gm, torch.as_tensor(b, dtype=torch.float32), trans=trans,
                   center=False, precision=precision)
    assert _rel(got.numpy(), want) < RTOL


def test_grm_yang_float64_grade(panel):
    g, gm = panel
    f = g.mean(axis=0, dtype=np.float64) / 2.0
    pq2 = 2.0 * f * (1.0 - f)
    use = pq2 > 1e-12
    zc = (g[:, use] - 2.0 * f[use]) / np.sqrt(pq2[use])
    want = zc @ zc.T / use.sum()
    assert _rel(mt.grm_yang(gm).numpy(), want) < RTOL
