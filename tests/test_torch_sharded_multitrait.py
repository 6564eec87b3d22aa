"""The sharded branches of the port's multi-trait REML (the "sharded" and
"sharded2d" kinds of the V-solve), bivariate REML and multi-trait GBLUP
on a ShardedGeno (2 CPU shards) and a ShardedGeno2D (2 x 2) against the
reference's sharded branch of the same call on the same panel (its
virtual CPU devices), and against the port's resident GenoMatrix.

Tolerances, as the port's resident tests hold these functions:
multi-trait components, rg and h2 within 1e-4 with the same AI steps;
multi-trait GBLUP's g_hat within 1e-3 of max |reference|.  Each reference
call is made once per module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch import parallel  # noqa: E402

CPU = "cpu"
N, S = 120, 700
KW = dict(n_probes=8, seed=0)
SU = np.array([[0.6, 0.3], [0.3, 0.5]])
SE = np.array([[0.4, 0.1], [0.1, 0.5]])


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
def panel():
    """({kind: (reference, port)} containers, the port's resident panel,
    two traits at rg 0.6) on the 120 x 700 panel of
    test_torch_sharded_paths.py."""
    g = ref_bed.simulate_genotypes(N, S, seed=12)
    conts = {
        "1d": (rpar.shard_genotypes(g, rpar.make_mesh(2)),
               parallel.shard_genotypes(g, parallel.make_mesh(
                   devices=[CPU] * 2))),
        "2d": (rpar.shard_genotypes_2d(g, rpar.make_mesh_2d(4)),
               parallel.shard_genotypes_2d(g, parallel.make_mesh_2d(
                   devices=[CPU] * 4)))}
    rng = np.random.default_rng(4)
    f = g.mean(axis=0) / 2.0
    zs = (g.astype(np.float64) - 2 * f) / np.sqrt(2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, .6], [.6, 1]], size=S)
    u = zs @ a
    u /= u.std(axis=0)
    traits = 0.75 * u + 0.66 * rng.standard_normal((N, 2))
    return conts, mt.from_dense(g, device=CPU), traits


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_estimate_multi_reml(panel, kind):
    """The port's "sharded" / "sharded2d" V-solve against the reference's
    branch of the same kind and against the resident panel's."""
    conts, res, traits = panel
    r, p = conts[kind]
    sg, se, d = pt_gblup.estimate_multi_reml(p, traits, **KW)
    assert d["converged"]
    for sg_w, se_w, d_w in (ref_gblup.estimate_multi_reml(r, traits, **KW),
                            pt_gblup.estimate_multi_reml(res, traits,
                                                         **KW)):
        np.testing.assert_allclose(sg, sg_w, atol=1e-4)
        np.testing.assert_allclose(se, se_w, atol=1e-4)
        assert d["iterations"] == d_w["iterations"]


def test_bivar_reml_and_multi_trait_gblup_1d(panel):
    conts, res, traits = panel
    r, p = conts["1d"]
    y1, y2 = traits[:, 0], traits[:, 1]
    rg, got = pt_gblup.estimate_bivar_reml(p, y1, y2, **KW)
    for rg_w, want in (ref_gblup.estimate_bivar_reml(r, y1, y2, **KW),
                       pt_gblup.estimate_bivar_reml(res, y1, y2, **KW)):
        assert abs(rg - rg_w) < 1e-4
        for k in ("h2_1", "h2_2"):
            assert abs(got[k] - want[k]) < 1e-4, k
        assert got["iterations"] == want["iterations"]
    yk = traits.copy()
    yk[::7, 1] = np.nan
    m_got = pt_gblup.multi_trait_gblup(p, yk, SU, SE)
    for m_w in (ref_gblup.multi_trait_gblup(r, yk, SU, SE),
                pt_gblup.multi_trait_gblup(res, yk, SU, SE)):
        assert _rel(m_got.g_hat, m_w.g_hat) < 1e-3
        assert _rel(m_got.beta, m_w.beta) < 1e-3
