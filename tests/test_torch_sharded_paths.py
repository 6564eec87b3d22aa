"""The sharded branches of the port's gblup module (GBLUP, marker effects,
HE, AI-REML and cross-validation) on a ShardedGeno (2 CPU shards) and a
ShardedGeno2D (2 x 2) against the reference's sharded branch of the same
call on the same panel (its virtual CPU devices), and against the port's
resident GenoMatrix.  The reference's ``cross_validate`` has no sharded
branch (its fold operator is the single-panel matvec), so the port's
sharded CV is held to the reference's CV on the resident panel of the
same genotypes.  The multi-trait, GWAS and single-step branches are in
test_torch_sharded_multitrait.py, test_torch_sharded_gwas.py and
test_torch_sharded_ssgblup.py (split so that the reference's shard_map
calls, 4-30 s each here, spread over test workers).

Tolerances, as the port's resident and streamed tests hold these
functions: g_hat and marker effects within 1e-3 of max |reference|, CG
totals within 2 a solve; h2 (HE, AI-REML) within 1e-4 with the same AI
steps; CV correlations within 1e-3.  Each reference call is made once per
module.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import parallel as rpar  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels, parallel  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch import gwas as pt_gwas  # noqa: E402
from miraculix_tpu_torch import ssgblup as pt_ss  # noqa: E402

CPU = "cpu"
N, S = 120, 700
KINDS = ("1d", "2d")
REML_KW = dict(n_probes=8, seed=3, cg_tol=1e-6)


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
    """(genotypes, phenotype, {kind: (reference, port)} containers, the
    port's resident panel) of a 120 x 700 panel (h2 0.6)."""
    g = ref_bed.simulate_genotypes(N, S, seed=12)
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.6, n_qtl=300, seed=5)
    conts = {
        "1d": (rpar.shard_genotypes(g, rpar.make_mesh(2)),
               parallel.shard_genotypes(g, parallel.make_mesh(
                   devices=[CPU] * 2))),
        "2d": (rpar.shard_genotypes_2d(g, rpar.make_mesh_2d(4)),
               parallel.shard_genotypes_2d(g, parallel.make_mesh_2d(
                   devices=[CPU] * 4)))}
    return g, y, conts, mt.from_dense(g, device=CPU)


@pytest.fixture(scope="module")
def gblups(panel):
    """{kind: (reference fit, port fit)} and the port's resident fit."""
    _, y, conts, res = panel
    kw = dict(h2=0.5, n_pcs=2, tol=1e-6)
    out = {k: (ref_gblup.gblup(r, y, **kw), pt_gblup.gblup(p, y, **kw))
           for k, (r, p) in conts.items()}
    out["resident"] = pt_gblup.gblup(res, y, **kw)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_gblup_matches_reference(gblups, kind):
    want, got = gblups[kind]
    assert _rel(got.g_hat, want.g_hat) < 1e-3
    assert _rel(got.fitted, want.fitted) < 1e-3
    assert abs(got.cg_iterations - want.cg_iterations) <= 4
    assert got.converged and got.pcs.shape == (N, 2)
    assert _rel(got.g_hat, gblups["resident"].g_hat) < 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_snp_effects(panel, gblups, kind):
    """alpha = Z_c^T u / sigma2 against the reference's sharded
    snp_effects, its float64 definition and the resident panel's."""
    g, _, conts, res = panel
    r, p = conts[kind]
    fit_r, fit = gblups[kind]
    got = pt_gblup.snp_effects(p, fit)
    f = res.freq.numpy().astype(np.float64)
    want = (g - 2.0 * f).T @ fit.u / float(res.sigma2)
    assert got.shape == (S,) and _rel(got, want) < 1e-5
    assert _rel(got, ref_gblup.snp_effects(r, fit_r)) < 1e-3
    resident = pt_gblup.snp_effects(res, gblups["resident"])
    assert _rel(got, resident) < 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_gblup_sharded_takes_cg_only(panel, kind):
    r, p = panel[2][kind]
    for solver in ("dense", "refined"):
        with pytest.raises(ValueError, match="cg"):
            pt_gblup.gblup(p, panel[1], solver=solver)
    with pytest.raises(ValueError, match="cg"):
        ref_gblup.gblup(r, panel[1], solver="dense")


def test_variance_components_1d(panel):
    """HE and AI-REML on the 1D panel against the reference's sharded
    calls and the port's resident panel; CV against the reference's CV on
    the resident panel (it has no sharded CV) and the port's resident."""
    g, y, conts, res = panel
    r, p = conts["1d"]
    h_he = pt_gblup.estimate_h2_he(p, y)[0]
    assert abs(h_he - ref_gblup.estimate_h2_he(r, y)[0]) < 1e-4
    assert abs(h_he - pt_gblup.estimate_h2_he(res, y)[0]) < 1e-4
    h, d = pt_gblup.estimate_h2_reml(p, y, **REML_KW)
    assert d["converged"]
    for h_w, d_w in (ref_gblup.estimate_h2_reml(r, y, **REML_KW),
                     pt_gblup.estimate_h2_reml(res, y, **REML_KW)):
        assert abs(h - h_w) < 1e-4
        assert d["iterations"] == d_w["iterations"]
        assert abs(d["cg_iterations"] - d_w["cg_iterations"]) \
            <= 2 * 2 * d["iterations"]
        assert abs(d["se_h2"] - d_w["se_h2"]) < 1e-4
    cors, mean = pt_gblup.cross_validate(p, y, k=3)
    for cors_w, mean_w in (ref_gblup.cross_validate(mx.from_dense(g), y,
                                                    k=3),
                           pt_gblup.cross_validate(res, y, k=3)):
        assert np.abs(cors - cors_w).max() < 1e-3
        assert abs(mean - mean_w) < 1e-3


def test_reml_2d_matches_resident(panel):
    """AI-REML on the 2D panel (its ridge CG is the 2D sharded CG) against
    the reference's 2D call and the port's resident panel."""
    _, y, conts, res = panel
    r, p = conts["2d"]
    h, d = pt_gblup.estimate_h2_reml(p, y, **REML_KW)
    for h_w, d_w in (ref_gblup.estimate_h2_reml(r, y, **REML_KW),
                     pt_gblup.estimate_h2_reml(res, y, **REML_KW)):
        assert abs(h - h_w) < 1e-4
        assert d["iterations"] == d_w["iterations"]
        assert abs(d["cg_iterations"] - d_w["cg_iterations"]) \
            <= 2 * 2 * d["iterations"]


def test_gwas_and_single_step_reject_2d(panel):
    _, y, conts, _ = panel
    p = conts["2d"][1]
    with pytest.raises(TypeError, match="ShardedGeno2D"):
        pt_gwas.gwas_linear(p, y)
    with pytest.raises(TypeError, match="ShardedGeno2D"):
        pt_ss.SingleStepHInv(np.zeros(N, int), np.zeros(N, int), p,
                             np.arange(1, N + 1))


def test_sharded_paths_take_plain_versions_on_cpu(panel):
    """On CPU shards the paths run the plain versions (no launch); the
    card's smoke counts the launches."""
    _, y, conts, _ = panel
    _kernels.reset_launch_counts()
    parallel.reset_collective_counts()
    pt_gwas.gwas_linear(conts["1d"][1], y)
    assert not any(_kernels.LAUNCHES.values())
    assert sum(_kernels.PLAIN_CALLS.values()) > 0
    assert parallel.COLLECTIVES["gather_shards"]["calls"] >= 2
