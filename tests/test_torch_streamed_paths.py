"""The streamed branches of the port's gblup, gwas and ssgblup modules on a
StreamedGeno against the reference's streamed calls on the same .bed
filesets (chunks of 256 SNPs, the last ragged), as tests/test_gblup.py,
tests/test_gwas.py and tests/test_ssgblup.py run the reference.

Tolerances: g_hat within 1e-3 of max |reference|; AI-REML h2 within 1e-4
absolute with the same AI steps; the GWAS statistics within 1e-4 of max
|reference|; single-step EBVs within 1e-3 of max and the outer iterations
within 2; multi-trait REML components within 1e-4 in both regimes of the
streamed V-solve (every chunk cached, or chunks streaming: forced by a
budget of one chunk), against the reference and the host float64 loop.
Each reference call is made once per module.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu import gwas as ref_gwas  # noqa: E402
from miraculix_tpu import pedigree as ref_ped  # noqa: E402
from miraculix_tpu import ssgblup as ref_ss  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.streamed import StreamedGeno as RefStreamed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels, streamed  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch import gwas as pt_gwas  # noqa: E402
from miraculix_tpu_torch import ssgblup as pt_ss  # noqa: E402

CPU = "cpu"
CHUNK = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _run(fn, *args, **kwargs):
    """(return value, stdout) of one call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kwargs)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """(genotypes, .bed path, reference StreamedGeno, port StreamedGeno,
    phenotype) of a 120 x 700 panel (h2 0.6)."""
    g = ref_bed.simulate_genotypes(120, 700, seed=12)
    path = str(tmp_path_factory.mktemp("sp") / "panel.bed")
    ref_bed.write_bed(path, g)
    y, _ = ref_gblup.simulate_phenotypes(g, h2=0.6, n_qtl=300, seed=5)
    return (g, path, RefStreamed.from_bed(path, chunk_snps=CHUNK),
            mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU), y)


@pytest.fixture(scope="module")
def gblups(panel):
    """(reference, port) gblup and snp_effects on the streamed panels."""
    _, _, ref, port, y = panel
    fits = (ref_gblup.gblup(ref, y, h2=0.5, n_pcs=2, tol=1e-6),
            pt_gblup.gblup(port, y, h2=0.5, n_pcs=2, tol=1e-6))
    return fits, (ref_gblup.snp_effects(ref, fits[0]),
                  pt_gblup.snp_effects(port, fits[1]))


def test_gblup_matches_reference(panel, gblups):
    (want, got), _ = gblups
    assert _rel(got.g_hat, want.g_hat) < 1e-3
    assert _rel(got.fitted, want.fitted) < 1e-3
    assert abs(got.cg_iterations - want.cg_iterations) <= 2
    assert got.converged and got.pcs.shape == (120, 2)
    # the resident panel's fit at the same tolerance
    res = pt_gblup.gblup(mt.from_bed(panel[1], device=CPU), panel[4],
                         h2=0.5, n_pcs=2, tol=1e-6)
    assert _rel(got.g_hat, res.g_hat) < 1e-3


def test_snp_effects_match_reference(gblups):
    _, (want, got) = gblups
    assert got.shape == (700,)
    assert _rel(got, want) < 1e-3


def test_gblup_streamed_takes_cg_only(panel):
    with pytest.raises(ValueError, match="cg"):
        pt_gblup.gblup(panel[3], panel[4], solver="refined")


@pytest.fixture(scope="module")
def remls(panel):
    _, _, ref, port, y = panel
    kw = dict(n_probes=8, seed=3, cg_tol=1e-6)
    return (ref_gblup.estimate_h2_reml(ref, y, **kw),
            pt_gblup.estimate_h2_reml(port, y, **kw))


def test_estimate_h2_reml_matches_reference(remls):
    (h_ref, d_ref), (h, d) = remls
    assert abs(h - h_ref) < 1e-4
    assert d["iterations"] == d_ref["iterations"] and d["converged"]
    assert abs(d["cg_iterations"] - d_ref["cg_iterations"]) \
        <= 2 * 2 * d["iterations"]
    assert abs(d["se_h2"] - d_ref["se_h2"]) < 1e-4


def test_estimate_h2_he_and_cross_validate(panel):
    """HE on the streamed panel as the reference's; cross-validation (the
    reference has no streamed branch for it) as the port's resident
    panel's."""
    _, path, ref, port, y = panel
    h_ref, _ = ref_gblup.estimate_h2_he(ref, y)
    h, _ = pt_gblup.estimate_h2_he(port, y)
    assert abs(h - h_ref) < 1e-4
    res = mt.from_bed(path, device=CPU)
    cors, mean = pt_gblup.cross_validate(port, y, k=3)
    cors_r, mean_r = pt_gblup.cross_validate(res, y, k=3)
    assert np.abs(cors - cors_r).max() < 1e-3 and abs(mean - mean_r) < 1e-3


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """Two correlated traits on a 120 x 700 panel
    (tests/test_gblup.py::test_multi_reml_streamed_device_cg_matches_host):
    the reference's streamed fit, and the port's streamed fits with every
    chunk cached and with one chunk cached (the rest streaming), each with
    the STREAM counts of its call, and the host float64 V-solve's fit."""
    n, snps = 120, 700
    geno = ref_bed.simulate_genotypes(n, snps, seed=41)
    path = str(tmp_path_factory.mktemp("mr") / "m.bed")
    ref_bed.write_bed(path, geno)
    rng = np.random.default_rng(4)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, .6], [.6, 1]], size=snps)
    u = zs @ a
    u /= u.std(axis=0)
    ys = 0.75 * u + 0.66 * rng.standard_normal((n, 2))
    kw = dict(n_probes=8, seed=0)
    fits = {"ref": ref_gblup.estimate_multi_reml(
        RefStreamed.from_bed(path, chunk_snps=CHUNK), ys, **kw)}
    for regime, budget in (("cached", None), ("overflow", 1)):
        port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
        if budget:
            assert port.cache_to_device(port.chunks[0].nbytes) == budget
        streamed.reset_stream_counts()
        fits[regime] = (pt_gblup.estimate_multi_reml(port, ys, **kw),
                        dict(streamed.STREAM), port)
    fits["host"] = pt_gblup.estimate_multi_reml(fits["overflow"][2], ys,
                                                device_cg=False, **kw)
    return fits


@pytest.mark.parametrize("regime", ["cached", "overflow"])
def test_multi_reml_streamed_regimes(multi, regime):
    (sg, se, det), counts, port = multi[regime]
    for other in ("ref", "host"):
        sg_o, se_o, det_o = multi[other]
        np.testing.assert_allclose(sg, sg_o, atol=1e-4, err_msg=other)
        np.testing.assert_allclose(se, se_o, atol=1e-4, err_msg=other)
        np.testing.assert_allclose(det["h2"], det_o["h2"], atol=1e-4)
        assert det["iterations"] == det_o["iterations"], other
    assert det["converged"]
    cached = sum(not c.host_resident for c in port.chunks)
    if regime == "cached":   # cache_to_device() held all: nothing copied
        assert cached == 3 and counts["h2d_copies"] == 0
    else:                    # the budget given holds: two chunks stream
        assert cached == 1
        assert counts["h2d_copies"] == 2 * counts["passes"] > 0


def test_multi_v_solver_streamed_overflow_branch(multi):
    """The overflow V-solve against the cached one on the same RHS: the
    device CG with its matvec streaming two chunks, one pass an
    iteration."""
    port = multi["overflow"][2]
    d_g = port.grm_diag() / port.sigma2
    b3 = np.random.default_rng(6).standard_normal((120, 2, 3))
    sg, se = np.array([[0.5, 0.2], [0.2, 0.6]]), np.eye(2) * 0.5
    streamed.reset_stream_counts()
    x_o, it_o = pt_gblup._multi_v_solver(port, 2, d_g, 1e-6, 500)(b3, sg, se)
    assert streamed.STREAM["h2d_copies"] == 2 * streamed.STREAM["passes"]
    assert streamed.STREAM["passes"] == it_o
    x_c, it_c = pt_gblup._multi_v_solver(multi["cached"][2], 2, d_g, 1e-6,
                                         500)(b3, sg, se)
    assert _rel(x_o, x_c) < 1e-4 and abs(it_o - it_c) <= 2


def test_multi_trait_gblup_rejects_streamed(panel):
    y = np.stack([panel[4], panel[4]], axis=1)
    with pytest.raises(TypeError, match="StreamedGeno"):
        pt_gblup.multi_trait_gblup(panel[3], y, np.eye(2), np.eye(2))
    with pytest.raises(TypeError, match="StreamedGeno"):
        ref_gblup.multi_trait_gblup(panel[2], y, np.eye(2), np.eye(2))


@pytest.fixture(scope="module")
def scans(panel):
    g, _, ref, port, y = panel
    yb = (y > np.median(y)).astype(np.float64)
    cov = np.random.default_rng(7).standard_normal((120, 2))
    calls = {
        "gwas_linear": lambda m, p: m.gwas_linear(p, y, covariates=cov),
        "gwas_logistic": lambda m, p: m.gwas_logistic(p, yb),
        "gwas_mixed": lambda m, p: m.gwas_mixed(p, y, h2=0.5, tol=1e-8,
                                                maxiter=3000, seed=3)}
    return {k: (fn(ref_gwas, ref), fn(pt_gwas, port))
            for k, fn in calls.items()}


@pytest.mark.parametrize("scan", ["gwas_linear", "gwas_logistic",
                                  "gwas_mixed"])
def test_gwas_matches_reference(scans, scan):
    want, got = scans[scan]
    stats = ("beta", "se", "t", "p") if scan != "gwas_mixed" else (
        "beta", "chi2", "p")
    for k in stats:
        w, x = getattr(want, k), getattr(got, k)
        assert np.isfinite(x).all(), k
        if k == "p":
            assert np.abs(x - w).max() < 1e-4, k
        else:
            assert _rel(x, w) < 1e-4, k
    if scan == "gwas_mixed":
        assert abs(got.gamma - want.gamma) < 1e-4 * abs(want.gamma)
        assert abs(got.cg_iterations - want.cg_iterations) <= 1
        assert got.residual_norm.shape == (1,)


def test_gwas_mixed_loco_rejects_streamed(panel):
    chrom = np.repeat([1, 2], 350)
    with pytest.raises(TypeError, match="GenoMatrix"):
        pt_gwas.gwas_mixed_loco(panel[3], panel[4], chrom)
    with pytest.raises(TypeError, match="GenoMatrix"):
        ref_gwas.gwas_mixed_loco(panel[2], panel[4], chrom)


N_ANIM, N_GENO, N_SNPS = 120, 48, 600       # tests/test_ssgblup.py's cell
SS_KW = dict(blend=0.05, inner_tol=1e-6, inner_maxiter=4000)


@pytest.fixture(scope="module")
def single_step(tmp_path_factory):
    """The reference tests' 120-animal single-step cell with its 48
    genotyped animals' panel streamed (3 chunks): both H^-1 operators, a
    solve each, and one AI-REML step each."""
    sire, dam = ref_ped.simulate_pedigree(N_ANIM, n_founders=15, seed=4,
                                          unknown_rate=0.1)
    rng = np.random.default_rng(9)
    geno_ids = np.sort(rng.choice(N_ANIM, size=N_GENO, replace=False)) + 1
    geno = ref_bed.simulate_genotypes(N_GENO, N_SNPS, seed=11)
    path = str(tmp_path_factory.mktemp("ss") / "g.bed")
    ref_bed.write_bed(path, geno)
    hinv = (ref_ss.SingleStepHInv(
                sire, dam, RefStreamed.from_bed(path, chunk_snps=CHUNK),
                geno_ids, **SS_KW),
            pt_ss.SingleStepHInv(
                sire, dam, mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK,
                                                    device=CPU),
                geno_ids, **SS_KW))
    rng = np.random.default_rng(3)
    obs = np.sort(rng.choice(N_ANIM, size=90, replace=False)) + 1
    x = np.column_stack([np.ones(90), rng.standard_normal(90)])
    y = x @ [1.0, 0.5] + rng.standard_normal(N_ANIM)[obs - 1] \
        + 0.7 * rng.standard_normal(90)
    solves = tuple(m.ssgblup(y, h, obs_ids=obs, x=x, h2=0.4, tol=1e-6,
                             maxiter=5000)
                   for m, h in zip((ref_ss, pt_ss), hinv))
    remls = tuple(m.estimate_h2_reml_ss(y, h, obs_ids=obs, x=x, n_probes=2,
                                        seed=5, cg_tol=1e-5, max_iter=1)
                  for m, h in zip((ref_ss, pt_ss), hinv))
    return hinv, solves, remls


def test_single_step_hinv_matches_reference(single_step):
    (ref, port), _, _ = single_step
    assert port._kind == "streamed" and ref._kind == "streamed"
    v = np.random.default_rng(0).standard_normal((N_ANIM, 3)).astype(
        np.float32)
    got, want = port.matvec(v), ref.matvec(v)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-4
    v2 = v[:N_GENO, :2]
    assert _rel(port.gw_inv(v2), ref.gw_inv(v2)) < 1e-4


def test_ssgblup_matches_reference(single_step):
    _, (want, got), _ = single_step
    assert np.abs(got.beta - want.beta).max() < 1e-3 * np.abs(want.beta).max()
    assert _rel(got.u, want.u) < 1e-3
    assert abs(got.iterations - want.iterations) <= 2


def test_estimate_h2_reml_ss_matches_reference(single_step):
    _, _, ((h_ref, d_ref), (h, d)) = single_step
    assert d["iterations"] == d_ref["iterations"] == 1
    assert abs(h - h_ref) < 1e-4
    assert abs(d["cg_iterations"] - d_ref["cg_iterations"]) <= 2 * 2


def test_run_gblup_stream_chunk_matches_reference(panel, tmp_path):
    """``run_gblup(stream_chunk=)``: the streamed panel line, and the
    marker effects of the reference's streamed run (phenotypes from the
    .fam, simulated by both from the first SNP window)."""
    _, path, _, _, _ = panel
    eff = {}
    for name, fn, extra in (("ref", ref_gblup.run_gblup, {}),
                            ("port", pt_gblup.run_gblup, dict(device=CPU))):
        out = str(tmp_path / f"eff_{name}.tsv")
        rc, text = _run(fn, path, pcs=0, stream_chunk=CHUNK, tol=1e-6,
                        effects_out=out, **extra)
        assert rc == 0
        eff[name] = (np.loadtxt(out, skiprows=1, usecols=(2, 3)), text)
    (want, ref_text), (got, text) = eff["ref"], eff["port"]
    line = [ln for ln in text.splitlines() if ln.startswith("streamed")]
    assert line == [ln for ln in ref_text.splitlines()
                    if ln.startswith("streamed")]
    assert "3 chunks" in line[0] and "simulated with known BVs" in text
    assert _rel(got[:, 0], want[:, 0]) < 1e-3
    np.testing.assert_array_equal(got[:, 1], want[:, 1])    # freq_train


def test_run_ssgblup_stream_chunk_matches_reference(tmp_path):
    """tests/test_ssgblup.py::test_run_ssgblup_stream_chunk's files: the
    streamed run's EBVs as the reference's streamed run's and the port's
    resident run's."""
    rng = np.random.default_rng(23)
    sire, dam = ref_ped.simulate_pedigree(60, n_founders=10, seed=14)
    labels = [f"s{i + 1}" for i in range(60)]
    pedf = str(tmp_path / "ped.txt")
    with open(pedf, "w") as fh:
        for i in range(60):
            fh.write(f"{labels[i]} "
                     f"{labels[sire[i] - 1] if sire[i] else '0'} "
                     f"{labels[dam[i] - 1] if dam[i] else '0'}\n")
    geno = ref_bed.simulate_genotypes(25, 300, seed=5)
    bedp = str(tmp_path / "g.bed")
    ref_bed.write_bed(bedp, geno)
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[1] = labels[30 + k]
            fh.write(" ".join(parts) + "\n")
    phenf = str(tmp_path / "y.txt")
    with open(phenf, "w") as fh:
        for i in range(40):
            fh.write(f"{labels[i]} {rng.standard_normal():.5f}\n")

    def ebvs(fn, name, **kw):
        out = str(tmp_path / f"ebv_{name}.tsv")
        rc, _ = _run(fn, bedp, pedf, pheno_path=phenf, out=out, h2=0.4,
                     tol=1e-6, **kw)
        assert rc == 0
        return np.loadtxt(out, skiprows=1, usecols=1)

    want = ebvs(ref_ss.run_ssgblup, "ref", stream_chunk=128)
    got = ebvs(pt_ss.run_ssgblup, "port", stream_chunk=128, device=CPU)
    resident = ebvs(pt_ss.run_ssgblup, "resident", device=CPU)
    assert got.shape == (60,) and np.isfinite(got).all()
    assert _rel(got, want) < 1e-3
    assert _rel(got, resident) < 1e-3


def test_streamed_paths_count_their_products(panel):
    """A streamed GBLUP's chunk products are all the products it runs: on
    a CPU compute device one plain call each (on the card one kernel
    launch each, chip_smoke.py)."""
    _, _, _, port, y = panel
    streamed.reset_stream_counts()
    _kernels.reset_launch_counts()
    pt_gblup.gblup(port, y, h2=0.5, n_pcs=2, tol=1e-4)
    assert streamed.STREAM["products"] > 0
    assert sum(_kernels.PLAIN_CALLS.values()) == streamed.STREAM["products"]


def test_host_resident_genomatrix_runs_every_path(panel):
    """A host-resident GenoMatrix (``device_put=False``) takes one device
    copy per call and gives the resident panel's results."""
    _, path, _, _, y = panel
    host = mt.from_bed(path, device_put=False, device=CPU)
    res = mt.from_bed(path, device=CPU)
    for fn in (lambda g: pt_gblup.gblup(g, y, n_pcs=2).g_hat,
               lambda g: pt_gwas.gwas_linear(g, y).t,
               lambda g: pt_gblup.estimate_h2_he(g, y)[0]):
        np.testing.assert_array_equal(fn(host), fn(res))


def test_gblup_converges_after_a_column_converged_first(tmp_path):
    """GBLUP's intercept column converges at the first CG iteration (G 1 = 0
    on a clean panel) while the host CG runs on for the other columns, and
    its iterate keeps shrinking: its f32 products must stay out of the
    subnormal range, where the centering's cancellation cost G its
    positivity and this solve diverged (the case it was found on)."""
    g = ref_bed.simulate_genotypes(256, 1024, seed=0)
    y, _ = pt_gblup.simulate_phenotypes(g, h2=0.5, n_qtl=20, seed=0)
    path = str(tmp_path / "c.bed")
    ref_bed.write_bed(path, g)
    port = mt.StreamedGeno.from_bed(path, chunk_snps=CHUNK, device=CPU)
    fit = pt_gblup.gblup(port, y, h2=0.39663898304686124, n_pcs=10)
    assert fit.converged and np.isfinite(fit.beta).all()
    res = pt_gblup.gblup(mt.from_bed(path, device=CPU), y,
                         h2=0.39663898304686124, n_pcs=10)
    assert _rel(fit.g_hat, res.g_hat) < 1e-3
