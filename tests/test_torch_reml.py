"""Univariate variance components, cross-validation, GBLUP from a formed
GRM and the ``run_gblup`` pipeline against miraculix_tpu.gblup, on the
tests/test_gblup.py REML panel (160 x 800, seed 11).

Tolerances: h2, s2g, s2e and the SEs within 1e-3 absolute of the
reference; equal AI-step counts; CG totals within 2 a solve; g_hat,
fitted, beta, the marker effects and the CV correlations within 1e-3
relative (the RTOL of test_torch_gblup.py).  Without the reference, the
exact-probe REML lands within 0.01 of the dense profiled-likelihood argmax.
Each reference function is called once per module.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import gblup as ref_gblup  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import gblup as pt_gblup  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests
RTOL = 1e-3
ATOL = 1e-3  # variance components, h2 and their SEs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()


@pytest.fixture(scope="module")
def panel():
    geno = bed.simulate_genotypes(160, 800, seed=11)
    y, _ = ref_gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=400, seed=5)
    return geno, mx.from_dense(geno), mt.from_dense(geno, device=CPU), y


COV = np.random.default_rng(8).standard_normal(160)
REML_CASES = {  # keyword arguments of one estimate_h2_reml call
    "stochastic": dict(n_probes=16, seed=3, cg_tol=1e-6),
    "covariates": dict(covariates=COV, n_probes=16, seed=3),
    "init_h2": dict(n_probes=8, seed=1, init_h2=0.3, max_iter=40),
}


@pytest.fixture(scope="module")
def reml_fits(panel):
    """(reference, port) estimate_h2_reml fits, one call per case."""
    _, ref, port, y = panel
    return {k: (ref_gblup.estimate_h2_reml(ref, y, **kw),
                pt_gblup.estimate_h2_reml(port, y, **kw))
            for k, kw in REML_CASES.items()}


def test_he_matches_reference(panel):
    _, ref, port, y = panel
    h_ref, d_ref = ref_gblup.estimate_h2_he(ref, y, n_probes=16, seed=2)
    h, d = pt_gblup.estimate_h2_he(port, y, n_probes=16, seed=2)
    assert abs(h - h_ref) < ATOL
    for k in ("numerator", "trace_g2_estimate", "diag_sq_sum"):
        assert abs(d[k] - d_ref[k]) < RTOL * abs(d_ref[k]), k
    assert d["n_probes"] == 16


@pytest.mark.parametrize("case", sorted(REML_CASES))
def test_reml_matches_reference(reml_fits, case):
    (h_ref, d_ref), (h, d) = reml_fits[case]
    assert d["converged"] and d_ref["converged"]
    assert abs(h - h_ref) < ATOL
    for k in ("s2g", "s2e", "se_h2"):
        assert abs(d[k] - d_ref[k]) < ATOL, k
    assert d["iterations"] == d_ref["iterations"]
    # two block solves an AI step
    assert abs(d["cg_iterations"] - d_ref["cg_iterations"]) \
        <= 2 * 2 * d["iterations"]
    assert d["exact_traces"] is False and d["n_probes"] == d_ref["n_probes"]


def test_reml_components_recompose(reml_fits, panel):
    y = panel[3]
    _, (h, d) = reml_fits["stochastic"]
    np.testing.assert_allclose(d["vg"] + d["ve"],
                               y.var() * (d["s2g"] + d["s2e"]), rtol=1e-12)
    assert h == pytest.approx(d["s2g"] / (d["s2g"] + d["s2e"]))
    assert np.isfinite(d["se_h2"]) and d["se_h2"] > 0


def _profiled_reml_logl_argmax(geno, freq, y, grid):
    """Exact dense REML oracle: the profiled restricted log-likelihood over
    an h2 grid from the eigendecomposition of the scaled GRM (intercept
    only, the total variance profiled out)."""
    n = geno.shape[0]
    z = np.where(geno == 3, 0, geno).astype(np.float64)
    zc = z - 2.0 * freq
    gs = zc @ zc.T / (2.0 * (freq * (1.0 - freq)).sum())
    w, u = np.linalg.eigh(gs)
    yt = (y - y.mean()) / y.std()
    uy = u.T @ yt
    ux = u.T @ np.ones((n, 1))

    def logl(h2):
        d = h2 * w + (1 - h2)
        v0ix = ux / d[:, None]
        xtvx = ux.T @ v0ix
        beta = np.linalg.solve(xtvx, v0ix.T @ uy)
        ypy = uy @ (uy / d) - (v0ix.T @ uy) @ beta
        st = ypy / (n - 1)
        return -0.5 * ((n - 1) * np.log(st) + np.log(d).sum()
                       + np.linalg.slogdet(xtvx)[1])

    ll = np.array([logl(h) for h in grid])
    return float(grid[ll.argmax()])


def test_reml_exact_probes_at_dense_optimum(panel):
    """Identity probes make every trace exact: AI-REML lands on the dense
    profiled-likelihood maximizer to CG and grid resolution."""
    geno, _, port, y = panel
    n = geno.shape[0]
    h2_exact = _profiled_reml_logl_argmax(
        geno, port.freq.numpy().astype(np.float64), y,
        np.linspace(0.01, 0.99, 393))
    h2, det = pt_gblup.estimate_h2_reml(port, y, probes=np.eye(n),
                                        cg_tol=1e-7)
    assert det["exact_traces"] and det["converged"], det
    assert abs(h2 - h2_exact) < 0.01, (h2, h2_exact)
    assert np.isfinite(det["se_h2"]) and det["se_h2"] > 0


def test_reml_rejects_bad_probes(panel):
    _, _, port, y = panel
    with pytest.raises(ValueError, match="probes"):
        pt_gblup.estimate_h2_reml(port, y, probes=np.eye(10))


def test_cross_validate_matches_reference(panel):
    _, ref, port, y = panel
    c_ref, m_ref = ref_gblup.cross_validate(ref, y, k=3, seed=4)
    c, m = pt_gblup.cross_validate(port, y, k=3, seed=4)
    assert c.shape == (3,)
    assert _rel(c, c_ref) < RTOL
    assert abs(m - m_ref) < RTOL * abs(m_ref)


@pytest.fixture(scope="module")
def from_grm(panel):
    """(reference, port) gblup_from_grm on the reference's scaled GRM, with
    a covariate."""
    _, ref, _, y = panel
    g = np.asarray(mx.grm(ref, scale=True), np.float64)
    kw = dict(h2=0.5, covariates=COV, tol=1e-6)
    return g, (ref_gblup.gblup_from_grm(g, y, **kw),
               pt_gblup.gblup_from_grm(g, y, device=CPU, **kw))


def test_gblup_from_grm_matches_reference(from_grm):
    _, (want, got) = from_grm
    assert got.converged and got.pcs is None
    assert _rel(got.fitted, want.fitted) < RTOL
    assert _rel(got.g_hat, want.g_hat) < RTOL
    assert _rel(got.u, want.u) < RTOL
    assert _rel(got.beta, want.beta) < RTOL
    assert abs(got.cg_iterations - want.cg_iterations) <= 2 * 2


def test_gblup_from_grm_matches_panel_gblup(panel):
    """The port's own GRM (a tensor, which stays on its device) gives the
    packed-panel GBLUP's fit."""
    _, _, port, y = panel
    got = pt_gblup.gblup_from_grm(mt.grm(port, scale=True), y, h2=0.5)
    want = pt_gblup.gblup(port, y, h2=0.5, n_pcs=0, tol=1e-6)
    assert got.converged
    assert _rel(got.fitted, want.fitted) < RTOL
    assert _rel(got.g_hat, want.g_hat) < RTOL


def test_gblup_from_grm_needs_a_device(from_grm, panel, monkeypatch):
    """A numpy GRM goes to the card unless a device is named: without a
    card and without ``device=``, it raises."""
    g, _ = from_grm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_gblup.gblup_from_grm(g, panel[3])
    with pytest.raises(ValueError, match="square"):
        pt_gblup.gblup_from_grm(g[:, :10], panel[3], device=CPU)


def _run(fn, *args, **kwargs):
    """(return value, stdout) of one call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kwargs)
    return rc, out.getvalue()


def _effects(path):
    return np.loadtxt(path, skiprows=1, usecols=(2, 3))


def _write_fam(path, pheno):
    with open(path[:-4] + ".fam", "w") as fh:
        fh.writelines(f"F{i} I{i} 0 0 0 {v}\n" for i, v in enumerate(pheno))


@pytest.mark.parametrize("pheno", ["simulated", "fam"])
def test_run_gblup_matches_reference(panel, tmp_path, pheno):
    """The pipeline on a .bed: simulated phenotypes (-9 in the .fam, HE)
    or real ones (AI-REML); the marker-effect files agree."""
    geno, _, _, y = panel
    path = str(tmp_path / "p.bed")
    bed.write_bed(path, geno)
    kw = dict(pcs=2, estimate_h2=True)
    if pheno == "fam":
        _write_fam(path, [f"{v:.9g}" for v in y])
        kw["h2_method"] = "reml"
    rc_ref, out_ref = _run(ref_gblup.run_gblup, path,
                           effects_out=str(tmp_path / "ref.txt"), **kw)
    rc, out = _run(pt_gblup.run_gblup, path, device=CPU,
                   effects_out=str(tmp_path / "port.txt"), **kw)
    assert rc == rc_ref == 0
    want, got = _effects(tmp_path / "ref.txt"), _effects(tmp_path / "port.txt")
    assert got.shape == (800, 2)
    assert _rel(got[:, 0], want[:, 0]) < RTOL
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    assert [ln[:12] for ln in out.splitlines()] == \
        [ln[:12] for ln in out_ref.splitlines()]
    assert ("simulated with known BVs" in out) == (pheno == "simulated")
    assert ("AI-REML h2" in out) == (pheno == "fam")


@pytest.mark.parametrize("head,rest,message", [
    (["1.5", "x2"], "1.0", "unparseable phenotype 'x2'"),
    (["1.5", "-9"], "1.0", "1 individuals have missing phenotype"),
    (["NA", "-9.0"], "-9", None),
], ids=["bad-token", "partly-missing", "all-missing"])
def test_run_gblup_fam_phenotypes(panel, tmp_path, head, rest, message):
    """One bad token or a partly missing column stops the run, in both
    packages; a column missing throughout takes the simulation branch."""
    geno = panel[0]
    path = str(tmp_path / "q.bed")
    bed.write_bed(path, geno)
    _write_fam(path, head + [rest] * (geno.shape[0] - 2))
    if message is None:
        rc, out = _run(pt_gblup.run_gblup, path, pcs=0, device=CPU)
        assert rc == 0 and "simulated with known BVs" in out
        return
    with pytest.raises(SystemExit, match=message):
        pt_gblup.run_gblup(path, pcs=0, device=CPU)
    with pytest.raises(SystemExit, match=message):
        ref_gblup.run_gblup(path, pcs=0)


def test_run_gblup_rejects_stream_chunk(panel, tmp_path):
    """Named before the streamed container was ported: ``stream_chunk``
    now reads the panel as a StreamedGeno (3 chunks here), and the run
    writes the marker effects of the resident run (phenotypes simulated
    from the first 1,024 SNPs: here the whole panel, as resident)."""
    path = str(tmp_path / "s.bed")
    ref_bed.write_bed(path, panel[0])
    eff = {}
    for chunk in (0, 300):
        out = str(tmp_path / f"eff{chunk}.tsv")
        rc, text = _run(pt_gblup.run_gblup, path, pcs=0, stream_chunk=chunk,
                        effects_out=out, device=CPU)
        assert rc == 0
        eff[chunk] = np.loadtxt(out, skiprows=1, usecols=2)
    assert "streamed panel: 800 snps x 160 indiv, 3 chunks" in text
    assert _rel(eff[300], eff[0]) < RTOL


@pytest.mark.parametrize("fn", [
    lambda g, y: pt_gblup.estimate_h2_he(g, y),
    lambda g, y: pt_gblup.estimate_h2_reml(g, y),
    lambda g, y: pt_gblup.cross_validate(g, y),
    lambda g, y: pt_gblup._ridge_solver(g, 1e-5, 10),
], ids=["he", "reml", "cross_validate", "ridge_solver"])
def test_unported_containers_raise(panel, fn):
    """Every container is ported (the sharded ones are held to the
    reference in tests/test_torch_sharded_paths.py); anything else is
    refused with a TypeError naming the accepted ones."""
    with pytest.raises(TypeError, match="not a genotype container"):
        fn(object(), panel[3])


def _params(fn):
    import inspect

    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_every_public_function_of_the_reference():
    """The port's gblup module has every public function and result class
    of the reference's, with its parameters (names, kinds, defaults); the
    port adds ``device`` last to ``run_gblup`` and ``gblup_from_grm``, and
    ``converged`` last to ``GBLUPResult``."""
    import inspect

    public = {k: v for k, v in vars(ref_gblup).items()
              if not k.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == ref_gblup.__name__}
    new = {"run_gblup", "cross_validate", "estimate_h2_reml",
           "estimate_h2_he", "estimate_multi_reml", "estimate_bivar_reml",
           "multi_trait_gblup", "MTGBLUPResult", "gblup_from_grm"}
    assert new <= set(public)
    extra = {"run_gblup": ["device"], "gblup_from_grm": ["device"],
             "GBLUPResult": ["converged"]}
    for name, ref_fn in public.items():
        port_fn = getattr(pt_gblup, name)
        want, got = _params(ref_fn), _params(port_fn)
        assert got[:len(want)] == want, name
        assert [p[0] for p in got[len(want):]] == extra.get(name, []), name
        if name in new:    # exported by the package too
            assert getattr(mt, name) is port_fn, name
