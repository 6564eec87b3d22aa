"""Single-step GBLUP against miraculix_tpu.ssgblup and dense float64
oracles, on the reference tests' panel (tests/test_ssgblup.py: 120 pedigree
animals, 48 of them genotyped at 600 SNPs).

Tolerances: the H^-1 blocks (``matvec``, ``gw_inv``, ``a22_inv``,
``diag_approx``) within 1e-4 of max |reference|; ``ssgblup`` within 1e-3
with outer iterations within 2; single-step REML h2 within 1e-4 absolute,
the same AI steps and MME CG totals within 2 a solve; ``run_ssgblup``'s EBVs
within 1e-3 of max.  Against the dense oracles, the reference tests'
limits: 2e-4 (H^-1 and A22^-1), 5e-4 (Gw^-1), 5e-3 (the MME solve) and
0.015 (exact-probe REML against the profiled-likelihood argmax).  Each
reference call is made once per module.
"""
import contextlib
import inspect
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import pedigree as ref_ped  # noqa: E402
from miraculix_tpu import ssgblup as ref  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.ops import ref_impl  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import ssgblup as ss  # noqa: E402
from miraculix_tpu_torch.solve.cg import host_pcg  # noqa: E402

CPU = "cpu"
N_ANIM, N_GENO, N_SNPS = 120, 48, 600
BLEND, TAU, OMEGA = 0.05, 1.0, 1.0
KW = dict(blend=BLEND, tau=TAU, omega=OMEGA, inner_tol=1e-7,
          inner_maxiter=4000)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def panel():
    sire, dam = ref_ped.simulate_pedigree(N_ANIM, n_founders=15, seed=4,
                                          unknown_rate=0.1)
    rng = np.random.default_rng(9)
    geno_ids = np.sort(rng.choice(N_ANIM, size=N_GENO, replace=False)) + 1
    geno = ref_bed.simulate_genotypes(N_GENO, N_SNPS, seed=11)
    r_h = ref.SingleStepHInv(sire, dam, mx.from_dense(geno), geno_ids, **KW)
    p_h = ss.SingleStepHInv(sire, dam, mt.from_dense(geno, device=CPU),
                            geno_ids, **KW)
    # the dense float64 oracle of H^-1
    a = ref_ped.a_matrix(sire, dam)
    freq = np.asarray(p_h.g.freq, np.float64)
    gw = ((1 - BLEND) * ref_impl.grm_oracle(geno, freq, scale=True)
          + BLEND * np.eye(N_GENO))
    a22 = a[np.ix_(geno_ids - 1, geno_ids - 1)]
    hinv_d = np.linalg.inv(a)
    hinv_d[np.ix_(geno_ids - 1, geno_ids - 1)] += (
        TAU * np.linalg.inv(gw) - OMEGA * np.linalg.inv(a22))
    return dict(sire=sire, dam=dam, geno_ids=geno_ids, geno=geno, ref=r_h,
                port=p_h, hinv_d=hinv_d, gw=gw, a22=a22)


def test_hinv_blocks_match_reference(panel):
    r_h, p_h = panel["ref"], panel["port"]
    rng = np.random.default_rng(0)
    v = rng.standard_normal((N_ANIM, 3)).astype(np.float32)
    v2 = rng.standard_normal((N_GENO, 2)).astype(np.float32)
    for name, got, want in (
            ("matvec", p_h.matvec(v), r_h.matvec(v)),
            ("matvec 1-d", p_h.matvec(v[:, 0]), r_h.matvec(v[:, 0])),
            ("gw_inv", p_h.gw_inv(v2), r_h.gw_inv(v2)),
            ("a22_inv", p_h.a22_inv(v2), r_h.a22_inv(v2)),
            ("diag_approx", p_h.diag_approx(), r_h.diag_approx())):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert _rel(got, want) < 1e-4, name
    assert (p_h.n, p_h.n1, p_h.n2) == (r_h.n, r_h.n1, r_h.n2)
    for blk in ("ainv", "a11", "a12", "a22"):
        np.testing.assert_array_equal(getattr(p_h, blk).to_dense(),
                                      getattr(r_h, blk).to_dense())


def test_hinv_blocks_match_dense_oracles(panel):
    p_h = panel["port"]
    rng = np.random.default_rng(1)
    v = rng.standard_normal((N_ANIM, 3)).astype(np.float32)
    v2 = rng.standard_normal((N_GENO, 2)).astype(np.float32)
    assert _rel(p_h.matvec(v), panel["hinv_d"] @ v) < 2e-4
    assert _rel(p_h.a22_inv(v2), np.linalg.solve(panel["a22"], v2)) < 2e-4
    assert _rel(p_h.gw_inv(v2), np.linalg.solve(panel["gw"], v2)) < 5e-4


def _dense_mme(hinv_d, y, obs_ids, x, h2):
    n_obs, n_anim = len(y), hinv_d.shape[0]
    w = np.zeros((n_obs, n_anim))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    lam = (1 - h2) / h2
    mme = np.vstack([np.column_stack([x.T @ x, x.T @ w]),
                     np.column_stack([w.T @ x, w.T @ w + lam * hinv_d])])
    return np.linalg.solve(mme, np.concatenate([x.T @ y, w.T @ y]))


def _records(case):
    rng = np.random.default_rng(3 if case == "covariate" else 5)
    if case == "covariate":   # 90 animals, genotyped and not
        obs_ids = np.sort(rng.choice(N_ANIM, size=90, replace=False)) + 1
        x = np.column_stack([np.ones(90), rng.standard_normal(90)])
        y = (x @ [1.0, 0.5] + rng.standard_normal(N_ANIM)[obs_ids - 1]
             + 0.7 * rng.standard_normal(90))
        return y, obs_ids, x, 0.4
    obs_ids = np.concatenate([np.arange(1, 61), np.arange(1, 31)])
    return rng.standard_normal(90), obs_ids, None, 0.5   # repeated records


@pytest.fixture(scope="module")
def solves(panel):
    """case -> (reference, port) ssgblup results."""
    out = {}
    for case in ("covariate", "repeated"):
        y, obs_ids, x, h2 = _records(case)
        kw = dict(obs_ids=obs_ids, x=x, h2=h2, tol=1e-7, maxiter=5000)
        out[case] = (ref.ssgblup(y, panel["ref"], **kw),
                     ss.ssgblup(y, panel["port"], **kw))
    return out


@pytest.mark.parametrize("case", ["covariate", "repeated"])
def test_ssgblup_matches_reference_and_dense_mme(panel, solves, case):
    r_res, p_res = solves[case]
    assert isinstance(p_res, ss.SSGBLUPResult)
    assert p_res.u.dtype == np.float64 and p_res.u.shape == (N_ANIM,)
    assert _rel(p_res.u, r_res.u) < 1e-3
    assert np.abs(p_res.beta - r_res.beta).max() < 1e-3 * max(
        1.0, np.abs(r_res.beta).max())
    assert abs(p_res.iterations - r_res.iterations) <= 2
    y, obs_ids, x, h2 = _records(case)
    x = np.ones((len(y), 1)) if x is None else x
    z = _dense_mme(panel["hinv_d"], y, obs_ids, x, h2)
    p = x.shape[1]
    assert np.abs(p_res.beta - z[:p]).max() < 5e-3
    assert _rel(p_res.u, z[p:]) < 5e-3


def test_ssgblup_rejects_foreign_records(panel):
    with pytest.raises(ValueError, match="obs_ids"):
        ss.ssgblup(np.ones(3), panel["port"], obs_ids=np.array([0, 1, 2]))


def _profiled_reml_argmax(h_dense, y, obs_ids, grid):
    """Dense REML oracle: the restricted profiled log-likelihood of
    V(h2) = h2 W H W' + (1-h2) I over a grid (intercept, total variance
    profiled out), through the eigendecomposition of W H W'."""
    n_obs, n_anim = len(y), h_dense.shape[0]
    w = np.zeros((n_obs, n_anim))
    w[np.arange(n_obs), obs_ids - 1] = 1.0
    e, q = np.linalg.eigh(w @ h_dense @ w.T)
    qy = q.T @ ((y - y.mean()) / y.std())
    qx = q.T @ np.ones(n_obs)

    def logl(h2):
        d = h2 * e + (1 - h2)
        xtvx = float(qx @ (qx / d))
        beta = float(qx @ (qy / d)) / xtvx
        st = float((qy - beta * qx) @ (qy / d)) / (n_obs - 1)
        return -0.5 * ((n_obs - 1) * np.log(st) + np.log(d).sum()
                       + np.log(xtvx))

    return float(grid[np.argmax([logl(h) for h in grid])])


REML_CASES = {"exact": dict(probes=np.eye(N_ANIM), cg_tol=1e-7),
              "stochastic": dict(n_probes=8, seed=5, cg_tol=1e-6)}


@pytest.fixture(scope="module")
def reml(panel):
    """Phenotypes drawn under the single-step model (u ~ N(0, 0.6 H) from
    the dense H); case -> (reference, port) estimate_h2_reml_ss fits."""
    h_dense = np.linalg.inv(panel["hinv_d"])
    rng = np.random.default_rng(17)
    lch = np.linalg.cholesky(h_dense + 1e-8 * np.eye(N_ANIM))
    u = np.sqrt(0.6) * (lch @ rng.standard_normal(N_ANIM))
    obs_ids = np.arange(1, 101)
    y = 1.5 + u[obs_ids - 1] + np.sqrt(0.4) * rng.standard_normal(100)
    fits = {k: (ref.estimate_h2_reml_ss(y, panel["ref"], obs_ids=obs_ids,
                                        **kw),
                ss.estimate_h2_reml_ss(y, panel["port"], obs_ids=obs_ids,
                                       **kw))
            for k, kw in REML_CASES.items()}
    return h_dense, y, obs_ids, fits


@pytest.mark.parametrize("case", sorted(REML_CASES))
def test_ss_reml_matches_reference(reml, case):
    (h_ref, d_ref), (h, d) = reml[3][case]
    assert d["converged"] and d_ref["converged"]
    assert abs(h - h_ref) < 1e-4
    assert abs(d["se_h2"] - d_ref["se_h2"]) < 1e-4
    assert d["iterations"] == d_ref["iterations"]
    # two MME solves an AI step
    assert abs(d["cg_iterations"] - d_ref["cg_iterations"]) \
        <= 2 * 2 * d["iterations"]
    assert d["exact_traces"] == (case == "exact")
    assert d["n_probes"] == d_ref["n_probes"]
    np.testing.assert_allclose(d["vu"] + d["ve"],
                               reml[1].var() * (d["s2u"] + d["s2e"]),
                               rtol=1e-12)


def test_ss_reml_exact_lands_on_the_dense_argmax(reml):
    h_dense, y, obs_ids, fits = reml
    h2, det = fits["exact"][1]
    want = _profiled_reml_argmax(h_dense, y, obs_ids,
                                 np.linspace(0.02, 0.98, 481))
    assert abs(h2 - want) < 0.015, (h2, want)
    assert np.isfinite(det["se_h2"]) and det["se_h2"] > 0


def test_host_pcg_equals_reference():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((40, 40))
    a = m @ m.T + 40 * np.eye(40)
    b = rng.standard_normal((40, 3))
    minv = 1.0 / np.diag(a)
    for args in ((b, 1e-10, 200), (b[:, 0], 1e-6, 5)):
        got = host_pcg(lambda z: a @ z, *args, minv=minv)
        want = ref._host_pcg(lambda z: a @ z, *args, minv=minv)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    x, it, res = host_pcg(lambda z: a @ z, b, 1e-10, 200)
    assert res.max() <= 1e-10 and np.abs(a @ x - b).max() < 1e-9


def _write_files(tmp_path, n_anim, n_founders, ped_seed, n_geno, n_snps,
                 geno_seed, first_geno, n_pheno, pheno_seed, missing="NA"):
    """A pedigree with string labels, the .bed of a genotyped subset whose
    .fam IIDs are the labels, and a phenotype file on the first animals."""
    sire, dam = ref_ped.simulate_pedigree(n_anim, n_founders=n_founders,
                                          seed=ped_seed)
    labels = [f"an{i + 1}" for i in range(n_anim)]
    pedf = str(tmp_path / "ped.txt")
    with open(pedf, "w") as fh:
        for i in range(n_anim):
            fh.write(f"{labels[i]} "
                     f"{labels[sire[i] - 1] if sire[i] else missing} "
                     f"{labels[dam[i] - 1] if dam[i] else missing}\n")
    geno = ref_bed.simulate_genotypes(n_geno, n_snps, seed=geno_seed)
    bedp = str(tmp_path / "g.bed")
    ref_bed.write_bed(bedp, geno)
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[1] = labels[first_geno + k]
            fh.write(" ".join(parts) + "\n")
    # phenotypes: breeding values drawn down the pedigree (variance 0.5:
    # half the parents' sum plus Mendelian sampling) plus noise
    rng = np.random.default_rng(pheno_seed)
    u = np.zeros(n_anim + 1)
    for i in range(1, n_anim + 1):
        known = int(sire[i - 1] > 0) + int(dam[i - 1] > 0)
        u[i] = (0.5 * (u[sire[i - 1]] + u[dam[i - 1]])
                + np.sqrt(0.5 * (1 - 0.25 * known)) * rng.standard_normal())
    phenf = str(tmp_path / "pheno.txt")
    with open(phenf, "w") as fh:
        for i in range(n_pheno):
            fh.write(f"{labels[i]} "
                     f"{u[i + 1] + np.sqrt(0.5) * rng.standard_normal():.5f}"
                     "\n")
    return bedp, pedf, phenf


def _ebvs(path):
    lines = open(path).read().splitlines()
    assert lines[0] == "animal\tebv\tgenotyped"
    return {ln.split("\t")[0]: (float(ln.split("\t")[1]),
                                int(ln.split("\t")[2])) for ln in lines[1:]}


@pytest.mark.parametrize("case", ["h2", "estimate_h2"])
def test_run_ssgblup_matches_reference(tmp_path, case):
    if case == "h2":     # tests/test_ssgblup.py::test_run_ssgblup_cli_path
        files = _write_files(tmp_path, 80, 12, 6, 40, 300, 2, 40, 60, 7)
        kw = dict(h2=0.4, tol=1e-6)
    else:                # ... ::test_run_ssgblup_estimate_h2
        files = _write_files(tmp_path, 70, 10, 8, 30, 200, 3, 40, 40, 13,
                             missing="0")
        kw = dict(estimate_h2=True, tol=1e-5)
    bedp, pedf, phenf = files
    printed = {}
    for name, fn, extra in (("ref", ref.run_ssgblup, {}),
                            ("port", ss.run_ssgblup, dict(device=CPU))):
        out = str(tmp_path / f"ebv_{name}.tsv")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert fn(bedp, pedf, pheno_path=phenf, out=out, **kw,
                      **extra) == 0
        printed[name] = (buf.getvalue(), _ebvs(out))
    (ref_out, want), (port_out, got) = printed["ref"], printed["port"]
    assert got.keys() == want.keys()
    assert [v[1] for v in got.values()] == [v[1] for v in want.values()]
    scale = max(abs(v[0]) for v in want.values())
    assert max(abs(got[k][0] - want[k][0]) for k in want) / scale < 1e-3
    assert all(np.isfinite(v[0]) for v in got.values())
    if case == "estimate_h2":
        line = [ln for ln in port_out.splitlines() if "ss-AI-REML" in ln]
        want_line = [ln for ln in ref_out.splitlines() if "ss-AI-REML" in ln]
        assert line and line[0].split(" (")[0] == want_line[0].split(" (")[0]


def test_run_ssgblup_reads_the_fam_phenotypes(tmp_path):
    """Without a phenotype file the .fam's 6th column is read; genotyped
    animals missing from the pedigree are appended as founders."""
    bedp, pedf, _ = _write_files(tmp_path, 50, 8, 2, 20, 200, 4, 30, 0, 1)
    fam = open(bedp[:-4] + ".fam").read().splitlines()
    rng = np.random.default_rng(3)
    with open(bedp[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            if k == 0:
                parts[1] = "newcomer"
            parts[5] = f"{rng.standard_normal():.5f}"
            fh.write(" ".join(parts) + "\n")
    out = {}
    for name, fn, extra in (("ref", ref.run_ssgblup, {}),
                            ("port", ss.run_ssgblup, dict(device=CPU))):
        path = str(tmp_path / f"ebv_{name}.tsv")
        with contextlib.redirect_stdout(io.StringIO()):
            assert fn(bedp, pedf, out=path, h2=0.3, no_inbreeding=True,
                      **extra) == 0
        out[name] = _ebvs(path)
    assert len(out["port"]) == 51 and out["port"]["newcomer"][1] == 1
    scale = max(abs(v[0]) for v in out["ref"].values())
    assert max(abs(out["port"][k][0] - out["ref"][k][0])
               for k in out["ref"]) / scale < 1e-3


def test_unported_containers_raise(panel, tmp_path):
    """Anything but a genotype container is refused with a TypeError; the
    streamed one and ``run_ssgblup(stream_chunk=)`` are held to the
    reference by tests/test_torch_streamed_paths.py, the sharded one by
    tests/test_torch_sharded_paths.py."""
    with pytest.raises(TypeError, match="not a genotype container"):
        ss.SingleStepHInv(panel["sire"], panel["dam"], object(),
                          panel["geno_ids"])


def test_every_public_function_of_the_reference():
    """The public functions and classes of the reference's ssgblup module,
    with their parameters (names, kinds, defaults); ``run_ssgblup`` adds
    ``device`` last; ``SingleStepHInv`` exported by the package."""
    public = {k: v for k, v in vars(ref).items()
              if not k.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == ref.__name__}
    assert {"SingleStepHInv", "SSGBLUPResult", "ssgblup",
            "estimate_h2_reml_ss", "run_ssgblup"} <= set(public)
    for name, ref_fn in public.items():
        want = [(p.name, p.kind, p.default) for p in
                inspect.signature(ref_fn).parameters.values()]
        got = [(p.name, p.kind, p.default) for p in
               inspect.signature(getattr(ss, name)).parameters.values()]
        assert got[:len(want)] == want, name
        assert [p[0] for p in got[len(want):]] == (
            ["device"] if name == "run_ssgblup" else []), name
    for meth in ("gw_inv", "a22_inv", "matvec", "diag_approx"):
        assert list(inspect.signature(getattr(ss.SingleStepHInv, meth))
                    .parameters) == list(inspect.signature(
                        getattr(ref.SingleStepHInv, meth)).parameters), meth
    assert mt.SingleStepHInv is ss.SingleStepHInv
