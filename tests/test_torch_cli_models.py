"""The port's model subcommands against miraculix_tpu's: gblup, score, pca,
reml (HE, AI-REML, bivariate, multi-trait, streamed) and ssgblup.

Both CLIs run on the same .bed fileset (phenotypes in its .fam) and trait
files written from a numpy seed.  Marker effects, scores, EBVs, h2, rG and
their SEs must agree within 1e-3 (relative to max for vectors, absolute
for the printed estimates), eigenvalues at the reference pca test's rtol;
the guards must end both in the same ``SystemExit`` message.  The
reference's CLI tests of tests/test_gblup.py are kept as cases with their
assertions, run on the port's outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import cli as ref_cli  # noqa: E402

from miraculix_tpu_torch import cli as pt_cli  # noqa: E402
from miraculix_tpu_torch import from_bed, gblup, pedigree  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402

EST_TOL = 1e-3      # effects, EBVs, h2, rG and SEs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_main(argv):
    return pt_cli.main(["--device", "cpu", *argv])


def both_out(capsys, argv):
    """stdout of the reference's CLI and of the port's on ``argv`` (exit 0
    on both)."""
    outs = []
    for main in (ref_cli.main, port_main):
        assert main(argv) == 0
        outs.append(capsys.readouterr().out)
    return outs


def both_exit(capsys, argv, match):
    msgs = []
    for main in (ref_cli.main, port_main):
        with pytest.raises(SystemExit, match=match) as exc:
            main(argv)
        msgs.append(str(exc.value.code))
    capsys.readouterr()
    assert msgs[1] == msgs[0]


def nums(out, prefix):
    """The numbers after ``prefix`` on the first line that starts with it."""
    line = next(ln for ln in out.splitlines() if ln.startswith(prefix))
    return [float(t) for t in line[len(prefix):].replace("=", " ").split()]


def close(got, want, tol=EST_TOL):
    assert np.allclose(got, want, rtol=0, atol=tol), (got, want)


def held(got, want, tol=EST_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def with_pheno(tmp_path, geno, y, name):
    p = str(tmp_path / name)
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = f"{y[k]:.6f}"
            fh.write(" ".join(parts) + "\n")
    return p, fam


def simulate_bivar(geno, rg, h2a, h2b, seed):
    """tests/test_gblup.py::_simulate_bivar: correlated-QTL bivariate
    phenotypes (y1, y2)."""
    rng = np.random.default_rng(seed)
    n, snps = geno.shape
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * f
    zs = zc / np.sqrt(2 * (f * (1 - f)).sum())
    a = rng.multivariate_normal(np.zeros(2), [[1, rg], [rg, 1]], size=snps)
    u = zs @ a
    u = u / u.std(axis=0)
    e = rng.standard_normal((n, 2))
    e = e / e.std(axis=0)
    y1 = np.sqrt(h2a) * u[:, 0] + np.sqrt(1 - h2a) * e[:, 0]
    y2 = np.sqrt(h2b) * u[:, 1] + np.sqrt(1 - h2b) * e[:, 1]
    return y1, y2


# -- reml ----------------------------------------------------------------

def test_cli_reml_and_grm_dominance(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_reml_and_grm_dominance, on both CLIs:
    HE and AI-REML h2 within 1e-3 of the reference's, the dominance GRMs
    within 1e-5 of max."""
    geno = bed.simulate_genotypes(120, 600, seed=19)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=300, seed=4)
    p, _ = with_pheno(tmp_path, geno, y, "r.bed")

    out_r, out = both_out(capsys, ["reml", p, "--method", "he"])
    assert "HE h2 =" in out
    close(nums(out, "HE h2"), nums(out_r, "HE h2"))
    out_r, out = both_out(capsys, ["reml", p, "--probes", "8"])
    assert "V(G)/Vp" in out and "AI-REML" in out
    close(nums(out, "V(G)/Vp"), nums(out_r, "V(G)/Vp"))
    assert out.splitlines()[0] == out_r.splitlines()[0]

    d_r, d_p = (str(tmp_path / f"{s}_d.npy") for s in ("ref", "port"))
    assert ref_cli.main(["grm", p, "-o", d_r, "--dominance"]) == 0
    assert port_main(["grm", p, "-o", d_p, "--dominance"]) == 0
    capsys.readouterr()
    d = np.load(d_p)
    assert d.shape == (120, 120) and np.isfinite(d).all()
    held(d, np.load(d_r), 1e-5)


def test_cli_reml_stream_chunk(tmp_path, capsys):
    """reml --stream-chunk: the port's streamed AI-REML within 1e-3 of its
    resident one and of the reference's streamed one."""
    geno = bed.simulate_genotypes(100, 500, seed=23)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=200, seed=6)
    p, _ = with_pheno(tmp_path, geno, y, "s.bed")
    argv = ["reml", p, "--probes", "8"]
    out_r, out = both_out(capsys, argv + ["--stream-chunk", "128"])
    assert port_main(argv) == 0
    out_res = capsys.readouterr().out
    close(nums(out, "V(G)/Vp"), nums(out_r, "V(G)/Vp"))
    close(nums(out, "V(G)/Vp"), nums(out_res, "V(G)/Vp"))


def _bivar_fileset(tmp_path, n, snps, seed, rg, pheno_seed, name):
    geno = bed.simulate_genotypes(n, snps, seed=seed)
    y1, y2 = simulate_bivar(geno, rg, 0.5, 0.5, seed=pheno_seed)
    p, fam = with_pheno(tmp_path, geno, y1, name)
    return p, fam, y2


BIVAR_LINES = ("rG", "h2 (trait 1)", "h2 (trait 2)")


def test_cli_reml_bivar(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_reml_bivar, on both CLIs: rG, both h2
    and their SEs within 1e-3, for both second-trait formats."""
    p, fam, y2 = _bivar_fileset(tmp_path, 200, 800, 15, 0.6, 2, "b.bed")
    p2 = str(tmp_path / "t2.txt")
    with open(p2, "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            fh.write(f"{parts[0]} {parts[1]} {y2[k]:.6f}\n")
    out_r, out = both_out(capsys, ["reml", p, "--bivar", p2, "--probes", "8"])
    assert "rG\t" in out and "bivariate AI-REML" in out
    for key in BIVAR_LINES:
        close(nums(out, key), nums(out_r, key))

    p3 = str(tmp_path / "t2b.txt")
    with open(p3, "w") as fh:
        fh.writelines(f"{v:.6f}\n" for v in y2)
    out_r, out = both_out(capsys, ["reml", p, "--bivar", p3, "--probes", "8"])
    for key in BIVAR_LINES:
        close(nums(out, key), nums(out_r, key))


@pytest.mark.parametrize("case", ["missing", "ragged", "header"])
def test_cli_reml_bivar_rejects_bad_inputs(tmp_path, capsys, case):
    """tests/test_gblup.py::test_cli_reml_bivar_rejects_bad_inputs, one case
    a file: -9 refused, a ragged file refused, a header tolerated (its
    estimates within 1e-3 of the reference's)."""
    p, fam, y2 = _bivar_fileset(tmp_path, 60, 300, 25, 0.5, 7, "m.bed")
    f = str(tmp_path / f"{case}.txt")
    with open(f, "w") as fh:
        if case == "missing":
            fh.write("-9\n" * 60)
        elif case == "ragged":
            fh.write("F0 I0 1.0\nF1 I1\n")
        else:
            fh.write("FID IID pheno\n")
            for k, ln in enumerate(fam):
                parts = ln.split()
                fh.write(f"{parts[0]} {parts[1]} {y2[k]:.6f}\n")
    argv = ["reml", p, "--bivar", f, "--probes", "4"]
    if case == "header":
        out_r, out = both_out(capsys, argv)
        for key in BIVAR_LINES:
            close(nums(out, key), nums(out_r, key))
    else:
        both_exit(capsys, argv,
                  "missing phenotype" if case == "missing" else "ragged")


def test_cli_reml_bivar_rejects_two_column_file(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_reml_bivar_rejects_two_column_file,
    on both CLIs."""
    geno = bed.simulate_genotypes(50, 200, seed=9)
    y = np.random.default_rng(0).standard_normal(50)
    p, _ = with_pheno(tmp_path, geno, np.round(y, 5), "b.bed")
    bv = str(tmp_path / "t2.txt")
    with open(bv, "w") as fh:
        for k in range(50):
            fh.write(f"{k} {y[k]:.5f}\n")   # "IID value": ambiguous
    both_exit(capsys, ["reml", p, "--bivar", bv], "2 columns")


def test_cli_reml_multi(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_reml_multi, on both CLIs: every h2, rG
    and SE within 1e-3, with and without a .fam phenotype column."""
    geno = bed.simulate_genotypes(150, 600, seed=33)
    rng = np.random.default_rng(3)
    f = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zs = (geno.astype(np.float64) - 2 * f) / np.sqrt(
        2 * (f * (1 - f)).sum())
    u = zs @ rng.standard_normal((600, 3))
    u /= u.std(axis=0)
    ys = 0.7 * u + 0.7 * rng.standard_normal((150, 3))
    p = str(tmp_path / "mt.bed")
    bed.write_bed(p, geno)
    ph = str(tmp_path / "ph.txt")
    fam = open(p[:-4] + ".fam").read().splitlines()
    with open(ph, "w") as fh:
        fh.write("FID IID t1 t2 t3\n")
        for k, ln in enumerate(fam):
            parts = ln.split()
            fh.write(f"{parts[0]} {parts[1]} " +
                     " ".join(f"{v:.6f}" for v in ys[k]) + "\n")
    out_r, out = both_out(capsys, ["reml", p, "--multi", ph, "--probes", "6"])
    assert "3-trait REML" in out and "2,3\t" in out
    for key in ("1\t", "2\t", "3\t", "1,2\t", "1,3\t", "2,3\t"):
        close(nums(out, key), nums(out_r, key))

    # --multi must not touch the .fam phenotype column
    with open(p[:-4] + ".fam", "w") as fh:
        for ln in fam:
            parts = ln.split()
            fh.write(" ".join(parts[:5]) + " NA\n")
    assert port_main(["reml", p, "--multi", ph, "--probes", "6"]) == 0
    assert capsys.readouterr().out == out


# -- pca ---------------------------------------------------------------------

def test_cli_pca_matches_dense_eigh(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_pca_matches_dense_eigh on the port, and
    its eigenpairs against the reference CLI's (eigenvalues at the test's
    rtol, eigenvectors up to sign)."""
    geno = bed.simulate_genotypes(100, 800, seed=23)
    p = str(tmp_path / "p.bed")
    bed.write_bed(p, geno)
    pre = {s: str(tmp_path / s) for s in ("ref", "port")}
    flags = ["-k", "5", "--oversample", "40", "--power-iters", "8"]
    assert ref_cli.main(["pca", p, "-o", pre["ref"], *flags]) == 0
    assert port_main(["pca", p, "-o", pre["port"], *flags]) == 0
    assert "top 5 PCs" in capsys.readouterr().out

    def read(prefix):
        w = np.loadtxt(prefix + ".eigenval")
        rows = [ln.split() for ln in open(prefix + ".eigenvec")]
        return w, rows, np.array([[float(x) for x in r[2:]] for r in rows])

    w, vec_rows, v = read(pre["port"])
    assert len(vec_rows) == 100 and len(vec_rows[0]) == 2 + 5
    freq = np.where(geno == 3, 0, geno).mean(axis=0) / 2.0
    zc = geno.astype(np.float64) - 2 * freq[None, :]
    gmat = zc @ zc.T / (2 * (freq * (1 - freq)).sum())
    wd, vd = np.linalg.eigh(gmat)
    wd, vd = wd[::-1][:5], vd[:, ::-1][:, :5]
    np.testing.assert_allclose(w, wd, rtol=2e-3)
    w_r, rows_r, v_r = read(pre["ref"])
    np.testing.assert_allclose(w, w_r, rtol=2e-3)
    assert [r[:2] for r in vec_rows] == [r[:2] for r in rows_r]
    for j in range(5):          # eigenvectors match up to sign
        assert abs(float(v[:, j] @ vd[:, j])) > 0.999, j
        assert abs(float(v[:, j] @ v_r[:, j])) > 0.999, j


# -- gblup and score -----------------------------------------------------

def test_cli_effects_out_and_score(tmp_path, capsys):
    """tests/test_gblup.py::test_cli_effects_out_and_score on the port, its
    effects and scores within 1e-3 of the reference CLI's, and the
    misaligned panel refused by both."""
    geno = bed.simulate_genotypes(90, 500, seed=31)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.6, n_qtl=200, seed=5)
    p, _ = with_pheno(tmp_path, geno, y, "t.bed")
    eff = {s: str(tmp_path / f"{s}_eff.tsv") for s in ("ref", "port")}
    out = {s: str(tmp_path / f"{s}_sc.tsv") for s in ("ref", "port")}
    assert ref_cli.main(["gblup", p, "--effects-out", eff["ref"]]) == 0
    assert port_main(["gblup", p, "--effects-out", eff["port"]]) == 0
    printed = capsys.readouterr().out
    cors = [float(ln.split("=")[1]) for ln in printed.splitlines()
            if ln.startswith("cor(fitted, phenotype)")]
    close(cors[1], cors[0])
    rows = [ln.split("\t") for ln in open(eff["port"])]
    rows_r = [ln.split("\t") for ln in open(eff["ref"])]
    assert rows[0] == ["snp", "allele", "effect", "freq_train\n"]
    assert len(rows) == 1 + 500
    assert all(r[1] == "B" for r in rows[1:])
    assert [r[:2] for r in rows] == [r[:2] for r in rows_r]
    alpha = np.array([float(r[2]) for r in rows[1:]])
    freq = np.array([float(r[3]) for r in rows[1:]])
    held(alpha, [float(r[2]) for r in rows_r[1:]])
    np.testing.assert_array_equal(freq, [float(r[3]) for r in rows_r[1:]])

    assert ref_cli.main(["score", p, eff["ref"], "-o", out["ref"]]) == 0
    assert port_main(["score", p, eff["port"], "-o", out["port"]]) == 0
    capsys.readouterr()
    sc = np.loadtxt(out["port"], skiprows=1, usecols=2)
    assert sc.shape == (90,)
    want = gblup.predict(from_bed(p, device="cpu"), alpha, freq)
    np.testing.assert_allclose(sc, want, atol=1e-4 * np.abs(want).max())
    held(sc, np.loadtxt(out["ref"], skiprows=1, usecols=2))
    ids = [ln.split("\t")[:2] for ln in open(out["port"])]
    assert ids == [ln.split("\t")[:2] for ln in open(out["ref"])]

    # variant misalignment must be refused without --force
    bim = open(p[:-4] + ".bim").read().splitlines()
    parts3 = bim[3].split()
    assert parts3[1] == "snp3"
    parts3[1] = "OTHER"
    bim[3] = " ".join(parts3)
    with open(p[:-4] + ".bim", "w") as fh:
        fh.write("\n".join(bim) + "\n")
    both_exit(capsys, ["score", p, eff["port"], "-o", out["port"]],
              "mismatches")
    assert port_main(["score", p, eff["port"], "-o", out["port"],
                      "--force"]) == 0
    capsys.readouterr()


@pytest.mark.parametrize("flags", [["--estimate-h2"],
                                   ["--estimate-h2", "--h2-method", "reml"],
                                   ["--solver", "dense", "--pcs", "3"]],
                         ids=["he", "reml", "dense"])
def test_cli_gblup_matches_reference(tmp_path, capsys, flags):
    """gblup with h2 estimated (HE, AI-REML) or the dense solver: the
    printed estimates and the marker effects within 1e-3."""
    geno = bed.simulate_genotypes(80, 400, seed=37)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=100, seed=8)
    p, _ = with_pheno(tmp_path, geno, y, "g.bed")
    eff = {s: str(tmp_path / f"{s}.tsv") for s in ("ref", "port")}
    outs = []
    for side, main in (("ref", ref_cli.main), ("port", port_main)):
        assert main(["gblup", p, *flags, "--effects-out", eff[side]]) == 0
        outs.append(capsys.readouterr().out)
    if "--estimate-h2" in flags:
        key = "AI-REML h2" if "reml" in flags else "HE-estimated h2"
        h2 = [float(next(ln for ln in o.splitlines() if ln.startswith(key))
                        .split("=")[1].split()[0]) for o in outs]
        close(h2[1], h2[0])
    close(nums(outs[1], "cor(fitted, phenotype)"),
          nums(outs[0], "cor(fitted, phenotype)"))
    held([float(ln.split("\t")[2]) for ln in open(eff["port"])
          if not ln.startswith("snp\t")],
         [float(ln.split("\t")[2]) for ln in open(eff["ref"])
          if not ln.startswith("snp\t")])


# -- ssgblup -----------------------------------------------------------------

def test_cli_ssgblup_matches_reference(tmp_path, capsys):
    """ssgblup on a 300-animal pedigree whose youngest 80 are the panel's
    animals, phenotypes in the .fam: every EBV within 1e-3 of max of the
    reference CLI's, the animal and genotyped columns equal."""
    n_anim, n_geno = 300, 80
    sire, dam = pedigree.simulate_pedigree(n_anim, n_founders=20, seed=7)
    geno = bed.simulate_genotypes(n_geno, 400, seed=17)
    y = np.random.default_rng(2).standard_normal(n_geno)
    p, _ = with_pheno(tmp_path, geno, y, "s.bed")
    labels = [f"P{i}" for i in range(n_anim - n_geno)] + [
        f"I{i}" for i in range(n_geno)]              # the .fam's IIDs
    ped = str(tmp_path / "ped.txt")
    with open(ped, "w") as fh:
        fh.writelines(f"{lab} {labels[s - 1] if s else 0} "
                      f"{labels[d - 1] if d else 0}\n"
                      for lab, s, d in zip(labels, sire, dam))
    out = {s: str(tmp_path / f"{s}_ebv.tsv") for s in ("ref", "port")}
    for side, main in (("ref", ref_cli.main), ("port", port_main)):
        assert main(["ssgblup", p, "--pedigree", ped, "-o", out[side]]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"{n_anim} pedigree animals, {n_geno} genotyped, " \
                         f"{n_geno} records"
    rows = [ln.rstrip("\n").split("\t") for ln in open(out["port"])]
    rows_r = [ln.rstrip("\n").split("\t") for ln in open(out["ref"])]
    assert rows[0] == ["animal", "ebv", "genotyped"] and len(rows) == \
        1 + n_anim
    assert [(r[0], r[2]) for r in rows] == [(r[0], r[2]) for r in rows_r]
    held([float(r[1]) for r in rows[1:]], [float(r[1]) for r in rows_r[1:]])
