"""The port's ``gwas`` subcommand against miraculix_tpu's.

Both CLIs scan the same .bed fileset (phenotypes in its .fam, written from a
numpy seed) into TSVs of their own: the variant columns must be equal and
each statistic within 1e-4 of its column's max |reference|; the guards
must end both in the same ``SystemExit`` message.  The reference's CLI
tests of tests/test_gwas.py are kept as cases with their assertions.  The
``--mesh`` case holds the port's 4-shard scan to the port's single-device
one (the reference test's rtol 2e-3, atol 1e-5) and that to the reference's
single-device scan; the reference's own 8-shard run is not repeated.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import cli as ref_cli  # noqa: E402

from miraculix_tpu_torch import cli as pt_cli  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402

STAT_RTOL = 1e-4    # GWAS statistics, relative to each column's max


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_main(argv):
    return pt_cli.main(["--device", "cpu", *argv])


def fileset(tmp_path, n, snps, seed, pheno_seed, causal, name="g.bed"):
    """A .bed fileset whose .fam carries y = 0.8 z_causal + noise; returns
    (path, y, the .fam lines)."""
    geno = bed.simulate_genotypes(n, snps, seed=seed)
    y = geno[:, causal] * 0.8 + np.random.default_rng(
        pheno_seed).standard_normal(n)
    p = str(tmp_path / name)
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    write_pheno(p, fam, [f"{v:.6f}" for v in y])
    return p, y, fam


def write_pheno(p, fam, vals):
    with open(p[:-4] + ".fam", "w") as fh:
        for k, ln in enumerate(fam):
            parts = ln.split()
            parts[5] = str(vals[k])
            fh.write(" ".join(parts) + "\n")


def two_chromosomes(p):
    """Put the second half of the .bim's SNPs on chromosome 2: write_bed
    puts every SNP on chromosome 1, whose LOCO fold would leave no GRM."""
    bim = [ln.split() for ln in open(p[:-4] + ".bim")]
    with open(p[:-4] + ".bim", "w") as fh:
        for k, parts in enumerate(bim):
            parts[0] = "1" if k < len(bim) // 2 else "2"
            fh.write("\t".join(parts) + "\n")


def rows_of(path):
    return [ln.rstrip("\n").split("\t") for ln in open(path)]


def same_scan(got_path, want_path, rtol=STAT_RTOL, atol=0.0):
    got, want = rows_of(got_path), rows_of(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    g = np.array([[float(x) for x in r[3:]] for r in got[1:]])
    w = np.array([[float(x) for x in r[3:]] for r in want[1:]])
    assert np.isfinite(g).all()
    for j in range(w.shape[1]):
        assert np.abs(g[:, j] - w[:, j]).max() <= \
            rtol * np.abs(w[:, j]).max() + atol, got[0][3 + j]


SCANS = {"linear": ([], ["chr", "snp", "bp", "beta", "se", "t", "p"]),
         "mixed": (["--mixed"], ["chr", "snp", "bp", "beta", "chi2", "p"]),
         "mixed_loco": (["--mixed", "--loco"],
                        ["chr", "snp", "bp", "beta", "chi2", "p"]),
         "logistic": (["--logistic"],
                      ["chr", "snp", "bp", "beta", "se", "z", "p"])}


@pytest.mark.parametrize("scan", list(SCANS))
def test_cli_gwas_writes_variant_ids(tmp_path, capsys, scan):
    """tests/test_gwas.py::test_cli_gwas_writes_variant_ids, one case a
    scan (and LOCO beside them), on both CLIs."""
    p, y, fam = fileset(tmp_path, 120, 300, seed=3, pheno_seed=0, causal=7)
    if scan == "logistic":
        yb = (y > np.median(y)).astype(int) + 1   # plink 1/2 coding
        write_pheno(p, fam, [str(v) for v in yb])
    if scan == "mixed_loco":
        two_chromosomes(p)
    flags, header = SCANS[scan]
    outs = {}
    for side, main in (("ref", ref_cli.main), ("port", port_main)):
        outs[side] = str(tmp_path / f"{side}.tsv")
        assert main(["gwas", p, "-o", outs[side], *flags]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[1].split(":")[0].replace("port", "ref") == \
        printed[0].split(":")[0]
    rows = rows_of(outs["port"])
    assert rows[0] == header
    assert len(rows) == 1 + 300 and rows[1][1] == "snp0"
    same_scan(outs["port"], outs["ref"])


def test_cli_gwas_simulates_missing_phenotypes(tmp_path, capsys):
    """A .fam without phenotypes: both CLIs simulate the same trait (the
    reference's draws) and write the same scan."""
    p = str(tmp_path / "s.bed")
    bed.write_bed(p, bed.simulate_genotypes(90, 200, seed=13))
    outs = {}
    for side, main in (("ref", ref_cli.main), ("port", port_main)):
        outs[side] = str(tmp_path / f"{side}.tsv")
        assert main(["gwas", p, "-o", outs[side]]) == 0
        assert "(.fam has no phenotypes — simulated, h2=0.5)" in \
            capsys.readouterr().out
    same_scan(outs["port"], outs["ref"])


def _guard_case(case, p, fam, y, out):
    if case == "missing":
        yv = [f"{v:.5f}" for v in y]
        yv[3] = "-9"
        write_pheno(p, fam, yv)
        return ["gwas", p, "-o", out], "missing phenotype"
    if case == "stream_no_pheno":   # ALL missing + streamed: refuse to densify
        write_pheno(p, fam, ["-9"] * len(y))
        return ["gwas", p, "-o", out, "--stream-chunk", "128"], "stream-chunk"
    if case == "loco_stream":
        return ["gwas", p, "-o", out, "--stream-chunk", "128", "--mixed",
                "--loco"], "loco"
    if case == "loco_no_mixed":
        return ["gwas", p, "-o", out, "--loco"], "loco"
    assert case == "mesh_stream"
    return ["gwas", p, "--mesh", "2", "--stream-chunk", "128"], "pick one"


@pytest.mark.parametrize("case", ["missing", "stream_no_pheno", "loco_stream",
                                  "loco_no_mixed", "mesh_stream"])
def test_cli_gwas_guards(tmp_path, capsys, case):
    """tests/test_gwas.py::test_cli_gwas_guards (and the --loco and --mesh
    guards), one case a guard: both CLIs end in the same message."""
    geno = bed.simulate_genotypes(60, 200, seed=5)
    y = np.random.default_rng(1).standard_normal(60)
    p = str(tmp_path / "g.bed")
    bed.write_bed(p, geno)
    fam = open(p[:-4] + ".fam").read().splitlines()
    write_pheno(p, fam, [f"{v:.5f}" for v in y])
    argv, match = _guard_case(case, p, fam, y, str(tmp_path / "o.tsv"))
    msgs = []
    for main in (ref_cli.main, port_main):
        with pytest.raises(SystemExit, match=match) as exc:
            main(argv)
        msgs.append(str(exc.value.code))
    assert msgs[1] == msgs[0]
    capsys.readouterr()


@pytest.mark.parametrize("flags", [[], ["--mixed"], ["--logistic"]],
                         ids=["linear", "mixed", "logistic"])
def test_cli_gwas_stream_chunk(tmp_path, capsys, flags):
    """--stream-chunk: the port's streamed scan within 1e-4 of its resident
    scan and of the reference's streamed scan."""
    p, y, fam = fileset(tmp_path, 100, 450, seed=8, pheno_seed=2, causal=30)
    if flags == ["--logistic"]:
        write_pheno(p, fam, [str(int(v > np.median(y))) for v in y])
    out = {k: str(tmp_path / f"{k}.tsv") for k in ("ref", "port", "res")}
    assert ref_cli.main(["gwas", p, "-o", out["ref"], "--stream-chunk",
                         "128", *flags]) == 0
    assert port_main(["gwas", p, "-o", out["port"], "--stream-chunk", "128",
                      *flags]) == 0
    assert port_main(["gwas", p, "-o", out["res"], *flags]) == 0
    capsys.readouterr()
    same_scan(out["port"], out["res"])
    same_scan(out["port"], out["ref"])


def test_cli_gwas_mesh_matches_single_chip(tmp_path, capsys):
    """tests/test_gwas.py::test_cli_gwas_mesh_matches_single_chip on the
    port: --mesh 4 (CPU shards) against the port's single-device scan at
    the reference test's rtol, and that against the reference's."""
    p, _, _ = fileset(tmp_path, 100, 400, seed=6, pheno_seed=1, causal=11,
                      name="m.bed")
    out1, out4, ref1 = (str(tmp_path / f) for f in ("one.tsv", "mesh.tsv",
                                                    "ref.tsv"))
    assert port_main(["gwas", p, "-o", out1]) == 0
    assert port_main(["gwas", p, "-o", out4, "--mesh", "4"]) == 0
    assert ref_cli.main(["gwas", p, "-o", ref1]) == 0
    r1 = np.loadtxt(out1, skiprows=1, usecols=(3, 4, 5))
    r4 = np.loadtxt(out4, skiprows=1, usecols=(3, 4, 5))
    np.testing.assert_allclose(r4, r1, rtol=2e-3, atol=1e-5)
    same_scan(out1, ref1)

    # mixed + LOCO ride the sharded operators too (on two chromosomes: the
    # port refuses a LOCO fold that leaves no SNP, see below)
    two_chromosomes(p)
    assert port_main(["gwas", p, "-o", out4, "--mesh", "4", "--mixed",
                      "--loco"]) == 0
    rows = [ln.split("\t") for ln in open(out4)]
    assert rows[0][0] == "chr" and len(rows) == 1 + 400
    assert port_main(["gwas", p, "-o", out1, "--mixed", "--loco"]) == 0
    same_scan(out4, out1, rtol=2e-3, atol=1e-5)
    # --mesh and --stream-chunk are mutually exclusive
    with pytest.raises(SystemExit):
        port_main(["gwas", p, "--mesh", "2", "--stream-chunk", "128"])
    capsys.readouterr()


@pytest.mark.parametrize("flags", [[], ["--mesh", "2"]],
                         ids=["resident", "mesh"])
def test_cli_gwas_loco_refuses_a_single_chromosome(tmp_path, capsys, flags):
    """Every SNP on one chromosome: its LOCO fold leaves sigma2 minus the
    whole of sigma2, float32 rounding noise of either sign (the reference
    scales its GRM by that noise where it comes out positive); the port
    refuses such a fold."""
    p, _, _ = fileset(tmp_path, 60, 200, seed=6, pheno_seed=1, causal=11)
    with pytest.raises(ValueError, match="carries the whole panel"):
        port_main(["gwas", p, "-o", str(tmp_path / "o.tsv"), "--mixed",
                   "--loco", *flags])
    capsys.readouterr()
