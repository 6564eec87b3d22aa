"""The port's CLI against miraculix_tpu's: info, simulate, validate, ingest,
grm, ld, qc, pedigree and bench.

Both CLIs run on the same files written from a numpy seed
(``miraculix_tpu.cli.main([...])`` and
``miraculix_tpu_torch.cli.main(["--device", "cpu", ...])``), each into its
own outputs, and what they wrote and printed is compared: files of
integers, IDs, counts and prune lists byte for byte, ``.npy`` GRMs and LD
within 1e-5 of max, exit codes and ``SystemExit`` messages exactly.  The
reference's own CLI tests (test_qc.py, test_grm_io.py, test_vcf.py,
test_grm.py, test_pedigree.py) are kept as cases here with their
assertions, run on the port's outputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu import cli as ref_cli  # noqa: E402
from miraculix_tpu import ld_score as ref_ld_score  # noqa: E402
from miraculix_tpu.ops.grm import grm_yang as ref_grm_yang  # noqa: E402

from miraculix_tpu_torch import cli as pt_cli  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402
from miraculix_tpu_torch.io.grm_io import read_gcta_grm  # noqa: E402

GRM_RTOL = 1e-5     # .npy GRMs and LD, relative to max |reference|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_main(argv):
    return pt_cli.main(["--device", "cpu", *argv])


def both(tmp_path, capsys, make_argv):
    """Run ``make_argv(out)`` through the reference's CLI, then the port's;
    ``out(name)`` is a path of that side's own.  Returns [(rc, stdout,
    out)] for the reference and the port."""
    runs = []
    for side, main in (("ref", ref_cli.main), ("port", port_main)):
        def out(name, side=side):
            return str(tmp_path / f"{side}_{name}")
        rc = main(make_argv(out))
        runs.append((rc, capsys.readouterr().out, out))
    return runs


def both_exit(capsys, argv):
    """Both CLIs end in SystemExit on ``argv``: the port's message equals
    the reference's, which is returned."""
    msgs = []
    for main in (ref_cli.main, port_main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        msgs.append(str(exc.value.code))
    capsys.readouterr()
    assert msgs[1] == msgs[0]
    return msgs[0]


def held(got, want, rtol=GRM_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def write(tmp_path, g, name="p.bed"):
    p = str(tmp_path / name)
    bed.write_bed(p, g)
    return p


# -- info, simulate, validate, bench -----------------------------------------

def test_cli_info(capsys):
    assert ref_cli.main(["info"]) == 0
    assert port_main(["info"]) == 0
    assert capsys.readouterr().err.startswith("miraculix_tpu")


@pytest.mark.parametrize("extra", [[], ["--missing-rate", "0.05"],
                                   ["--stream-chunk", "64"]])
def test_cli_simulate_matches_reference(tmp_path, capsys, extra):
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["simulate", o("s.bed"), "--snps", "300",
                                     "--indiv", "41", "--seed", "5", *extra])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    exts = [".bed", ".bim", ".fam"] + ([] if extra[:1] == ["--stream-chunk"]
                                      else [".freq"])
    for ext in exts:
        same_bytes(o_p("s" + ext), o_r("s" + ext))


def test_cli_validate_matches_reference(capsys):
    argv = ["validate", "--snps", "700", "--indiv", "90", "--ncol", "5"]
    assert ref_cli.main(argv) == 0
    out_r = capsys.readouterr().out.splitlines()
    assert port_main(argv) == 0
    out_p = capsys.readouterr().out.splitlines()
    assert out_p[:4] == out_r[:4]          # the four codings' round trips
    assert all(ln.endswith(" ok") for ln in out_p) and len(out_p) == 6


def test_cli_bench_prints_the_reference_lines(capsys):
    """The reference's bench times through XLA scan timers that its CPU
    backend cannot run, so only the port runs: its two lines in the
    reference's format, then the phase report."""
    import re

    assert port_main(["bench", "--snps", "1024", "--indiv", "256", "--ncol",
                      "8", "--grm"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"dgemm:  [ \d.]{8} ms  [ \d.]{6} T geno-col-ops/s",
                        lines[0]), lines[0]
    assert re.fullmatch(r"GRM:    [ \d.]{8} ms  [ \d.]{6} TFLOP/s",
                        lines[1]), lines[1]
    assert [ln.split()[0] for ln in lines[2:]] == ["simulate", "pack", "h2d"]


# -- ingest ------------------------------------------------------------------

def _same_checkpoints(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_cli_ingest_bed(tmp_path, capsys):
    g = bed.simulate_genotypes(37, 301, seed=4, missing_rate=0.03)
    p = write(tmp_path, g)
    (rc_r, _, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["ingest", p, "-o", o("p.npz")])
    assert rc_r == rc_p == 0 and "GenoMatrix(snps=301, indiv=37" in out_p
    _same_checkpoints(o_p("p.npz"), o_r("p.npz"))


def test_cli_ingest_vcf(tmp_path, capsys):
    """tests/test_vcf.py::test_cli_ingest_vcf, on both CLIs: the converted
    filesets byte-equal, the checkpoints equal."""
    g = bed.simulate_genotypes(5, 12, seed=1)
    code = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}
    hdr = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
           "FILTER\tINFO\tFORMAT\t"
           + "\t".join(f"I{i}" for i in range(5)) + "\n")
    lines = [hdr]
    for s in range(12):
        fields = "\t".join(code[int(v)] for v in g[:, s])
        lines.append(f"1\t{s+1}\t.\tA\tG\t.\t.\t.\tGT\t{fields}\n")
    for side in ("ref", "port"):
        (tmp_path / f"{side}_x.vcf").write_text("".join(lines))
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["ingest", o("x.vcf"), "-o", o("p.npz")])
    assert rc_r == rc_p == 0
    assert out_p.splitlines()[0].replace("port_", "ref_") == \
        out_r.splitlines()[0]
    from miraculix_tpu_torch.geno import load

    gm = load(o_p("p.npz"), device="cpu")
    assert gm.indiv == 5 and gm.snps == 12
    for ext in (".bed", ".bim", ".fam"):
        same_bytes(o_p("x" + ext), o_r("x" + ext))
    _same_checkpoints(o_p("p.npz"), o_r("p.npz"))


# -- grm ---------------------------------------------------------------------

def test_cli_grm_gcta_out(tmp_path, capsys):
    """tests/test_grm_io.py::test_cli_grm_gcta_out, on both CLIs."""
    geno = bed.simulate_genotypes(24, 500, seed=3)
    bedp = write(tmp_path, geno)
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["grm", bedp, "-o", o("grm.npy"),
                                     "--gcta-out", o("g")])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    g_npy = np.load(o_p("grm.npy"))
    g2, c2, ids = read_gcta_grm(o_p("g"))
    np.testing.assert_allclose(g2, g_npy, atol=1e-5 * np.abs(g_npy).max())
    assert c2[0, 0] == 500.0 and len(ids) == 24
    held(g_npy, np.load(o_r("grm.npy")))
    same_bytes(o_p("g.grm.id"), o_r("g.grm.id"))
    same_bytes(o_p("g.grm.N.bin"), o_r("g.grm.N.bin"))
    held(np.fromfile(o_p("g.grm.bin"), np.float32),
         np.fromfile(o_r("g.grm.bin"), np.float32))


def test_cli_grm_gcta_out_pair_denominator_counts(tmp_path, capsys):
    """tests/test_grm_io.py::test_cli_grm_gcta_out_pair_denominator_counts:
    the co-called counts in .grm.N.bin, byte-equal to the reference's."""
    geno = bed.simulate_genotypes(20, 400, seed=8, missing_rate=0.06)
    bedp = write(tmp_path, geno, "m.bed")
    (rc_r, _, o_r), (rc_p, _, o_p) = both(
        tmp_path, capsys, lambda o: ["grm", bedp, "-o", o("grm.npy"),
                                     "--pair-denom", "--gcta-out", o("gm")])
    assert rc_r == rc_p == 0
    _, counts, ids = read_gcta_grm(o_p("gm"))
    dense, _ = bed.read_bed_genotypes(bedp)
    called = (dense != 3).astype(np.int64)
    np.testing.assert_array_equal(counts, called @ called.T)
    assert (counts < 400).any()
    same_bytes(o_p("gm.grm.N.bin"), o_r("gm.grm.N.bin"))
    same_bytes(o_p("gm.grm.id"), o_r("gm.grm.id"))
    held(np.load(o_p("grm.npy")), np.load(o_r("grm.npy")))


def test_cli_grm_pair_denom(tmp_path, capsys):
    """tests/test_grm.py::test_cli_grm_pair_denom: both methods, held to the
    reference library (its rtol) and to the reference's CLI (1e-5)."""
    g = bed.simulate_genotypes(60, 300, seed=41, missing_rate=0.05)
    p = write(tmp_path, g, "pd.bed")
    gm = mx.from_dense(g, keep_missing_info=True)
    for method, want in (
            ("vanraden", np.asarray(mx.grm(gm, pair_denominator=True))),
            ("yang", np.asarray(ref_grm_yang(gm, pair_denominator=True)))):
        (rc_r, _, o_r), (rc_p, _, o_p) = both(
            tmp_path, capsys, lambda o: ["grm", p, "--pair-denom", "--method",
                                         method, "-o", o(f"{method}.npy")])
        assert rc_r == rc_p == 0
        got = np.load(o_p(f"{method}.npy"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        held(got, np.load(o_r(f"{method}.npy")))


@pytest.mark.parametrize("flags", [[], ["--blocked", "--row-block", "16"],
                                   ["--method", "yang"], ["--dominance"]],
                         ids=["vanraden", "blocked", "yang", "dominance"])
def test_cli_grm_matches_reference(tmp_path, capsys, flags):
    g = bed.simulate_genotypes(45, 333, seed=12, missing_rate=0.02)
    p = write(tmp_path, g)
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["grm", p, "-o", o("g.npy"), *flags])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    held(np.load(o_p("g.npy")), np.load(o_r("g.npy")))


@pytest.mark.parametrize("flags", [["--pair-denom", "--blocked"],
                                   ["--pair-denom", "--dominance"],
                                   ["--dominance", "--blocked"],
                                   ["--dominance", "--method", "yang"],
                                   ["--method", "yang", "--blocked"]])
def test_cli_grm_guards_match_reference(tmp_path, capsys, flags):
    p = write(tmp_path, bed.simulate_genotypes(12, 64, seed=2))
    both_exit(capsys, ["grm", p, "-o", str(tmp_path / "g.npy"), *flags])


# -- ld ----------------------------------------------------------------------

def test_cli_ld_score_matches_dense_oracle(tmp_path, capsys):
    """tests/test_grm.py::test_ld_score_matches_dense_oracle's CLI part: the
    TSV against ld_score (its rtol) and the reference CLI's TSV."""
    n, snps, window = 150, 400, 32
    geno = bed.simulate_genotypes(n, snps, seed=77)
    p = write(tmp_path, geno, "l.bed")
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["ld", p, "--score", "--window",
                                     str(window), "-o", o("sc.tsv")])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    rows = [ln.split("\t") for ln in open(o_p("sc.tsv"))]
    rows_r = [ln.split("\t") for ln in open(o_r("sc.tsv"))]
    assert rows[0] == rows_r[0] and [r[0] for r in rows] == \
        [r[0] for r in rows_r]
    got = np.array([float(x[1]) for x in rows[1:]])
    np.testing.assert_allclose(
        got, ref_ld_score(mx.from_dense(geno), window=window), rtol=1e-4)
    held(got, [float(x[1]) for x in rows_r[1:]])


@pytest.mark.parametrize("flags", [["--window", "16"],
                                   ["--window", "16", "--squared"], [],
                                   ["--squared"]],
                         ids=["band", "band_r2", "full", "full_r2"])
def test_cli_ld_matches_reference(tmp_path, capsys, flags):
    g = bed.simulate_genotypes(70, 200, seed=9, missing_rate=0.01)
    p = write(tmp_path, g)
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["ld", p, "-o", o("ld.npy"), *flags])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    held(np.load(o_p("ld.npy")), np.load(o_r("ld.npy")))


@pytest.mark.parametrize("flags", [["--score", "--prune-r2", "0.3"],
                                   ["--score", "--squared"],
                                   ["--prune-r2", "0.3", "--squared"]])
def test_cli_ld_rejects_conflicting_modes(tmp_path, capsys, flags):
    """tests/test_qc.py::test_cli_ld_rejects_conflicting_modes, one case a
    conflicting pair, on both CLIs."""
    geno = bed.simulate_genotypes(30, 64, seed=11)
    p = write(tmp_path, geno, "c.bed")
    both_exit(capsys, ["ld", p, *flags])


# -- qc ----------------------------------------------------------------------

def test_cli_qc(tmp_path, capsys):
    """tests/test_qc.py::test_cli_qc, on both CLIs: the filtered filesets
    byte-equal."""
    g = bed.simulate_genotypes(40, 100, seed=11, maf_range=(0.01, 0.5))
    p = write(tmp_path, g, "q.bed")
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["qc", p, "-o", o("c.bed"), "--maf",
                                     "0.05"])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    n, s = bed.read_bed_genotypes(o_p("c.bed"))[0].shape
    assert n == 40 and 0 < s <= 100
    for ext in (".bed", ".bim", ".fam"):
        same_bytes(o_p("c" + ext), o_r("c" + ext))


def test_cli_qc_rel_cutoff_and_ld_prune(tmp_path, capsys):
    """tests/test_qc.py::test_cli_qc_rel_cutoff_and_ld_prune, on both CLIs:
    OUT.rel.id and the prune lists byte-equal."""
    base = bed.simulate_genotypes(60, 400, seed=6)
    geno = np.concatenate([base, base[:10]], axis=0)  # 10 duplicated rows
    p = write(tmp_path, geno, "q.bed")
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["qc", p, "-o", o("clean.bed"),
                                     "--rel-cutoff", "0.5"])
    assert rc_r == rc_p == 0
    assert ".rel.id" in out_p
    assert out_p.replace("port_", "ref_") == out_r
    kept = [ln.split() for ln in open(o_p("clean.rel.id"))]
    assert 55 <= len(kept) <= 65
    same_bytes(o_p("clean.rel.id"), o_r("clean.rel.id"))

    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["ld", p, "--prune-r2", "0.3", "--window",
                                     "64", "-o", o("pr")])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    kept_ids = open(o_p("pr") + ".prune.in").read().split()
    drop_ids = open(o_p("pr") + ".prune.out").read().split()
    assert len(kept_ids) + len(drop_ids) == 400
    assert set(kept_ids).isdisjoint(drop_ids) and len(kept_ids) > 0
    for ext in (".prune.in", ".prune.out"):
        same_bytes(o_p("pr") + ext, o_r("pr") + ext)


def test_cli_ld_prune_default_base(tmp_path, capsys):
    """Without -o the prune lists go beside the .bed (an ``.npy`` suffix of
    -o is dropped): the same names and bytes as the reference's."""
    g = bed.simulate_genotypes(50, 128, seed=3)
    for side in ("ref", "port"):
        write(tmp_path, g, f"{side}.bed")
    assert ref_cli.main(["ld", str(tmp_path / "ref.bed"),
                         "--prune-r2", "0.1"]) == 0
    assert port_main(["ld", str(tmp_path / "port.bed"),
                      "--prune-r2", "0.1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].replace("port", "ref") == out[0]
    for ext in (".prune.in", ".prune.out"):
        same_bytes(str(tmp_path / "port") + ext, str(tmp_path / "ref") + ext)


# -- pedigree ----------------------------------------------------------------

def test_cli_pedigree_report(tmp_path, capsys):
    """tests/test_pedigree.py::test_cli_pedigree_report, on both CLIs: the
    reports byte-equal."""
    f = tmp_path / "ped.txt"
    f.write_text("a 0 0\nb 0 0\nc a b\nd a b\ne c d\n")
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["pedigree", str(f), "-o", o("f.tsv")])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    lines = open(o_p("f.tsv")).read().splitlines()
    assert len(lines) == 6
    got = {ln.split("\t")[0]: float(ln.split("\t")[3]) for ln in lines[1:]}
    assert got["e"] == 0.25  # full-sib mating
    assert got["c"] == 0.0
    same_bytes(o_p("f.tsv"), o_r("f.tsv"))


@pytest.mark.parametrize("flags", [[], ["--no-inbreeding"]])
def test_cli_pedigree_simulated_matches_reference(tmp_path, capsys, flags):
    from miraculix_tpu_torch import pedigree

    sire, dam = pedigree.simulate_pedigree(600, n_founders=30, seed=5,
                                           unknown_rate=0.05)
    f = tmp_path / "ped.txt"
    f.write_text("".join(f"A{i + 1} {f'A{s}' if s else 0} "
                         f"{f'A{d}' if d else 0}\n"
                         for i, (s, d) in enumerate(zip(sire, dam))))
    (rc_r, out_r, o_r), (rc_p, out_p, o_p) = both(
        tmp_path, capsys, lambda o: ["pedigree", str(f), "-o", o("f.tsv"),
                                     *flags])
    assert rc_r == rc_p == 0
    assert out_p.replace("port_", "ref_") == out_r
    same_bytes(o_p("f.tsv"), o_r("f.tsv"))
