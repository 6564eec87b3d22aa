"""The port's panel QC, VCF ingestion and GCTA GRM files against
miraculix_tpu's on the same inputs.

Counts, masks and p-values must be equal, and every file the port writes
(``qc_filter``'s fileset, ``vcf_to_bed``'s, ``write_gcta_grm``'s) byte-equal
to the one the reference writes.  The CLI cases of the reference's
test_qc.py, test_vcf.py and test_grm_io.py are in test_torch_cli_io.py.
"""
import gzip
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from miraculix_tpu import qc as rqc  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.io import grm_io as rgio  # noqa: E402
from miraculix_tpu.io import vcf as rvcf  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import qc  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402
from miraculix_tpu_torch.io import grm_io, vcf  # noqa: E402

CPU = "cpu"
HDR = ("##fileformat=VCFv4.2\n"
       "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
       "S1\tS2\tS3\n")


def _write(tmp_path, g, name="q.bed"):
    p = str(tmp_path / name)
    bed.write_bed(p, g)
    return p


def _same_files(a, b, exts):
    for ext in exts:
        with open(a + ext, "rb") as fa, open(b + ext, "rb") as fb:
            assert fa.read() == fb.read(), ext


# -- QC ----------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [64, 128, 65_536])
def test_snp_stats_equal_reference_and_oracle(tmp_path, chunk):
    g = bed.simulate_genotypes(103, 517, seed=3, missing_rate=0.08)
    p = _write(tmp_path, g)
    counts, imiss = qc.snp_stats(p, chunk_snps=chunk)
    rcounts, rimiss = rqc.snp_stats(p, chunk_snps=chunk)
    np.testing.assert_array_equal(counts, rcounts)
    np.testing.assert_array_equal(imiss, rimiss)
    assert counts.dtype == rcounts.dtype and imiss.dtype == rimiss.dtype
    for v in range(4):
        np.testing.assert_array_equal(counts[:, v], (g == v).sum(axis=0))
    np.testing.assert_array_equal(imiss, (g == 3).sum(axis=1))


def test_hwe_p_values_equal_reference():
    g = bed.simulate_genotypes(400, 200, seed=5)
    counts = np.stack([(g == v).sum(axis=0) for v in range(4)], axis=1)
    counts = np.concatenate([counts, [[0, 400, 0, 0], [400, 0, 0, 0],
                                      [0, 0, 0, 400]]])
    pv = qc.hwe_chi2_p(counts)
    np.testing.assert_array_equal(pv, rqc.hwe_chi2_p(counts))
    assert pv[-3] < 1e-50 and pv[-2] == 1.0 and pv[-1] == 1.0
    assert (pv[:-3] < 0.05).mean() < 0.12


def _qc_panel():
    rng = np.random.default_rng(9)
    g = bed.simulate_genotypes(120, 400, seed=7,
                               maf_range=(0.005, 0.5)).astype(np.uint8)
    g[:3, ::2] = 3                     # 3 bad individuals
    g[:, :5] = np.where(rng.random((120, 5)) < 0.4, 3, g[:, :5])
    g[:, 7] = np.where(g[:, 7] == 3, 3, 1)   # heterozygote excess
    return g


@pytest.mark.parametrize("kw", [
    dict(maf=0.05, geno=0.2, mind=0.3, chunk_snps=64),
    dict(maf=0.05, geno=0.2, chunk_snps=64),
    dict(hwe=1e-6),
    dict(maf=0.01, geno=0.05, hwe=1e-6, mind=0.1),
    dict(),
], ids=["mind-maf-geno", "maf-geno", "hwe", "all", "defaults"])
def test_qc_filter_equal_reference(tmp_path, kw):
    g = _qc_panel()
    p = _write(tmp_path, g)
    out, rout = str(tmp_path / "f.bed"), str(tmp_path / "r.bed")
    keep_s, keep_i = qc.qc_filter(p, out, **kw)
    rkeep_s, rkeep_i = rqc.qc_filter(p, rout, **kw)
    np.testing.assert_array_equal(keep_s, rkeep_s)
    np.testing.assert_array_equal(keep_i, rkeep_i)
    _same_files(out[:-4], rout[:-4], (".bed", ".bim", ".fam"))
    back, _ = bed.read_bed_genotypes(out)
    np.testing.assert_array_equal(back, g[np.ix_(keep_i, keep_s)])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_qc_filter_numpy_oracle(tmp_path):
    """PLINK's order: mind first, then the per-SNP filters on the kept
    individuals."""
    g = _qc_panel()
    p = _write(tmp_path, g)
    keep_s, keep_i = qc.qc_filter(p, str(tmp_path / "f.bed"), maf=0.05,
                                  geno=0.2, mind=0.3, chunk_snps=64)
    ki = (g == 3).mean(axis=1) <= 0.3
    gk = g[ki]
    nc = (gk != 3).sum(axis=0)
    p_alt = np.where(gk == 3, 0, gk).astype(float).sum(axis=0) / np.maximum(
        2 * nc, 1)
    maf = np.minimum(p_alt, 1 - p_alt)
    ks = (nc > 0) & ((gk == 3).mean(axis=0) <= 0.2) & (maf >= 0.05)
    np.testing.assert_array_equal(keep_i, ki)
    np.testing.assert_array_equal(keep_s, ks)


def test_qc_filter_rejects_non_bed_paths(tmp_path):
    p = _write(tmp_path, bed.simulate_genotypes(8, 12, seed=1))
    with pytest.raises(ValueError, match=".bed"):
        qc.qc_filter(p, str(tmp_path / "out.txt"))
    with pytest.raises(ValueError, match=".bed"):
        qc.snp_stats(p[:-4] + ".bim")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_cutoff_equal_reference(seed):
    n = 40
    rng = np.random.default_rng(seed)
    g = np.eye(n) + np.where(rng.random((n, n)) < 0.08, 0.3, 0.02)
    g = (g + g.T) / 2
    keep = qc.rel_cutoff(g, cutoff=0.125)
    np.testing.assert_array_equal(keep, rqc.rel_cutoff(g, cutoff=0.125))
    sub = g[np.ix_(keep, keep)].copy()
    np.fill_diagonal(sub, 0)
    assert sub.max() <= 0.125


def test_rel_cutoff_clique_pair_hub():
    n = 12
    g = np.eye(n)
    for i, j in [(0, 1), (0, 2), (1, 2), (5, 6), (9, 10), (9, 11)]:
        g[i, j] = g[j, i] = 0.3
    keep = qc.rel_cutoff(g, cutoff=0.125)
    assert keep.sum() == n - 4 and not keep[9] and keep[10] and keep[11]


def test_blank_fam_line_does_not_mis_dimension(tmp_path):
    g = bed.simulate_genotypes(9, 30, seed=2)
    p = _write(tmp_path, g)
    with open(p[:-4] + ".fam", "a") as fh:
        fh.write("\n")
    with open(p[:-4] + ".bim", "a") as fh:
        fh.write("\n\n")
    counts, imiss = qc.snp_stats(p)
    assert counts.shape == (30, 4) and len(imiss) == 9
    np.testing.assert_array_equal(counts, rqc.snp_stats(p)[0])


# -- VCF ---------------------------------------------------------------------

def test_vcf_gt_semantics_equal_reference(tmp_path):
    body = (
        "1\t100\trs1\tA\tG\t.\tPASS\t.\tGT\t0/0\t0/1\t1/1\n"
        "1\t200\trs2\tC\tT\t.\tPASS\t.\tGT:DP\t1|0:9\t./.:3\t0|0:7\n"
        "1\t300\trs3\tG\tA,C\t.\tPASS\t.\tGT\t0/0\t0/0\t0/0\n"
        "1\t400\trs4\tT\tC\t.\tPASS\t.\tDP:GT\t5:1/1\t2:./1\t1:0/1\n"
        "X\t500\t.\tT\tC\t.\tPASS\t.\tGT\t0\t1\t.\n"
        "1\t600\trs6\tT\t.\t.\tPASS\t.\tGT\t0/0\t0/0\t0/0\n"
        "1\t700\trs7\tA\tC\t.\tPASS\t.\tDP\t1\t2\t3\n"
        "1\t800\trs8\tA\tC\t.\tPASS\t.\tDP:GT\t1\t2:1/1\t3:0|1\r\n"
    )
    p = str(tmp_path / "t.vcf")
    with open(p, "w") as fh:
        fh.write(HDR + body)
    geno, samples, variants = vcf.read_vcf(p)
    rgeno, rsamples, rvariants = rvcf.read_vcf(p)
    np.testing.assert_array_equal(geno, rgeno)
    assert geno.dtype == rgeno.dtype
    assert (samples, variants) == (rsamples, rvariants)
    assert [v[2] for v in variants] == ["rs1", "rs2", "rs4", ".", "rs8"]
    np.testing.assert_array_equal(geno[:, :3], np.array(
        [[0, 1, 2], [1, 3, 0], [2, 3, 1]], np.uint8).T)


@pytest.mark.parametrize("text, match", [
    ("1\t1\tr\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n", "before #CHROM"),
    ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
     "1\t1\tr\tA\tG\t.\t.\t.\n", "sites-only"),
    (HDR + "1\t1\tr\tA\tG\t.\t.\t.\tGT\t0/0\t0/1\n", "sample fields"),
    (HDR + "1\t1\tr\tA\tG,T\t.\t.\t.\tGT\t0/0\t0/1\t1/1\n", "no usable"),
], ids=["no-header", "sites-only", "short-record", "nothing-usable"])
def test_vcf_errors_as_reference(tmp_path, text, match):
    p = str(tmp_path / "e.vcf")
    with open(p, "w") as fh:
        fh.write(text)
    with pytest.raises(ValueError, match=match):
        vcf.read_vcf(p)
    with pytest.raises(ValueError, match=match):
        rvcf.read_vcf(p)


@pytest.mark.parametrize("compressed", [False, True], ids=["plain", "gzip"])
def test_vcf_to_bed_byte_equal_reference(tmp_path, compressed):
    g = bed.simulate_genotypes(7, 25, seed=9, missing_rate=0.1)
    lines = [HDR.replace("S1\tS2\tS3", "\t".join(f"I{i}" for i in range(7)))]
    code = {0: "0/0", 1: "0/1", 2: "1/1", 3: "./."}
    for s in range(25):
        fields = "\t".join(code[int(v)] for v in g[:, s])
        vid = "." if s % 5 == 0 else f"v{s}"
        lines.append(f"2\t{s + 1}\t{vid}\tA\tG\t.\t.\t.\tGT\t{fields}\n")
    p = str(tmp_path / ("t.vcf.gz" if compressed else "t.vcf"))
    with (gzip.open(p, "wt") if compressed else open(p, "w")) as fh:
        fh.write("".join(lines))
    port_bed, ref_bedp = str(tmp_path / "c.bed"), str(tmp_path / "r.bed")
    assert vcf.vcf_to_bed(p, port_bed) == (7, 25)
    assert rvcf.vcf_to_bed(p, ref_bedp) == (7, 25)
    _same_files(port_bed[:-4], ref_bedp[:-4], (".bed", ".bim", ".fam"))
    back, _ = bed.read_bed_genotypes(port_bed)
    np.testing.assert_array_equal(back, g)
    gm = mt.from_bed(port_bed, device=CPU)
    assert gm.indiv == 7 and gm.snps == 25
    a1, a2 = open(port_bed[:-4] + ".bim").readline().split()[4:6]
    assert (a1, a2) == ("A", "G")


# -- GCTA GRM files -----------------------------------------------------------

def test_gcta_layout_bytes(tmp_path):
    g = np.array([[1.0, 0.25, 0.5],
                  [0.25, 1.1, -0.125],
                  [0.5, -0.125, 0.9]])
    p = str(tmp_path / "t")
    grm_io.write_gcta_grm(p, g, 777, ids=["F1 A", "F2 B", "F3 C"])
    np.testing.assert_array_equal(
        np.fromfile(p + ".grm.bin", dtype="<f4"),
        np.array([1.0, 0.25, 1.1, 0.5, -0.125, 0.9], "<f4"))
    np.testing.assert_array_equal(np.fromfile(p + ".grm.N.bin", dtype="<f4"),
                                  np.full(6, 777.0, "<f4"))
    assert open(p + ".grm.id").read() == "F1\tA\nF2\tB\nF3\tC\n"


@pytest.mark.parametrize("ids", [None, "strings", "pairs", "iids"])
@pytest.mark.parametrize("counts", ["scalar", "pairs"])
def test_gcta_files_byte_equal_reference(tmp_path, ids, counts):
    rng = np.random.default_rng(0)
    m = rng.standard_normal((17, 40))
    g = m @ m.T / 40
    cnt = 40 if counts == "scalar" else np.full((17, 17), 40.0)
    if counts == "pairs":
        cnt[0, 1] = cnt[1, 0] = 38.0
    lab = {None: None,
           "strings": [f"F{i} I{i}" for i in range(17)],
           "pairs": [(f"F{i}", f"I{i}") for i in range(17)],
           "iids": [f"I{i}" for i in range(17)]}[ids]
    p, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    grm_io.write_gcta_grm(p, g, cnt, ids=lab)
    rgio.write_gcta_grm(rp, g, cnt, ids=lab)
    _same_files(p, rp, (".grm.bin", ".grm.N.bin", ".grm.id"))
    g2, c2, got_ids = grm_io.read_gcta_grm(p)
    rg2, rc2, rids = rgio.read_gcta_grm(p)
    np.testing.assert_array_equal(g2, rg2)
    np.testing.assert_array_equal(c2, rc2)
    assert got_ids == rids and len(got_ids) == 17
    np.testing.assert_allclose(g2, g, atol=1e-6)
    assert np.array_equal(g2, g2.T)


def test_gcta_read_constant_count_and_errors(tmp_path):
    g = np.eye(4) * 2.0
    p = str(tmp_path / "c")
    grm_io.write_gcta_grm(p, g, 9)
    np.array([5.0], "<f4").tofile(p + ".grm.N.bin")  # one constant
    _, c, _ = grm_io.read_gcta_grm(p)
    assert (c == 5.0).all()
    np.array([5.0, 6.0], "<f4").tofile(p + ".grm.N.bin")
    with pytest.raises(ValueError, match="grm.N.bin"):
        grm_io.read_gcta_grm(p)
    np.zeros(3, "<f4").tofile(p + ".grm.bin")
    with pytest.raises(ValueError, match="expected 10"):
        grm_io.read_gcta_grm(p)
    with pytest.raises(ValueError, match="square"):
        grm_io.write_gcta_grm(p, np.zeros((2, 3)), 1)


@pytest.mark.parametrize("n", [256, 300, 555])
def test_gcta_round_trip_past_one_block(tmp_path, n):
    """The row-wise writer and the blocked mirror of the reader, on sizes
    at and across the mirror's 256-row blocks."""
    rng = np.random.default_rng(n)
    g = rng.standard_normal((n, n)).astype(np.float32)
    g = g + g.T
    cnt = rng.integers(0, 500, (n, n)).astype(np.float64)
    cnt = cnt + cnt.T
    p, rp = str(tmp_path / "port"), str(tmp_path / "ref")
    grm_io.write_gcta_grm(p, g, cnt)
    rgio.write_gcta_grm(rp, g, cnt)
    _same_files(p, rp, (".grm.bin", ".grm.N.bin", ".grm.id"))
    got, want = grm_io.read_gcta_grm(p), rgio.read_gcta_grm(p)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], g.astype(np.float64))
