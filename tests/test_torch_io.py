"""The port's fileset readers and writers, the SNP-range readers, the
simulators and the GenoMatrix constructors' options against miraculix_tpu
on the same filesets.

Files written by either package must read the same in both, the chunked
simulator must write the reference's bytes, and the fused native ``from_bed``
must give the words and frequencies of the decode-and-pack path (its numpy
oracle) and of the reference, bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.io import codec as ref_codec  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.io import bed as pt_bed  # noqa: E402
from miraculix_tpu_torch.io import codec as pt_codec  # noqa: E402
from miraculix_tpu_torch.io import native  # noqa: E402

CPU = "cpu"
PANELS = [(37, 101, 0.0), (130, 259, 0.05), (257, 1030, 0.02)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=PANELS, ids=lambda p: "x".join(
    map(str, p)))
def fileset(request, tmp_path_factory):
    indiv, snps, missing_rate = request.param
    g = pt_bed.simulate_genotypes(indiv, snps, seed=indiv + snps,
                                  missing_rate=missing_rate)
    path = str(tmp_path_factory.mktemp("bed") / "p.bed")
    pt_bed.write_bed(path, g)
    return path, g


def _same_words(port, ref):
    for k in ("zq_n", "zq_t"):
        np.testing.assert_array_equal(
            getattr(port, k).numpy().view(np.uint32),
            np.asarray(getattr(ref, k)).view(np.uint32), err_msg=k)
    for k in ("freq", "pseudo_freq"):
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_bed_files_equal_reference(fileset, tmp_path):
    path, g = fileset
    with open(path, "rb") as fh:
        got = fh.read()
    ref_path = str(tmp_path / "r.bed")
    ref_bed.write_bed(ref_path, g)
    for ext in (".bed", ".bim", ".fam"):
        with open(ref_path[:-4] + ext, "rb") as fh:
            want = fh.read()
        with open(path[:-4] + ext, "rb") as fh:
            assert fh.read() == want, ext
    assert got[:3] == bytes([0x6C, 0x1B, 0x01])
    for reader in ("read_bed", "read_bed_payload", "read_bed_genotypes"):
        for a, b in zip(getattr(pt_bed, reader)(path),
                        getattr(ref_bed, reader)(path)):
            np.testing.assert_array_equal(a, b, err_msg=reader)


def test_companion_readers_equal_reference(fileset, tmp_path):
    path, g = fileset
    for p in (path, path[:-4] + ".bim", path[:-4] + ".fam"):
        assert pt_bed.read_bim(p) == ref_bed.read_bim(p)
        assert pt_bed.read_fam_ids(p) == ref_bed.read_fam_ids(p)
    assert pt_bed.read_bim(path)[5] == ["1", "snp5", "0", "6", "A", "B"]
    assert pt_bed.read_fam_ids(path)[3] == ("F3", "I3")
    freq = pt_codec.allele_freq(g, axis=0)
    files = {}
    for name, writer in (("port", pt_bed.write_freq),
                         ("ref", ref_bed.write_freq)):
        files[name] = str(tmp_path / f"{name}.freq")
        writer(files[name], freq)
        np.testing.assert_array_equal(pt_bed.read_freq(files[name]),
                                      ref_bed.read_freq(files[name]))
        np.testing.assert_allclose(pt_bed.read_freq(files[name]), freq,
                                   atol=1e-10)
    with open(files["port"], "rb") as a, open(files["ref"], "rb") as b:
        assert a.read() == b.read()


SLICES = {"whole": lambda n: (0, n), "first": lambda n: (0, 1),
          "inner": lambda n: (3, 40), "empty": lambda n: (5, 5),
          "reversed": lambda n: (7, 3), "last": lambda n: (n - 1, n),
          "past_end": lambda n: (0, n + 5),
          "wholly_past": lambda n: (n + 5, n + 9)}


@pytest.mark.parametrize("which", list(SLICES))
def test_bed_slices_equal_reference(fileset, which):
    path, g = fileset
    n = g.shape[1]
    s0, s1 = SLICES[which](n)
    for reader in ("read_bed_slice", "read_bed_slice_payload"):
        got = getattr(pt_bed, reader)(path, s0, s1)
        want = getattr(ref_bed, reader)(path, s0, s1)
        assert got[1:] == want[1:] == (n, g.shape[0])
        np.testing.assert_array_equal(got[0], want[0], err_msg=reader)
    plink = pt_bed.read_bed_slice(path, s0, s1)[0]
    hi = min(s1, n)
    np.testing.assert_array_equal(
        pt_codec.plink_to_dense(plink, g.shape[0]), g[:, min(s0, hi):hi])


def test_bed_slice_negative_start_raises(fileset):
    path, _ = fileset
    for reader in (pt_bed.read_bed_slice, pt_bed.read_bed_slice_payload):
        with pytest.raises(ValueError, match="snp_start"):
            reader(path, -1, 4)


def test_reader_errors_match_reference(tmp_path):
    g = pt_bed.simulate_genotypes(9, 11, seed=1)
    path = str(tmp_path / "p.bed")
    pt_bed.write_bed(path, g)
    with pytest.raises(ValueError, match="end in .bed"):
        pt_bed.read_bed_slice(path[:-4] + ".bim", 0, 3)
    with pytest.raises(ValueError, match="end in .bed"):
        pt_bed.simulate_bed(str(tmp_path / "x.txt"), 4, 4)
    with open(path, "r+b") as fh:
        fh.write(b"\x00")
    for mod in (pt_bed, ref_bed):
        with pytest.raises(ValueError, match="magic"):
            mod.read_bed_slice_payload(path, 0, 3)
    os.remove(path[:-4] + ".fam")
    for mod in (pt_bed, ref_bed):
        with pytest.raises(FileNotFoundError, match="supplementary"):
            mod.read_bed_slice(path, 0, 3)


@pytest.mark.parametrize("indiv,snps,chunk", [(45, 130, 50), (13, 7, 3),
                                              (64, 200, 65536)])
def test_simulate_bed_byte_equal_reference(tmp_path, indiv, snps, chunk):
    p, r = str(tmp_path / "p.bed"), str(tmp_path / "r.bed")
    pt_bed.simulate_bed(p, indiv, snps, seed=9, chunk_snps=chunk)
    ref_bed.simulate_bed(r, indiv, snps, seed=9, chunk_snps=chunk)
    for ext in (".bed", ".bim", ".fam"):
        with open(p[:-4] + ext, "rb") as a, open(r[:-4] + ext, "rb") as b:
            assert a.read() == b.read(), ext
    geno, _ = pt_bed.read_bed_genotypes(p)
    assert geno.shape == (indiv, snps) and geno.max() <= 2


def test_transpose_packed_and_column_unpack_equal_reference():
    g = pt_bed.simulate_genotypes(53, 301, seed=11, missing_rate=0.05)
    plink = pt_codec.dense_to_plink(g)
    tp = pt_codec.plink_transpose_packed(plink, 53, 301)
    np.testing.assert_array_equal(
        tp, ref_codec.plink_transpose_packed(plink, 53, 301))
    np.testing.assert_array_equal(pt_codec.plink_to_dense(tp, 301), g.T)
    w = pt_codec.pack_planar16(g, row_mult=256)
    cols = np.array([0, 5, 127, 128, 300, 17, 17, 2047])
    got = pt_codec.unpack_planar16_cols(w, 53, cols)
    np.testing.assert_array_equal(got,
                                  ref_codec.unpack_planar16_cols(w, 53, cols))
    np.testing.assert_array_equal(
        got[:, :5], np.where(g == 3, 0, g)[:, cols[:5]])
    np.testing.assert_array_equal(   # int32 words (the port's) read the same
        pt_codec.unpack_planar16_cols(w.view(np.int32), 53, cols), got)


def test_from_bed_fused_equals_numpy_path_and_reference(fileset):
    path, _ = fileset
    native.reset_call_counts()
    fused = mt.from_bed(path, device=CPU)
    assert native.CALLS["bed_ingest"] == 1
    with native.disabled():
        oracle = mt.from_bed(path, device=CPU)
    assert native.CALLS["bed_ingest"] == 1
    _same_words(fused, oracle)
    _same_words(fused, mx.from_bed(path))
    assert fused.miss_rows_n is None
    kept = mt.from_bed(path, keep_missing_info=True, device=CPU)
    assert native.CALLS["bed_ingest"] == 1       # the decode path
    _same_words(kept, fused)
    ref = mx.from_bed(path, keep_missing_info=True)
    np.testing.assert_array_equal(kept.miss_rows_n.numpy(),
                                  np.asarray(ref.miss_rows_n))
    np.testing.assert_array_equal(kept.miss_cols_n.numpy(),
                                  np.asarray(ref.miss_cols_n))


def test_row_mult_equals_reference(fileset):
    path, g = fileset
    for port, ref in (
            (mt.from_dense(g, row_mult=512, device=CPU),
             mx.from_dense(g, row_mult=512)),
            (mt.from_bed(path, row_mult=512, device=CPU),
             mx.from_bed(path, row_mult=512)),
            (mt.from_bed(path, row_mult=512, keep_missing_info=True,
                         device=CPU),
             mx.from_bed(path, row_mult=512, keep_missing_info=True))):
        assert port.zq_n.shape[0] % 512 == 0
        _same_words(port, ref)


@pytest.mark.parametrize("entry", ["from_dense", "from_bed", "from_plink"])
def test_device_put_false_is_not_ported(fileset, entry):
    """Named before host-resident panels were ported: ``device_put=False``
    now gives the reference's words and frequencies kept in host memory,
    with ``device`` the compute device, and its products equal the
    resident panel's."""
    path, g = fileset
    args = {"from_dense": (g,), "from_bed": (path,),
            "from_plink": (pt_codec.dense_to_plink(g), g.shape[1],
                           g.shape[0])}[entry]
    host = getattr(mt, entry)(*args, device_put=False, device=CPU)
    resident = getattr(mt, entry)(*args, device=CPU)
    ref = getattr(mx, entry)(*args, device_put=False)
    assert host.host_resident and not resident.host_resident
    assert host.device == torch.device(CPU) and host.zq_n.device.type == CPU
    _same_words(host, ref)
    rng = np.random.default_rng(1)
    for trans, rows in (("n", g.shape[1]), ("t", g.shape[0])):
        rhs = rng.standard_normal((rows, 3))
        np.testing.assert_array_equal(
            mt.dgemm(host, rhs, trans=trans).numpy(),
            mt.dgemm(resident, rhs, trans=trans).numpy())


def test_grm_blocked_from_bed_path(fileset):
    path, g = fileset
    native.reset_call_counts()
    got = mt.grm_blocked(path, row_block=512, device=CPU)
    assert native.CALLS["bed_ingest"] == 1
    want = mt.grm_blocked(mt.from_dense(g, device=CPU), row_block=512)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, mt.grm_blocked(g, row_block=512, device=CPU))
    with native.disabled():
        np.testing.assert_array_equal(
            mt.grm_blocked(path, row_block=512, device=CPU), want)
