"""The port's native codec (``miraculix_tpu_torch/io/native``) against its
numpy oracle and against the reference's native wrappers.

Every wrapper must be bit-equal to the numpy version of ``io/codec.py`` and
to ``miraculix_tpu.io.native`` on the same seeded inputs: clean and
missing panels, ragged shapes (rows and columns off every multiple of 4,
16 and 256) and transposed views.  The fused ingestion must equal
``from_dense`` of the decoded payload, the per-individual statistics numpy,
the inbreeding coefficients the reference's Python oracle, and both prune
scans the greedy scan of ``ops/grm.py`` (MAF ties included).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import pedigree as ref_pedigree  # noqa: E402
from miraculix_tpu.io import codec as ref_codec  # noqa: E402
from miraculix_tpu.io import native as ref_native  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.io import bed as pt_bed  # noqa: E402
from miraculix_tpu_torch.io import codec, native  # noqa: E402
from miraculix_tpu_torch.ops.grm import _ld_prune_greedy  # noqa: E402

CPU = "cpu"
SHAPES = [(1, 1), (5, 3), (37, 101), (130, 259), (257, 515)]
MISSING = [0.0, 0.07]


@pytest.fixture(scope="module", autouse=True)
def _native_available():
    assert native.get_lib() is not None, "the native codec did not build"
    assert ref_native.get_lib() is not None


def _panel(shape, missing_rate):
    rows, cols = shape
    return pt_bed.simulate_genotypes(rows, cols, seed=rows * 7 + cols,
                                     missing_rate=missing_rate)


def _counted(name, fn, *args, **kw):
    """fn(*args) with the check that it ran ``name`` natively once more."""
    before = native.CALLS[name]
    out = fn(*args, **kw)
    assert native.CALLS[name] > before, name
    return out


@pytest.mark.parametrize("missing_rate", MISSING)
@pytest.mark.parametrize("shape", SHAPES)
def test_plink_codecs_bit_equal(shape, missing_rate):
    g = _panel(shape, missing_rate)
    plink = _counted("dense_to_plink", codec.dense_to_plink, g)
    np.testing.assert_array_equal(plink, codec.dense_to_plink_numpy(g))
    np.testing.assert_array_equal(plink, ref_codec.dense_to_plink(g))
    dense = _counted("plink_to_dense", codec.plink_to_dense, plink, shape[0])
    np.testing.assert_array_equal(dense, g)
    np.testing.assert_array_equal(
        dense, codec.plink_to_dense_numpy(plink, shape[0]))
    payload = codec.transpose_u8(plink)            # the .bed's SNP-major form
    np.testing.assert_array_equal(payload, plink.T)
    dt = _counted("payload_to_dense", codec.payload_to_dense, payload,
                  shape[0])
    np.testing.assert_array_equal(dt, g.T)
    np.testing.assert_array_equal(
        dt, codec.payload_to_dense_numpy(payload, shape[0]))
    np.testing.assert_array_equal(
        codec.plink_transpose_packed(plink, *shape),
        ref_codec.plink_transpose_packed(plink, *shape))


@pytest.mark.parametrize("missing_rate", MISSING)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("row_mult", [8, 256])
def test_pack_planar16_bit_equal(shape, missing_rate, row_mult):
    g = _panel(shape, missing_rate)
    for src in (g, g.T, np.ascontiguousarray(g.T), g[::-1]):
        w = _counted("pack_planar16", codec.pack_planar16, src,
                     row_mult=row_mult)
        np.testing.assert_array_equal(
            w, codec.pack_planar16_numpy(src, row_mult=row_mult))
        np.testing.assert_array_equal(
            w, ref_codec.pack_planar16(np.ascontiguousarray(src),
                                       row_mult=row_mult))
        np.testing.assert_array_equal(
            w, ref_native.pack_planar16(src, *codec.planar16_dims(
                *src.shape, row_mult=row_mult)))


@pytest.mark.parametrize("missing_rate", MISSING)
@pytest.mark.parametrize("shape", SHAPES)
def test_allele_freq_and_scans_bit_equal(shape, missing_rate):
    g = _panel(shape, missing_rate)
    for axis in (0, 1):
        f = _counted("allele_freq", codec.allele_freq, g, axis)
        np.testing.assert_array_equal(f, codec.allele_freq_numpy(g, axis))
        np.testing.assert_array_equal(f, ref_codec.allele_freq(g, axis))
    np.testing.assert_array_equal(native.allele_freq(g),
                                  ref_native.allele_freq(g))
    np.testing.assert_array_equal(
        _counted("transpose_u8", native.transpose_u8, g.T), g)
    assert native.count_missing(g) == ref_native.count_missing(g) \
        == int((g == 3).sum())


@pytest.mark.parametrize("missing_rate", MISSING)
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_bed_ingest_equals_from_dense(shape, missing_rate):
    g = _panel(shape, missing_rate)
    indiv, snps = shape
    payload = codec.transpose_u8(codec.dense_to_plink(g))
    ipad, kws = codec.planar16_dims(indiv, snps, row_mult=256)
    spad, kwi = codec.planar16_dims(snps, indiv, row_mult=256)
    args = (payload, snps, indiv, spad, kwi, ipad, kws)
    zqt, zqn, freq, pfreq = _counted("bed_ingest", native.bed_ingest, *args)
    dense = codec.plink_to_dense_numpy(payload.T, indiv)
    with native.disabled():
        want = mt.from_dense(dense, device=CPU)
    np.testing.assert_array_equal(zqn.view(np.int32), want.zq_n.numpy())
    np.testing.assert_array_equal(zqt.view(np.int32), want.zq_t.numpy())
    np.testing.assert_array_equal(freq, codec.allele_freq_numpy(dense, 0))
    np.testing.assert_array_equal(pfreq, codec.allele_freq_numpy(dense, 1))
    for got, ref in zip((zqt, zqn, freq, pfreq), ref_native.bed_ingest(*args)):
        np.testing.assert_array_equal(got, ref)
    # each big output may be skipped; freq is always computed
    only_n = native.bed_ingest(*args, want_t=False, want_pfreq=False)
    assert only_n[0] is None and only_n[3] is None
    np.testing.assert_array_equal(only_n[1], zqn)
    np.testing.assert_array_equal(only_n[2], freq)
    only_f = native.bed_ingest(*args, want_t=False, want_n=False,
                               want_pfreq=False)
    np.testing.assert_array_equal(only_f[2], freq)


@pytest.mark.parametrize("missing_rate", MISSING)
@pytest.mark.parametrize("shape", SHAPES)
def test_bed_colstats_equal_numpy(shape, missing_rate):
    g = _panel(shape, missing_rate)
    indiv, snps = shape
    payload = codec.transpose_u8(codec.dense_to_plink(g))
    s, c = _counted("bed_colstats", native.bed_colstats, payload, snps, indiv)
    called = g != 3
    np.testing.assert_array_equal(s, np.where(called, g, 0).sum(
        axis=1, dtype=np.int64))
    np.testing.assert_array_equal(c, called.sum(axis=1, dtype=np.int64))
    for got, ref in zip((s, c), ref_native.bed_colstats(payload, snps,
                                                        indiv)):
        np.testing.assert_array_equal(got, ref)


def _pedigree(n, seed):
    """Parents-first pedigree with unknown parents, inbred matings and runs
    of full sibs."""
    rng = np.random.default_rng(seed)
    sire, dam = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(10, n):
        if rng.random() < 0.3 and sire[i - 1]:        # a full sib
            sire[i], dam[i] = sire[i - 1], dam[i - 1]
            continue
        lo = max(0, i - 40)                            # recent: inbreeding
        sire[i] = rng.integers(lo, i) + 1 if rng.random() < 0.9 else 0
        dam[i] = rng.integers(lo, i) + 1 if rng.random() < 0.9 else 0
    return sire, dam


@pytest.mark.parametrize("n,seed", [(1, 0), (60, 1), (400, 2)])
def test_inbreeding_equals_reference_python(n, seed):
    sire, dam = _pedigree(n, seed)
    f = _counted("inbreeding", native.inbreeding, sire, dam)
    want = ref_pedigree._inbreeding_py(sire, dam)
    np.testing.assert_allclose(f, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(f, ref_pedigree.inbreeding(sire, dam))
    if n > 100:
        assert (f > 0.05).sum() > 10          # the pedigree is inbred


@pytest.mark.parametrize("snps,window,seed", [
    (1, 1, 0), (7, 3, 1), (300, 16, 2), (1000, 64, 3), (517, 600, 4)])
def test_ld_prune_scans_equal_greedy(snps, window, seed):
    rng = np.random.default_rng(seed)
    band2 = rng.random((snps, window), dtype=np.float32)
    band2[rng.random((snps, window)) < 0.1] = np.float32(0.7)  # at the limit
    maf = rng.choice([0.05, 0.2, 0.2, 0.35], size=snps)   # many MAF ties
    thr = 0.7
    want = _ld_prune_greedy(band2 > thr, maf, snps, window)
    got = _counted("ld_prune", native.ld_prune, band2, maf, thr)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_native.ld_prune(band2, maf, thr))
    mask = (band2 > thr).astype(np.uint8)
    got = _counted("ld_prune_mask", native.ld_prune_mask, mask, maf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_native.ld_prune_mask(mask, maf))
    if snps > 100:
        assert 0 < (~want).sum() < snps


def test_disabled_runs_numpy():
    g = _panel((37, 101), 0.07)
    native.reset_call_counts()
    with native.disabled():
        assert native.get_lib() is None
        assert native.pack_planar16(g, 40, 128) is None
        w = codec.pack_planar16(g)
        f = codec.allele_freq(g, 1)
    assert not any(native.CALLS.values())
    np.testing.assert_array_equal(w, codec.pack_planar16(g))
    np.testing.assert_array_equal(f, codec.allele_freq(g, 1))
    assert native.CALLS["pack_planar16"] == 1
    assert native.codec_version() == ref_native.get_lib().mx_codec_version()


def test_failed_build_warns_once(tmp_path, monkeypatch):
    """A build that fails warns once with g++'s messages, and the codec
    then runs numpy."""
    bad = tmp_path / "codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with pytest.warns(RuntimeWarning, match="(?s)g\\+\\+ failed.*error"):
        assert native.get_lib() is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert native.get_lib() is None
        g = _panel((5, 3), 0.0)
        np.testing.assert_array_equal(codec.dense_to_plink(g),
                                      ref_codec.dense_to_plink(g))


@pytest.mark.parametrize("call", [
    lambda: native.plink_to_dense(np.zeros((2, 3), np.uint8), 9),
    lambda: native.payload_to_dense(np.zeros((3, 2), np.uint8), 9),
    lambda: native.pack_planar16(np.zeros((300, 3), np.uint8), 256, 128),
    lambda: native.bed_ingest(np.zeros((3, 2), np.uint8), 3, 9, 256, 128,
                              256, 128),
    lambda: native.bed_colstats(np.zeros((3, 2), np.uint8), 4, 8),
    lambda: native.inbreeding(np.array([0, 2]), np.array([0, 0])),
    lambda: native.inbreeding(np.array([0, 1]), np.array([0])),
    lambda: native.ld_prune(np.zeros((4, 2), np.float32), np.zeros(3), 0.2),
    lambda: native.ld_prune_mask(np.zeros((4, 2), np.uint8), np.zeros(5)),
], ids=["plink", "payload", "pack", "ingest", "colstats", "parent_after",
        "lengths", "prune", "prune_mask"])
def test_wrappers_reject_sizes_the_code_would_overrun(call):
    with pytest.raises(ValueError):
        call()
