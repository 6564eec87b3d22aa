"""The port's storage codings, Transform and haplotype layer against
miraculix_tpu's on the same matrices.

Every coding's encoded buffer must be bit-equal to the reference's (dtype,
shape and bytes), its decode equal, and every ``CodedMatrix`` field equal;
the reference's hand-built golden byte tables (tests/test_coding_golden.py)
run unchanged against the port's codecs.
"""
import importlib.util
import inspect
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from miraculix_tpu import formats as rf  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402

from miraculix_tpu_torch import formats as pf  # noqa: E402
from miraculix_tpu_torch.formats import Coding  # noqa: E402

GENO = [c for c in Coding if c in pf.GENO_CODINGS]
HAPLO = [c for c in Coding if c in pf.HAPLO_CODINGS]


def rc(coding):
    """The reference's coding of the same name."""
    return rf.Coding(coding.value)


def same_buffer(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def same_coded(got, want):
    same_buffer(got.buf, want.buf)
    assert got.coding.value == want.coding.value
    assert (got.snps, got.indiv, got.is_haplo) == (
        want.snps, want.indiv, want.is_haplo)


@pytest.fixture(scope="module")
def dense():
    return ref_bed.simulate_genotypes(37, 211, seed=77)


def test_registry_matches_reference():
    assert [c.value for c in Coding] == [c.value for c in rf.Coding]
    assert {c.value for c in pf.GENO_CODINGS} == {
        c.value for c in rf.GENO_CODINGS}
    assert {c.value for c in pf.HAPLO_CODINGS} == {
        c.value for c in rf.HAPLO_CODINGS}
    assert set(pf.__all__) == set(rf.__all__)


@pytest.mark.parametrize("coding", GENO, ids=lambda c: c.value)
@pytest.mark.parametrize("missing", [False, True], ids=["clean", "missing"])
def test_geno_coding_bit_equal(dense, coding, missing):
    g = dense.copy()
    if coding == Coding.ONE_BIT:
        g = (g > 0).astype(np.uint8)
    elif missing:
        g[::5, ::7] = 3
    buf = pf.encode(g, coding)
    same_buffer(buf, rf.encode(g, rc(coding)))
    back = pf.decode(buf, coding, 37, 211)
    np.testing.assert_array_equal(back, rf.decode(buf, rc(coding), 37, 211))
    if coding != Coding.FIVE_CODES and coding != Coding.PLANAR16 \
            or not missing:
        np.testing.assert_array_equal(back, g)


@pytest.mark.parametrize("coding", HAPLO, ids=lambda c: c.value)
@pytest.mark.parametrize("shape", [(25, 40), (13, 29)],
                         ids=lambda s: "x".join(map(str, s)))
def test_haplo_coding_bit_equal(coding, shape):
    indiv, snps = shape
    h = pf.rhaplomatrix(np.full(snps, 0.4), indiv=indiv, seed=3).dense()
    buf = pf.encode(h, coding)
    same_buffer(buf, rf.encode(h, rc(coding)))
    np.testing.assert_array_equal(pf.decode(buf, coding, indiv, snps), h)


@pytest.mark.parametrize("coding", [Coding.ONE_BIT, Coding.TWO_BIT,
                                    Coding.FOUR_BIT, Coding.ONE_BIT_HAPLO,
                                    Coding.TWO_BIT_HAPLO],
                         ids=lambda c: c.value)
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint16])
def test_row_packers_take_any_integer_dtype(dense, coding, dtype):
    """The per-row bit packers compute in uint8; other integer inputs give
    the reference's bytes, odd widths (211 SNPs) padded as there."""
    g = dense if coding not in (Coding.ONE_BIT,) else dense > 1
    if coding == Coding.FOUR_BIT:
        g = dense * 5   # fields of 4 bits hold up to 15
    g = np.asarray(g).astype(dtype)
    same_buffer(pf.encode(g, coding), rf.encode(g, rc(coding)))


def test_one_bit_rejects_genotype_2(dense):
    with pytest.raises(ValueError, match="0/1"):
        pf.encode(dense, Coding.ONE_BIT)


def test_five_codes_density(dense):
    assert pf.encode(dense, Coding.FIVE_CODES).shape == (-(-37 // 5), 211)


@pytest.mark.parametrize("to_coding", GENO[1:], ids=lambda c: c.value)
def test_transform_any_to_any(dense, to_coding):
    src = pf.CodedMatrix(pf.encode(dense, Coding.ONE_BYTE), Coding.ONE_BYTE,
                         211, 37)
    ref = rf.CodedMatrix(rf.encode(dense, rf.Coding.ONE_BYTE),
                         rf.Coding.ONE_BYTE, 211, 37)
    got = pf.transform(src, to_coding)
    same_coded(got, rf.transform(ref, rc(to_coding)))
    np.testing.assert_array_equal(got.dense(), dense)


@pytest.mark.parametrize("kw", [
    dict(sel_snps=[3, 7, 100, 200], sel_indiv=[0, 5, 36]),
    dict(transpose=True),
    dict(sel_snps=list(range(0, 211, 3)), transpose=True),
], ids=["subselection", "transpose", "select+transpose"])
def test_transform_options(dense, kw):
    src = pf.CodedMatrix(pf.encode(dense, Coding.PLINK), Coding.PLINK,
                         211, 37)
    ref = rf.CodedMatrix(rf.encode(dense, rf.Coding.PLINK), rf.Coding.PLINK,
                         211, 37)
    got = pf.transform(src, Coding.TWO_BIT, **kw)
    same_coded(got, rf.transform(ref, rf.Coding.TWO_BIT, **kw))


@pytest.mark.parametrize("coding", [Coding.FIVE_CODES, Coding.PLANAR16,
                                    Coding.THREE_BIT],
                         ids=lambda c: c.value)
def test_transform_from_file(tmp_path, dense, coding):
    path = str(tmp_path / "f.bed")
    ref_bed.write_bed(path, dense)
    got = pf.from_file(path, coding)
    same_coded(got, rf.from_file(path, rc(coding)))
    np.testing.assert_array_equal(got.dense(), dense)


def test_from_file_ascii_table(tmp_path, dense):
    path = str(tmp_path / "g.txt")
    np.savetxt(path, dense[:, :20], fmt="%d")
    same_coded(pf.from_file(path, Coding.TWO_BIT),
               rf.from_file(path, rf.Coding.TWO_BIT))


def test_zero_geno(dense):
    src = pf.CodedMatrix(pf.encode(dense, Coding.ONE_BYTE), Coding.ONE_BYTE,
                         211, 37)
    ref = rf.CodedMatrix(rf.encode(dense, rf.Coding.ONE_BYTE),
                         rf.Coding.ONE_BYTE, 211, 37)
    got = pf.zero_geno(src, snps=[1, 2], indiv=[0, 3])
    same_coded(got, rf.zero_geno(ref, snps=[1, 2], indiv=[0, 3]))
    assert (got.dense()[np.ix_([0, 3], [1, 2])] == 0).all()


@pytest.mark.parametrize("coding", HAPLO, ids=lambda c: c.value)
def test_rhaplomatrix_equal(coding):
    freq = np.linspace(0.1, 0.9, 30)
    f2 = freq[::-1].copy()
    got = pf.rhaplomatrix(freq, indiv=50, freq2=f2, coding=coding, seed=2)
    same_coded(got, rf.rhaplomatrix(freq, indiv=50, freq2=f2,
                                    coding=rc(coding), seed=2))


def test_rhaplomatrix_frequencies():
    freq = np.linspace(0.1, 0.9, 30)
    m = pf.rhaplomatrix(freq, indiv=4000, seed=2)
    assert m.is_haplo and m.coding == Coding.TWO_BIT_HAPLO
    emp = pf.haplo_to_geno(m.dense()).mean(axis=0) / 2.0
    assert np.abs(emp - freq).max() < 0.05


def test_rhaplomatrix_rejects_geno_coding():
    with pytest.raises(ValueError, match="haplotype coding"):
        pf.rhaplomatrix(np.full(4, 0.5), indiv=3, coding=Coding.TWO_BIT)


def test_haplo_to_geno_transform_and_matrix():
    m = pf.rhaplomatrix(np.full(16, 0.5), indiv=10, seed=4)
    r = rf.rhaplomatrix(np.full(16, 0.5), indiv=10, seed=4)
    g = pf.transform(m, Coding.ONE_BYTE, haplo_to_geno=True)
    same_coded(g, rf.transform(r, rf.Coding.ONE_BYTE, haplo_to_geno=True))
    same_coded(pf.haplo_to_geno_matrix(m), rf.haplo_to_geno_matrix(r))


def test_haplo_geno_guards(dense):
    src = pf.CodedMatrix(pf.encode(dense, Coding.ONE_BYTE), Coding.ONE_BYTE,
                         211, 37)
    with pytest.raises(ValueError):
        pf.transform(src, Coding.TWO_BIT_HAPLO)
    with pytest.raises(ValueError):
        pf.transform(src, Coding.ONE_BYTE, haplo_to_geno=True)
    h = pf.rhaplomatrix(np.full(8, 0.5), indiv=4, seed=1)
    with pytest.raises(ValueError):
        pf.transform(h, Coding.TWO_BIT)


# -- the reference's golden byte tables, run against the port's codecs ------

def _golden_module():
    path = os.path.join(os.path.dirname(__file__), "test_coding_golden.py")
    spec = importlib.util.spec_from_file_location("ref_coding_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GOLDEN = _golden_module()


def _port_codecs(monkeypatch):
    """Point the golden module's ``encode``/``decode`` at the port's
    codecs (its ``Coding`` members map by value)."""
    monkeypatch.setattr(GOLDEN, "encode",
                        lambda d, c: pf.encode(d, Coding(c.value)))
    monkeypatch.setattr(GOLDEN, "decode", lambda b, c, i, s: pf.decode(
        b, Coding(c.value), i, s))


@pytest.mark.parametrize("name", sorted(
    n for n, f in vars(GOLDEN).items() if n.startswith("test_")
    and "coding" not in inspect.signature(f).parameters))
def test_golden_tables(monkeypatch, name):
    _port_codecs(monkeypatch)
    getattr(GOLDEN, name)()


@pytest.mark.parametrize("coding", [c for c in Coding if c in pf.GENO_CODINGS],
                         ids=lambda c: c.value)
def test_golden_round_trip_all(monkeypatch, coding):
    _port_codecs(monkeypatch)
    GOLDEN.test_round_trip_all(rc(coding))
