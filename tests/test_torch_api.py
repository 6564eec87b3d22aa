"""The port's user surface against miraculix_tpu on the same inputs: the C
API facade (``api``), the R API (``rapi``), the packed-panel cache, the
MoBPS bridge, ``Options``, the float64 oracles, logging, and every new
module's public signatures.

Facade outputs must lie within 1e-5 (of max |output|) of the reference's
on the same bytes and within the reference's own 1e-4 of ``ref_impl``'s
float64 oracles; integer crossproducts, frequencies and host results are
equal.  The port's panels are built on the CPU here (``device="cpu"``).
"""
import dataclasses
import enum
import importlib
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from miraculix_tpu import api as rapi_c  # noqa: E402
from miraculix_tpu import mobps as rmobps  # noqa: E402
from miraculix_tpu import rapi as rrapi  # noqa: E402
from miraculix_tpu.formats import Coding as RCoding  # noqa: E402
from miraculix_tpu.formats import CodedMatrix as RCodedMatrix  # noqa: E402
from miraculix_tpu.formats import encode as rencode  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.ops import ref_impl as rref  # noqa: E402
from miraculix_tpu.options import Options as ROptions  # noqa: E402
from miraculix_tpu.utils import panel_cache as rcache  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import api, mobps, rapi  # noqa: E402
from miraculix_tpu_torch.formats import Coding, CodedMatrix, encode  # noqa: E402
from miraculix_tpu_torch.io import bed, codec  # noqa: E402
from miraculix_tpu_torch.ops import ref_impl  # noqa: E402
from miraculix_tpu_torch.options import Options  # noqa: E402
from miraculix_tpu_torch.utils import logging as mlog  # noqa: E402
from miraculix_tpu_torch.utils import panel_cache  # noqa: E402

CPU = "cpu"
PORT_TOL = 1e-5   # port vs reference, relative to max |reference|
REF_TOL = 1e-4    # the reference's own tolerance against ref_impl


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_state():
    """Both packages' option latches and panel caches start empty."""
    for latch in (api, rapi_c):
        latch.set_options()
    panel_cache.clear()
    rcache.clear()
    yield
    api.set_options()
    rapi_c.set_options()
    panel_cache.clear()
    rcache.clear()


def close(got, want, tol=PORT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= tol, np.abs(
        got - want).max() / scale


@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    g = bed.simulate_genotypes(123, 800, seed=33)
    path = str(tmp_path_factory.mktemp("api") / "t.bed")
    bed.write_bed(path, g)
    plink, n_snps, n_indiv = bed.read_bed(path)
    return g, plink, n_snps, n_indiv


# -- the C API ----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_flow(fileset):
    """tests/dgemm_compressed/test.jl's flow through both facades, once."""
    g, plink, n_snps, n_indiv = fileset
    rng = np.random.default_rng(42)
    b = rng.standard_normal((n_snps, 10))
    b_t = rng.standard_normal((n_indiv, 10))
    freq = codec.allele_freq(g)
    plink_t = codec.plink_transpose_packed(plink, n_indiv, n_snps)
    out = {}
    for name, mod, kw in (("port", api, dict(device=CPU)),
                          ("ref", rapi_c, {})):
        mod.set_options(use_gpu=True, print_details=0)
        obj = mod.plink2compressed(plink, plink_t, n_snps, n_indiv, freq, 10,
                                   **kw)
        out[name] = dict(
            obj=obj, c=mod.dgemm_compressed("N", obj, 10, b),
            c_t=mod.dgemm_compressed("T", obj, 10, b_t),
            f=mod.get_compressed_freq(obj))
        mod.set_options()
    out["want"] = ref_impl.dgemm_oracle(g, b, freq, trans="n")
    out["want_t"] = ref_impl.dgemm_oracle(g, b_t, freq, trans="t")
    out["freq"] = freq
    return out


@pytest.mark.parametrize("key, want", [("c", "want"), ("c_t", "want_t")])
def test_dgemm_compressed_matches_reference(reference_flow, key, want):
    port, ref = reference_flow["port"], reference_flow["ref"]
    assert isinstance(port[key], np.ndarray) and port[key].dtype == np.float32
    close(port[key], ref[key])
    close(port[key], reference_flow[want], REF_TOL)
    assert np.abs(port[key] - reference_flow[want]).max() < 1e-1


def test_compressed_freq_and_free(reference_flow):
    port, ref = reference_flow["port"], reference_flow["ref"]
    np.testing.assert_array_equal(port["f"], ref["f"])
    assert port["f"].dtype == np.float64
    np.testing.assert_allclose(port["f"], reference_flow["freq"], atol=1e-6)
    obj = port["obj"]
    api.free_compressed(obj)
    assert not [k for k, v in vars(obj).items()
                if isinstance(v, torch.Tensor)]
    assert obj.zq_n is None and obj.pseudo_freq is None


def test_output_buffer_filled_in_place(fileset):
    g, plink, n_snps, n_indiv = fileset
    b = np.random.default_rng(1).standard_normal((n_snps, 2))
    obj = api.plink2compressed(plink, None, n_snps, n_indiv, device=CPU)
    c_buf = np.zeros((n_indiv, 2))
    ret = api.dgemm_compressed("N", obj, 2, b, n_snps, c_buf, n_indiv)
    assert ret is c_buf
    close(c_buf, rapi_c.dgemm_compressed(
        "N", rapi_c.plink2compressed(plink, None, n_snps, n_indiv), 2, b))
    f_buf = np.zeros(n_snps)
    assert api.get_compressed_freq(obj, f_buf) is f_buf


@pytest.mark.parametrize("opts", [
    dict(do_not_center=1), dict(do_normalize=1),
    dict(do_normalize=1, do_not_center=1),
], ids=["uncentered", "normalized", "normalized-uncentered"])
@pytest.mark.parametrize("trans", ["N", "T"])
def test_latched_options_match_reference(fileset, opts, trans):
    g, plink, n_snps, n_indiv = fileset
    rng = np.random.default_rng(2)
    b = rng.standard_normal((n_snps if trans == "N" else n_indiv, 3))
    api.set_options(**opts)
    rapi_c.set_options(**opts)
    got = api.dgemm_compressed(trans, api.plink2compressed(
        plink, None, n_snps, n_indiv, device=CPU), 3, b)
    want = rapi_c.dgemm_compressed(trans, rapi_c.plink2compressed(
        plink, None, n_snps, n_indiv), 3, b)
    close(got, want)
    gm = mt.from_dense(g, device=CPU)
    oracle = ref_impl.dgemm_oracle(
        g, b, gm.freq.numpy(), trans=trans.lower(),
        center=not opts.get("do_not_center"),
        normalize=bool(opts.get("do_normalize")))
    close(got, oracle, REF_TOL)


def test_respect_missings_matches_reference(tmp_path):
    """``ignore_missings=0``: the panel keeps its missing coordinates and
    the centered product leaves them out."""
    g = bed.simulate_genotypes(70, 300, seed=5, missing_rate=0.05)
    plink = codec.dense_to_plink(g)
    b = np.random.default_rng(3).standard_normal((300, 2))
    api.set_options(ignore_missings=0)
    rapi_c.set_options(ignore_missings=0)
    obj = api.plink2compressed(plink, None, 300, 70, device=CPU)
    assert obj.miss_rows_n is not None
    got = api.dgemm_compressed("N", obj, 2, b)
    close(got, rapi_c.dgemm_compressed(
        "N", rapi_c.plink2compressed(plink, None, 300, 70), 2, b))
    close(got, rref.dgemm_oracle(g, b, obj.freq.numpy(),
                                 respect_missings=True), REF_TOL)


@pytest.mark.parametrize("centered", [False, True],
                         ids=["uncentered", "centered"])
def test_dgemm_plink_direct(fileset, centered):
    g, plink, n_snps, n_indiv = fileset
    b = np.random.default_rng(4).standard_normal((n_snps, 3))
    f = codec.allele_freq(g) if centered else None
    got = api.dgemm_plink("N", plink, None, n_snps, n_indiv, f, 3, b,
                          device=CPU)
    close(got, rapi_c.dgemm_plink("N", plink, None, n_snps, n_indiv, f, 3,
                                  b))
    close(got, ref_impl.dgemm_oracle(g, b, f, center=centered), REF_TOL)
    # the same product as dgemm_compressed under the same options
    obj = api.plink2compressed(plink, None, n_snps, n_indiv, f, device=CPU)
    if not centered:
        api.set_options(do_not_center=1)
    close(got, api.dgemm_compressed("N", obj, 3, b))


def _csr(s):
    ia = np.concatenate([[0], np.cumsum((s != 0).sum(axis=1))]) + 1
    return ia, np.nonzero(s)[1] + 1, s[s != 0]


def test_sparse_times_plink_reference_case(tmp_path):
    """tests/sparse_plink/test_sparse_plink.f90's hard-coded CSR case."""
    g = bed.simulate_genotypes(5, 40, seed=44)
    plink = codec.dense_to_plink(g)
    ia = np.array([1, 5, 8])
    ja = np.array([1, 2, 3, 5, 1, 2, 5])
    a = np.array([0.5, 0.5, -1.0, 0.0, -1.0, 0.5, -1.0])
    got = api.sparse_times_plink("N", "N", plink, None, 40, 5, 2, ia, ja, a,
                                 device=CPU)
    s_dense = np.zeros((2, 5))
    s_dense[np.repeat(np.arange(2), np.diff(ia - 1)), ja - 1] = a
    assert got.shape == (2, 40)
    np.testing.assert_allclose(got, s_dense @ g.astype(np.float64),
                               atol=1e-5)
    close(got, rapi_c.sparse_times_plink("N", "N", plink, None, 40, 5, 2,
                                         ia, ja, a))


@pytest.mark.parametrize("ts, tg", [("N", "T"), ("T", "N"), ("T", "T")])
def test_sparse_times_plink_transposed(ts, tg):
    rng = np.random.default_rng(45)
    g = bed.simulate_genotypes(30, 12, seed=45)
    plink = codec.dense_to_plink(g)
    contract = 12 if tg == "T" else 30
    s = (rng.random((3, contract)) < 0.3) * rng.standard_normal((3, contract))
    stored = s.T if ts == "T" else s
    ia, ja, a = _csr(stored)
    got = api.sparse_times_plink(ts, tg, plink, None, 12, 30, 3, ia, ja, a,
                                 device=CPU)
    z = g.astype(np.float64)
    np.testing.assert_allclose(got, s @ (z.T if tg == "T" else z), atol=1e-4)
    close(got, rapi_c.sparse_times_plink(ts, tg, plink, None, 12, 30, 3,
                                         ia, ja, a))
    c_buf = np.zeros(got.shape)
    assert api.sparse_times_plink(ts, tg, plink, None, 12, 30, 3, ia, ja, a,
                                  c_buf, device=CPU) is c_buf


def test_set_options_latches_as_reference():
    kw = dict(use_gpu=1, cores=3, floatLoop=1, meanSubstract=1,
              ignore_missings=0, do_not_center=1, do_normalize=1,
              use_miraculix_freq=1, variant=256, print_details=2)
    api.set_options(**kw)
    rapi_c.set_options(**kw)
    got = dataclasses.asdict(mt.get_global_options())
    want = dataclasses.asdict(rapi_c.get_global_options())
    assert got.pop("use_gpu") is want.pop("use_tpu") is True
    assert got == want


# -- the panel cache ----------------------------------------------------------

def _plink_panel(indiv=64, snps=96, seed=1):
    g = bed.simulate_genotypes(indiv, snps, seed=seed)
    return codec.dense_to_plink(g), g


def test_dgemm_plink_reuses_pack():
    plink, g = _plink_panel()
    b = np.random.default_rng(0).standard_normal((96, 4)).astype(np.float32)
    counts = []
    for mod, kw in ((api, dict(device=CPU)), (rapi_c, {})):
        cache = panel_cache if mod is api else rcache
        c1 = mod.dgemm_plink("n", plink, None, 96, 64, None, B=b, **kw)
        c2 = mod.dgemm_plink("n", plink, None, 96, 64, None, B=b, **kw)
        np.testing.assert_array_equal(c1, c2)
        counts.append((cache.hits, cache.misses))
    assert counts[0] == counts[1] == (1, 1)


def test_cache_distinguishes_content_and_frequencies():
    plink, g = _plink_panel(seed=1)
    plink2, _ = _plink_panel(seed=2)
    b = np.ones((96, 2), np.float32)
    f = codec.allele_freq(g)
    for p, ff in ((plink, None), (plink2, None), (plink, f), (plink, f)):
        api.dgemm_plink("n", p, None, 96, 64, ff, B=b, device=CPU)
        rapi_c.dgemm_plink("n", p, None, 96, 64, ff, B=b)
    assert (panel_cache.hits, panel_cache.misses) == (
        rcache.hits, rcache.misses) == (1, 3)


def test_cache_keeps_four_panels():
    b = np.ones((96, 1), np.float32)
    panels = [_plink_panel(seed=s)[0] for s in range(6)]
    for p in panels + panels[-4:]:
        api.dgemm_plink("n", p, None, 96, 64, None, B=b, device=CPU)
    assert (panel_cache.hits, panel_cache.misses) == (4, 6)
    assert len(panel_cache._cache) == panel_cache._MAX_ENTRIES == 4


def test_free_compressed_evicts():
    plink, g = _plink_panel()
    obj = api.plink2compressed(plink, None, 96, 64, device=CPU)
    api.free_compressed(obj)
    obj2 = api.plink2compressed(plink, None, 96, 64, device=CPU)
    assert obj2 is not obj and obj2.zq_n is not None
    assert panel_cache.misses == 2


def test_cache_key_names_the_device():
    """A panel built for one device is never served to a call for another
    (the meta device stands in for a second device here)."""
    plink, g = _plink_panel()
    cpu = api.plink2compressed(plink, None, 96, 64, device=CPU)
    other = api.plink2compressed(plink, None, 96, 64, device="meta")
    assert other is not cpu and other.device.type == "meta"
    assert cpu.device.type == "cpu"
    assert (panel_cache.hits, panel_cache.misses) == (0, 2)
    assert api.plink2compressed(plink, None, 96, 64, device=CPU) is cpu
    m = CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT, 96, 64)
    assert rapi._as_geno(m, "meta").device.type == "meta"
    assert rapi._as_geno(m, CPU).device.type == "cpu"
    assert panel_cache.misses == 4


def test_rapi_as_geno_cached():
    g = bed.simulate_genotypes(32, 48, seed=3)
    m = CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT, 48, 32)
    v = np.ones(48, np.float32)
    r1 = rapi.geno_vector(m, v, device=CPU)
    r2 = rapi.geno_vector(m, v, device=CPU)
    assert panel_cache.hits >= 1
    np.testing.assert_array_equal(r1, r2)


def test_panel_cache_module_matches_reference():
    a = np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]
    assert panel_cache.digest_array(a) == rcache.digest_array(a)
    built = []
    for k in "abcab":
        panel_cache.get_or_build(k, lambda k=k: built.append(k) or k)
    assert built == ["a", "b", "c"] and panel_cache.hits == 2
    panel_cache.evict_value("a")
    assert "a" not in panel_cache._cache


# -- the R API ----------------------------------------------------------------

@pytest.fixture(scope="module")
def coded():
    g = bed.simulate_genotypes(45, 160, seed=88)
    return (g, CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT, 160, 45),
            RCodedMatrix(rencode(g, RCoding.TWO_BIT), RCoding.TWO_BIT, 160,
                         45))


def test_create_and_fill(coded):
    g, _, _ = coded
    m = rapi.create_snp_matrix(160, 45)
    assert (m.dense() == 0).all()
    m = rapi.fill_snp_matrix(m, g)
    np.testing.assert_array_equal(m.buf, rrapi.fill_snp_matrix(
        rrapi.create_snp_matrix(160, 45), g).buf)
    with pytest.raises(ValueError, match="shape"):
        rapi.fill_snp_matrix(m, g[:3])


def test_vector012matrix(coded):
    g, m, rm = coded
    rng = np.random.default_rng(0)
    v, w = rng.standard_normal(45), rng.standard_normal(160)
    # float64 BLAS products: the port's decoded matrix is C-ordered, the
    # reference's F-ordered, so the sums run in another order
    np.testing.assert_allclose(rapi.vector012matrix(v, m),
                               rrapi.vector012matrix(v, rm), rtol=1e-12)
    np.testing.assert_allclose(rapi.matrixvector012(m, w),
                               rrapi.matrixvector012(rm, w), rtol=1e-12)
    np.testing.assert_allclose(rapi.vector012matrix(v, m),
                               v @ g.astype(np.float64), rtol=1e-12)


@pytest.mark.parametrize("centered", [False, True],
                         ids=["raw", "centered"])
def test_geno_vector_and_vector_geno(coded, centered):
    g, m, rm = coded
    rng = np.random.default_rng(1)
    v, w = rng.standard_normal((160, 2)), rng.standard_normal((45, 2))
    got = rapi.geno_vector(m, v, centered, device=CPU)
    close(got, rrapi.geno_vector(rm, v, centered))
    got_t = rapi.vector_geno(m, w, centered, device=CPU)
    close(got_t, rrapi.vector_geno(rm, w, centered))
    f = codec.allele_freq(g)
    close(got, ref_impl.dgemm_oracle(g, v, f, center=centered), REF_TOL)
    close(got_t, ref_impl.dgemm_oracle(g, w, f, trans="t", center=centered),
          REF_TOL)


def test_crossprod_int_exact(coded):
    g, m, rm = coded
    got = rapi.crossprod_int(m, device=CPU)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, rrapi.crossprod_int(rm))
    np.testing.assert_array_equal(got, g.astype(np.int64) @ g.T.astype(
        np.int64))
    c = rapi.crossprod(m, device=CPU)
    assert c.dtype == np.int32
    np.testing.assert_array_equal(c, np.asarray(rrapi.crossprod(rm)))


def test_vector_rel_matrix(coded):
    g, m, rm = coded
    v = np.random.default_rng(2).standard_normal(45)
    got = rapi.vector_rel_matrix(m, v, device=CPU)
    assert got.shape == (45, 1)
    close(got, rrapi.vector_rel_matrix(rm, v))
    z = g.astype(np.float64)
    close(got[:, 0], z @ (z.T @ v), REF_TOL)


def test_haplo_matrix_products_collapse_to_genotypes():
    h = rapi.rhaplomatrix(np.full(60, 0.5), indiv=20, seed=6)
    rh = rrapi.rhaplomatrix(np.full(60, 0.5), indiv=20, seed=6)
    v = np.random.default_rng(3).standard_normal(60)
    got = rapi.geno_vector(h, v, device=CPU)
    close(got, rrapi.geno_vector(rh, v))
    geno = (h.dense() & 1) + ((h.dense() >> 1) & 1)
    close(got[:, 0], geno.astype(np.float64) @ v, REF_TOL)


def test_substract_centered_freq_transpose(coded):
    g, m, rm = coded
    np.testing.assert_array_equal(rapi.allele_freq(m), rrapi.allele_freq(rm))
    np.testing.assert_array_equal(rapi.substract_centered(m),
                                  rrapi.substract_centered(rm))
    mt_ = rapi.transpose(m)
    np.testing.assert_array_equal(mt_.buf, rrapi.transpose(rm).buf)
    np.testing.assert_array_equal(mt_.dense(), g.T)
    np.testing.assert_array_equal(rapi.transpose(mt_).dense(), g)


def test_introspection():
    for c in Coding:
        if c is not Coding.AUTO:
            assert rapi.exists_coding(c) == rrapi.exists_coding(
                RCoding(c.value)) is True
    assert not rapi.exists_coding(Coding.AUTO)
    assert rapi.exists_crossprod(Coding.PLINK)
    assert rapi.exists_allele_freq(Coding.TWO_BIT)
    assert rapi.exists_variant(256) and not rapi.exists_variant(-1)


@pytest.mark.parametrize("rows, preferred, minimum", [
    (1024, 512, 8), (1000, 512, 16), (1003, 512, 8), (301, 128, 8),
    (7, 512, 8), (4096, 4, 8), (1024, 8, 16)])
def test_exists_tiling_answers_for_the_port(rows, preferred, minimum):
    """The port's kernels pad any row count (rows to 256, words to 128), so
    every row count tiles, where the reference's TPU tiles need a
    power-of-two divisor (``exists_tiling(1000, minimum=16)`` is False
    there); a requested tile below the minimum is refused by both."""
    got = rapi.exists_tiling(rows, preferred, minimum)
    assert got is (preferred >= minimum)
    if preferred < minimum or rows % preferred == 0:
        assert got is rrapi.exists_tiling(rows, preferred, minimum)


def test_rapi_options_debug_centered(monkeypatch):
    monkeypatch.delenv("MIRACULIX_TPU_PRINT_LEVEL", raising=False)
    mt.set_global_options(Options(normalize=True))
    snap = rapi.copy_options()
    assert snap.normalize is True
    snap.normalize = False
    assert rapi.copy_options().normalize is True
    rapi.debug()
    assert os.environ["MIRACULIX_TPU_PRINT_LEVEL"] == "3"
    assert mlog.print_level() == 3
    rapi.stop_debug()
    assert mlog.print_level() == 0
    assert rapi.get_centered() is None
    rapi.set_centered(np.arange(4.0))
    np.testing.assert_array_equal(rapi.get_centered(), np.arange(4.0))
    rapi.set_centered(None)
    assert rapi.get_centered() is None


def test_rapi_aliases_and_origins():
    assert rapi.Transform is rapi._transform and rapi.compute is \
        mobps.compute_relationship
    assert rapi.solveRelMat is mt.solve_relmat
    m = np.array([[2, 1, 5, 1], [1, 2, 3, 2]])
    codes = rapi.codeOrigins(m)
    np.testing.assert_array_equal(codes, rrapi.codeOrigins(m))
    np.testing.assert_array_equal(rapi.decodeOrigins(codes), m)


# -- MoBPS --------------------------------------------------------------------

def test_code_origins_roundtrip():
    rng = np.random.default_rng(42)
    m = np.stack([rng.integers(1, 64, 50), rng.integers(1, 3, 50),
                  rng.integers(1, 1 << 22, 50), rng.integers(1, 9, 50)],
                 axis=1)
    codes = mobps.code_origins(m)
    np.testing.assert_array_equal(codes, rmobps.code_origins(m))
    assert codes.dtype == np.uint32
    np.testing.assert_array_equal(mobps.decode_origins(codes), m)


@pytest.mark.parametrize("row", [[0, 1, 1, 1], [1, 3, 1, 1], [65, 1, 1, 1],
                                 [1, 1, 1 << 22 + 1, 1], [1, 1, 1, 9]])
def test_code_origins_bounds(row):
    with pytest.raises(ValueError):
        mobps.code_origins(np.array([row]))


def _population(mod, snps=20):
    rng = np.random.default_rng(5)
    founders = {}
    for nr in (1, 2):
        for sex in (1, 2):
            founders[(1, sex, nr)] = mod.Individual(
                haplo=rng.integers(0, 2, (2, snps)).astype(np.uint8))
    child = mod.Individual(
        recombi=([0.0, 8.0, snps * 1.0], [0.0, snps * 1.0]),
        origins=(mod.code_origins(np.array([[1, 1, 1, 1], [1, 1, 1, 2]])),
                 mod.code_origins(np.array([[1, 2, 1, 2]]))),
        mutations=((), (3,)))
    grandchild = mod.Individual(
        recombi=([0.0, 5.0, 12.0, snps * 1.0], [0.0, snps * 1.0]),
        origins=(mod.code_origins(np.array([[2, 1, 1, 1], [1, 2, 2, 1],
                                            [2, 1, 1, 2]])),
                 mod.code_origins(np.array([[1, 1, 2, 2]]))),
        mutations=((0, 19), ()))
    return mod.Population(snps=snps, individuals={
        **founders, (2, 1, 1): child, (3, 2, 1): grandchild}), founders


SELECTION = ([1, 1, 2, 3, 1], [1, 2, 1, 2, 1], [1, 1, 1, 1, 2])


@pytest.mark.parametrize("window", [(0, None), (5, 15)],
                         ids=["whole", "window"])
def test_compute_snps_equal_reference(window):
    pop, _ = _population(mobps)
    rpop, _ = _population(rmobps)
    got = mobps.compute_snps(pop, *SELECTION, from_snp=window[0],
                             to_snp=window[1])
    np.testing.assert_array_equal(got, rmobps.compute_snps(
        rpop, *SELECTION, from_snp=window[0], to_snp=window[1]))
    assert got.dtype == np.uint8


def test_compute_snps_recombination_and_mutation():
    pop, founders = _population(mobps)
    g = mobps.compute_snps(pop, [2], [1], [1])[0]
    dad, mom = founders[(1, 1, 1)].haplo, founders[(1, 2, 1)].haplo
    hap1 = mom[1].copy()
    hap1[3] ^= 1
    np.testing.assert_array_equal(
        g, np.concatenate([dad[0][:8], dad[1][8:]]) + hap1)


def test_population_errors():
    pop, _ = _population(mobps)
    with pytest.raises(KeyError, match="no individual"):
        mobps.compute_snps(pop, [9], [1], [1])
    bad = mobps.Individual(recombi=([0.0, 20.0], [0.0, 20.0]),
                           origins=((), ()))
    pop.individuals[(4, 1, 1)] = bad
    with pytest.raises(ValueError, match="recombi"):
        mobps.compute_snps(pop, [4], [1], [1])


@pytest.mark.parametrize("scale", [True, False], ids=["scaled", "raw"])
def test_compute_relationship_matches_reference(scale):
    pop, _ = _population(mobps, snps=300)
    rpop, _ = _population(rmobps, snps=300)
    got = mobps.compute_relationship(pop, *SELECTION, scale=scale,
                                     device=CPU)
    assert got.device.type == "cpu" and got.shape == (5, 5)
    got = got.numpy()
    close(got, np.asarray(rmobps.compute_relationship(rpop, *SELECTION,
                                                      scale=scale)))
    geno = mobps.compute_snps(pop, *SELECTION)
    close(got, rref.grm_oracle(geno, codec.allele_freq(geno), scale=scale),
          REF_TOL)
    assert np.allclose(got, got.T)


# -- Options, the oracles, logging ---------------------------------------------

def test_options_fields_and_defaults():
    got = {f.name: f.default for f in dataclasses.fields(Options)}
    want = {f.name: f.default for f in dataclasses.fields(ROptions)}
    assert got.pop("use_gpu") is want.pop("use_tpu") is True
    assert got == want
    assert list(dataclasses.asdict(Options())) == [
        "use_gpu" if k == "use_tpu" else k
        for k in dataclasses.asdict(ROptions())]
    assert Options(cores=5).resolve_cores() == 5


def test_resolve_cores_from_environment(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert Options().resolve_cores() == ROptions().resolve_cores() == 3
    monkeypatch.delenv("OMP_NUM_THREADS")
    assert Options().resolve_cores() == ROptions().resolve_cores()


def test_global_options_latch():
    o = Options(precision="f32")
    mt.set_global_options(o)
    assert mt.get_global_options() is o
    import miraculix_tpu as mx
    assert set(mx.__all__) <= set(mt.__all__)


@pytest.mark.parametrize("case", [
    "dgemm n", "dgemm t", "dgemm colmeans", "dgemm user", "dgemm none",
    "dgemm normalize n", "dgemm normalize t", "dgemm missings",
    "freq 0", "freq 1", "crossprod", "crossprod snp", "grm", "grm raw",
    "ld"])
def test_ref_impl_equals_reference(case):
    rng = np.random.default_rng(7)
    g = bed.simulate_genotypes(30, 50, seed=7, missing_rate=0.05)
    f = codec.allele_freq(g)
    b = rng.standard_normal((50, 3))
    bt = rng.standard_normal((30, 3))
    u = rng.standard_normal(50)
    calls = {
        "dgemm n": ("dgemm_oracle", (g, b, f)),
        "dgemm t": ("dgemm_oracle", (g, bt, f, "t")),
        "dgemm colmeans": ("dgemm_oracle", (g, b, f), dict(center="colmeans")),
        "dgemm user": ("dgemm_oracle", (g, b, f), dict(center=u)),
        "dgemm none": ("dgemm_oracle", (g, b, f), dict(center=False)),
        "dgemm normalize n": ("dgemm_oracle", (g, b, f), dict(normalize=True)),
        "dgemm normalize t": ("dgemm_oracle", (g, bt, f, "t"),
                              dict(normalize=True)),
        "dgemm missings": ("dgemm_oracle", (g, b, f),
                           dict(respect_missings=True)),
        "freq 0": ("allele_freq_oracle", (g, 0)),
        "freq 1": ("allele_freq_oracle", (g, 1)),
        "crossprod": ("crossprod_oracle", (g,)),
        "crossprod snp": ("crossprod_oracle", (g, True)),
        "grm": ("grm_oracle", (g, f)),
        "grm raw": ("grm_oracle", (g, f, False)),
        "ld": ("ld_oracle", (g, f)),
    }[case]
    name, args, kw = (calls + ({},))[:3]
    got = getattr(ref_impl, name)(*args, **kw)
    np.testing.assert_array_equal(got, getattr(rref, name)(*args, **kw))


def test_phase_timer_totals(monkeypatch):
    ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 3.0])
    monkeypatch.setattr(mlog.time, "time", lambda: next(ticks))
    t = mlog.PhaseTimer(verbose=False)
    for name in ("pack", "dgemm", "pack"):
        with t.phase(name):
            pass
    assert t.totals() == {"pack": 1.5, "dgemm": 0.25}
    assert t.phases == [("pack", 0.5), ("dgemm", 0.25), ("pack", 1.0)]
    rep = t.report().splitlines()
    assert len(rep) == 2 and "1500.00 ms" in rep[0]


def test_logging_levels_and_banner(monkeypatch, capsys):
    monkeypatch.setenv("MIRACULIX_TPU_PRINT_LEVEL", "x")
    assert mlog.print_level() == 0
    monkeypatch.delenv("MIRACULIX_TPU_PRINT_LEVEL")
    monkeypatch.setenv("PRINT_LEVEL", "2")
    assert mlog.print_level() == 2
    assert mlog.PhaseTimer().verbose is True
    mlog.debug_info("hello", level=2)
    mlog.debug_info("hidden", level=3)
    err = capsys.readouterr().err
    assert "hello" in err and "hidden" not in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mlog.print_compile_info()
    err = capsys.readouterr().err
    assert f"torch {torch.__version__}" in err and "no CUDA device" in err
    assert mt.__version__ in err


def test_check_device_memory_on_the_cpu(monkeypatch):
    assert mlog.check_device_memory(1 << 60, device=CPU) is True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlog.check_device_memory(1)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with mlog.device_trace(d):
        torch.ones(4) @ torch.ones(4)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0


# -- public signatures ----------------------------------------------------------

MODULES = ["options", "utils.panel_cache", "utils.logging", "ops.ref_impl",
           "formats.codings", "formats.transform", "formats.haplo",
           "io.vcf", "io.grm_io", "qc", "mobps", "api", "rapi"]
# the intended differences (ROADMAP.md queue C): ``device=`` added,
# keyword-only and last, where a function builds a panel or returns a
# device result; device_trace's directory defaults to the temporary
# directory; Options.use_tpu is use_gpu (checked above); exists_tiling
# answers for the port's kernels (checked above)
DEFAULT_DIFFERS = {("utils.logging", "device_trace", "dirname")}
RENAMED = {("options", "Options", "use_tpu"): "use_gpu"}


def _default(p):
    d = p.default
    return d.value if isinstance(d, enum.Enum) else d


@pytest.mark.parametrize("name", MODULES)
def test_public_signatures_match_reference(name):
    ref = importlib.import_module(f"miraculix_tpu.{name}")
    port = importlib.import_module(f"miraculix_tpu_torch.{name}")
    public = [n for n, f in vars(ref).items() if not n.startswith("_")
              and (inspect.isfunction(f) or inspect.isclass(f))
              and getattr(f, "__module__", None) == ref.__name__]
    assert public, name
    for fn in public:
        assert hasattr(port, fn), f"{name}.{fn}"
        want = {RENAMED.get((name, fn, p), p): v for p, v in
                inspect.signature(getattr(ref, fn)).parameters.items()}
        got = inspect.signature(getattr(port, fn)).parameters
        assert list(got)[: len(want)] == list(want), f"{name}.{fn}"
        for p in want:
            if (name, fn, p) in DEFAULT_DIFFERS:
                continue
            assert got[p].kind == want[p].kind, f"{name}.{fn}({p})"
            assert _default(got[p]) == _default(want[p]), f"{name}.{fn}({p})"
        extra = list(got)[len(want):]
        assert extra in ([], ["device"]), f"{name}.{fn}: {extra}"
        assert all(got[p].kind == got[p].KEYWORD_ONLY and got[p].default
                   is None for p in extra), f"{name}.{fn}"
    aliases = [n for n, v in vars(ref).items() if not n.startswith("_")
               and callable(v) and getattr(v, "__module__", "").startswith(
                   "miraculix_tpu.") and n not in public]
    assert all(hasattr(port, n) for n in aliases), name
