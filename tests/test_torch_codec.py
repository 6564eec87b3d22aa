"""The port's host layer against miraculix_tpu: codec, .bed I/O, GenoMatrix.

Same panels through both packages must give the same planar16 words (bit
for bit), the same freq / pseudo_freq, the same missing lists and the same
simulated draws; checkpoints written by one load in the other.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu as mx  # noqa: E402
from miraculix_tpu.io import bed as ref_bed  # noqa: E402
from miraculix_tpu.io import codec as ref_codec  # noqa: E402
from miraculix_tpu.ops import common as ref_common  # noqa: E402

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch.io import bed as pt_bed  # noqa: E402
from miraculix_tpu_torch.io import codec as pt_codec  # noqa: E402
from miraculix_tpu_torch.ops import common as pt_common  # noqa: E402

CPU = "cpu"  # the port's panels are built on the CPU in these tests


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host (several test workers
    each starting one thread per core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("zq_n", "zq_t", "freq", "pseudo_freq", "miss_rows_n", "miss_cols_n")


def ref_state(gm):
    """The reference GenoMatrix's fields as numpy arrays."""
    d = {k: None if getattr(gm, k) is None else np.asarray(getattr(gm, k))
         for k in FIELDS}
    return dict(d, snps=gm.snps, indiv=gm.indiv)


def assert_same_container(ref, port):
    assert (port.snps, port.indiv) == (ref.snps, ref.indiv)
    for k in ("zq_n", "zq_t"):
        want = np.asarray(getattr(ref, k)).view(np.uint32)
        got = getattr(port, k).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.freq.numpy(),
                                  np.asarray(ref.freq, np.float32))
    np.testing.assert_array_equal(port.pseudo_freq.numpy(),
                                  np.asarray(ref.pseudo_freq, np.float32))
    if ref.miss_rows_n is None:
        assert port.miss_rows_n is None
    else:
        np.testing.assert_array_equal(port.miss_rows_n.numpy(),
                                      np.asarray(ref.miss_rows_n))
        np.testing.assert_array_equal(port.miss_cols_n.numpy(),
                                      np.asarray(ref.miss_cols_n))


@pytest.mark.parametrize("name", ["golden_panel", "golden_panel_missing"])
def test_from_bed_matches_reference(name):
    path = os.path.join(DATA, name + ".bed")
    assert_same_container(mx.from_bed(path), mt.from_bed(path, device=CPU))


@pytest.mark.parametrize("indiv,snps,missing_rate", [
    (37, 100, 0.0), (300, 1000, 0.0), (61, 2049, 0.05), (256, 33, 0.2)])
def test_from_dense_matches_reference(indiv, snps, missing_rate):
    g = ref_bed.simulate_genotypes(indiv, snps, seed=indiv + snps,
                                   missing_rate=missing_rate)
    assert_same_container(mx.from_dense(g, keep_missing_info=True),
                          mt.from_dense(g, keep_missing_info=True, device=CPU))
    assert_same_container(mx.from_dense(g), mt.from_dense(g, device=CPU))


@pytest.mark.parametrize("missing_rate", [0.0, 0.1])
def test_simulate_and_bed_roundtrip(tmp_path, missing_rate):
    g = pt_bed.simulate_genotypes(45, 130, seed=5, missing_rate=missing_rate)
    np.testing.assert_array_equal(
        g, ref_bed.simulate_genotypes(45, 130, seed=5,
                                      missing_rate=missing_rate))
    path = str(tmp_path / "p.bed")
    pt_bed.write_bed(path, g)
    geno, freq = ref_bed.read_bed_genotypes(path)
    np.testing.assert_array_equal(geno, g)
    pgeno, pfreq = pt_bed.read_bed_genotypes(path)
    np.testing.assert_array_equal(pgeno, g)
    np.testing.assert_array_equal(pfreq, freq)
    plink, n_snps, n_indiv = pt_bed.read_bed(path)
    rplink, _, _ = ref_bed.read_bed(path)
    np.testing.assert_array_equal(plink, rplink)
    assert_same_container(mx.from_plink(rplink, n_snps, n_indiv),
                          mt.from_plink(plink, n_snps, n_indiv, device=CPU))


def test_codec_functions_match_reference():
    g = ref_bed.simulate_genotypes(29, 77, seed=1, missing_rate=0.1)
    for axis in (0, 1):
        np.testing.assert_array_equal(pt_codec.allele_freq(g, axis),
                                      ref_codec.allele_freq(g, axis))
    for a, b in zip(pt_codec.missing_positions(g),
                    ref_codec.missing_positions(g)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt_codec.dense_to_plink(g),
                                  ref_codec.dense_to_plink(g))
    plink = ref_codec.dense_to_plink(g)
    np.testing.assert_array_equal(pt_codec.plink_to_dense(plink, 29), g)
    for zero_missing in (True, False):
        w = pt_codec.pack_planar16(g, zero_missing=zero_missing)
        np.testing.assert_array_equal(
            w, ref_codec.pack_planar16(g, zero_missing=zero_missing))
        np.testing.assert_array_equal(
            pt_codec.unpack_planar16(w, 29, 77),
            ref_codec.unpack_planar16(w, 29, 77))
    np.testing.assert_array_equal(   # a transposed view packs as it stands
        pt_codec.pack_planar16(g.T, row_mult=256),
        ref_codec.pack_planar16(np.ascontiguousarray(g.T), row_mult=256))
    assert pt_codec.planar16_dims(29, 77, row_mult=256) == \
        ref_codec.planar16_dims(29, 77, row_mult=256)


def test_common_helpers_match_reference():
    gm = mx.from_dense(ref_bed.simulate_genotypes(50, 700, seed=2))
    zq = np.array(gm.zq_n)
    zt = torch.from_numpy(zq.view(np.int32))
    np.testing.assert_array_equal(
        pt_common.packed_row_sq_stats(zt).numpy(),
        np.asarray(ref_common.packed_row_sq_stats(gm.zq_n)))
    np.testing.assert_array_equal(
        pt_common.packed_indicator2(zt).numpy().view(np.uint32),
        np.asarray(ref_common.packed_indicator2(gm.zq_n)).view(np.uint32))
    np.testing.assert_array_equal(
        pt_common.decode_planar16(zt, torch.int32).numpy(),
        ref_codec.unpack_planar16(zq, zq.shape[0], 16 * zq.shape[1]))


def _popc(w: np.ndarray) -> np.ndarray:
    return np.unpackbits(w[..., None].view(np.uint8), axis=-1).sum(
        axis=-1, dtype=np.int64)


@pytest.mark.parametrize("rows,kw", [(1, 1), (31, 3), (33, 5), (7, 351),
                                     (5, 1408), (2, 4099)])
@pytest.mark.parametrize("words", ["genotypes", "any", "all_two",
                                   "all_three"])
def test_row_sq_stats_word_arithmetic_matches_plane_loop(rows, kw, words):
    """csrc/row_sq_stats.cu's per-word sum popc(lo ^ hi) + 3 popc(hi), on
    uint32 words (an unsigned shift), equals the 16-plane loop on the int32
    view: negative words, the code 3 and the largest sums included."""
    rng = np.random.default_rng(rows * kw)
    w = rng.integers(0, 2 ** 32, size=(rows, kw), dtype=np.uint64)
    w = w.astype(np.uint32)
    if words == "genotypes":   # clear the high bit of every 11 field
        w &= ~(((w & (w >> np.uint32(1))) & np.uint32(0x55555555))
               << np.uint32(1))
    elif words != "any":
        w[:] = {"all_two": 0xAAAAAAAA, "all_three": 0xFFFFFFFF}[words]
    low = np.uint32(0x55555555)
    hi = (w >> np.uint32(1)) & low
    kernel = (_popc((w & low) ^ hi) + 3 * _popc(hi)).sum(axis=1)
    zt = torch.from_numpy(w.view(np.int32))
    plain = pt_common.packed_row_sq_stats_plain(zt)
    np.testing.assert_array_equal(kernel.astype(np.float32), plain.numpy())
    np.testing.assert_array_equal(pt_common.packed_row_sq_stats(zt).numpy(),
                                  plain.numpy())


@pytest.mark.parametrize("tracked", [False, True])
def test_checkpoints_cross_load(tmp_path, tracked):
    g = ref_bed.simulate_genotypes(40, 300, seed=4, missing_rate=0.05)
    ref = mx.from_dense(g, keep_missing_info=tracked)
    p_ref = str(tmp_path / "ref.npz")
    mx.save(p_ref, ref)
    assert_same_container(ref, mt.load(p_ref, device=CPU))
    p_port = str(tmp_path / "port.npz")
    mt.save(p_port, mt.from_dense(g, keep_missing_info=tracked, device=CPU))
    assert_same_container(mx.load(p_port), mt.load(p_port, device=CPU))
    assert_same_container(ref, mt.from_reference_state(ref_state(ref),
                                                       device=CPU))


def test_freq_cache_family_matches_reference():
    g = ref_bed.simulate_genotypes(90, 500, seed=6)
    ref, port = mx.from_dense(g), mt.from_dense(g, device=CPU)
    for name in ("snp_sums", "indiv_sums", "freq_sxi", "pseudo_freq_sxi",
                 "total_sum"):
        want = np.asarray(getattr(ref, name)(), np.float64)
        got = getattr(port, name)().numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    for name in ("sigma2", "pseudo_sigma2"):
        np.testing.assert_allclose(float(getattr(port, name)),
                                   float(getattr(ref, name)), rtol=1e-6)


def test_port_imports_without_jax():
    """The port (its user surface too), its native codec and chip_smoke.py
    load nothing of jax or of the JAX package, and no import statement in
    them names one (the smoke imports the port inside its functions); the
    codec library is built from the port's own source into the port's
    git-ignored build directory."""
    import ast
    from pathlib import Path

    sources = [Path(REPO, "chip_smoke.py")] + sorted(
        Path(REPO, "miraculix_tpu_torch").rglob("*.py"))
    for src in sources:
        for node in ast.walk(ast.parse(src.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in (
                "jax", "miraculix_tpu")], (src, names)
    code = ("import sys, chip_smoke, miraculix_tpu_torch, "
            "miraculix_tpu_torch.gblup, "
            "miraculix_tpu_torch.io.bed, miraculix_tpu_torch.io.codec, "
            "miraculix_tpu_torch.io.native, miraculix_tpu_torch.ops.grm, "
            "miraculix_tpu_torch._kernels, miraculix_tpu_torch.api, "
            "miraculix_tpu_torch.rapi, miraculix_tpu_torch.options, "
            "miraculix_tpu_torch.formats, miraculix_tpu_torch.qc, "
            "miraculix_tpu_torch.mobps, miraculix_tpu_torch.io.vcf, "
            "miraculix_tpu_torch.io.grm_io, miraculix_tpu_torch.ops.ref_impl, "
            "miraculix_tpu_torch.utils.logging, "
            "miraculix_tpu_torch.utils.panel_cache; "
            "from pathlib import Path; "
            "from miraculix_tpu_torch.io import native; "
            "lib = Path(native.get_lib()._name).resolve(); "
            "build = Path(miraculix_tpu_torch.__file__).parent / '_build'; "
            "assert lib.is_relative_to(build.resolve()), lib; "
            "assert native.codec_version() is not None; "
            "bad = [m for m in sys.modules "
            "if m in ('jax', 'miraculix_tpu') "
            "or m.startswith(('jax.', 'miraculix_tpu.'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


FACADES = ["api.plink2compressed", "api.dgemm_plink",
           "api.sparse_times_plink", "rapi.geno_vector", "rapi.vector_geno",
           "rapi.crossprod", "rapi.crossprod_int", "rapi.vector_rel_matrix",
           "mobps.compute_relationship"]
# the benchmark suite's cells at toy sizes ("toy" added to its PANELS)
BENCH_CELLS = {
    "benchmark.bench_dgemm": ("toy", 8, 2),
    "benchmark.bench_dgemm_exact": ("toy", 4, 1),
    "benchmark.bench_solve_refined": ("toy", 1),
    "benchmark.bench_gwas": ("toy", 1),
    "benchmark.bench_grm": ("toy", 2),
    "benchmark.bench_grm_ref_panel": (2,),
    "benchmark.bench_ld": ("toy", 2),
    "benchmark.bench_sparse_solve": (300, 9, 2, 2),
    "benchmark.bench_ssgblup": (300, 64, 512, 1),
    "benchmark.bench_gblup_fullscale": (1024, 256, 2),
    "benchmark.bench_scaling": (1, 512, 256, 2),
    "benchmark.bench_ld_banded": (1024, 64, 32, 1),
}


@pytest.mark.parametrize("entry", ["from_dense", "from_bed", "from_plink",
                                   "load", "from_reference_state"] + FACADES
                         + list(BENCH_CELLS))
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, entry):
    """With no device named, a panel goes to the CUDA card; where there is
    none that raises, and nothing falls back to the CPU.  The C API, the R
    API and the MoBPS bridge build their panels the same way, and each
    benchmark cell resolves its device before it simulates anything."""
    from miraculix_tpu_torch import api, benchmark, mobps, rapi
    from miraculix_tpu_torch.formats import Coding, CodedMatrix, encode
    from miraculix_tpu_torch.utils import panel_cache

    g = ref_bed.simulate_genotypes(12, 40, seed=3)
    path = str(tmp_path / "p.bed")
    pt_bed.write_bed(path, g)
    npz = str(tmp_path / "p.npz")
    mt.save(npz, mt.from_dense(g, device=CPU))
    plink, n_snps, n_indiv = pt_bed.read_bed(path)
    m = CodedMatrix(encode(g, Coding.TWO_BIT), Coding.TWO_BIT, 40, 12)
    pop = mobps.Population(snps=40, individuals={
        (1, 1, n): mobps.Individual(haplo=np.stack([g[n] & 1, g[n] >> 1]))
        for n in range(1, 4)})
    args = {"from_dense": (g,), "from_bed": (path,),
            "from_plink": (plink, n_snps, n_indiv), "load": (npz,),
            "from_reference_state": (ref_state(mx.from_dense(g)),),
            "api.plink2compressed": (plink, None, 40, 12),
            "api.dgemm_plink": ("N", plink, None, 40, 12, None, 1,
                                np.ones((40, 1))),
            "api.sparse_times_plink": ("N", "N", plink, None, 40, 12, 1,
                                       np.array([1, 2]), np.array([1]),
                                       np.array([1.0])),
            "rapi.geno_vector": (m, np.ones(40)),
            "rapi.vector_geno": (m, np.ones(12)),
            "rapi.crossprod": (m,), "rapi.crossprod_int": (m,),
            "rapi.vector_rel_matrix": (m, np.ones(12)),
            "mobps.compute_relationship": (pop, [1, 1], [1, 1], [1, 2]),
            **BENCH_CELLS}[entry]
    mod, _, name = entry.rpartition(".")
    fn = getattr({"": mt, "api": api, "rapi": rapi, "mobps": mobps,
                  "benchmark": benchmark}[mod], name)
    monkeypatch.setitem(benchmark.PANELS, "toy", dict(snps=1024, indiv=256))
    monkeypatch.setattr(benchmark, "REF_PANEL",
                        dict(rows=200, rows_pad=256, kw=128, chunk=64))
    panel_cache.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)
    out = fn(*args, device=CPU)
    panel_cache.clear()
    if mod == "benchmark":   # a row of the suite, timed on the CPU
        assert out["suite"] in name and json.dumps(out)
    else:
        assert isinstance(out, np.ndarray) or out.device.type == "cpu"
