"""The port's benchmark suite (``miraculix_tpu_torch.benchmark``) against
miraculix_tpu's on the CPU.

The reference's suite CLI tests are kept as cases here, run on the port's
module (routing with stubs, the LD skip row, the sparse and full-scale
cells at toy sizes).  Each cell that the reference's CPU backend runs is
run by both modules on the same toy panel ("toy", 2,048 SNPs x 256
animals, added to both ``PANELS``) and the rows are held together: the
same keys, the same ``suite``/``panel``/``config`` strings, iteration
counts within 1-2 and residuals under the reference's limits.  The
reference's ``grm`` and ``ld`` cells call their kernels outside interpret
mode, which its CPU backend refuses, so the port's rows are held to the
keys and ``config`` formats written in the reference's code.  The
full-scale cell's word generator is held bit for bit to a numpy uint32
transcription of the reference's, the timer's interleaved median to the
reference's on a fake clock, and the card's peaks to their table.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import miraculix_tpu.benchmark as ref  # noqa: E402

import miraculix_tpu_torch.benchmark as bm  # noqa: E402

CPU = "cpu"
TOY = dict(snps=2048, indiv=256)
TINY = dict(snps=512, indiv=256)     # the rows held to key sets only

# name -> the cell's call at a toy size, the same arguments in both modules
CELLS = {
    "dgemm": lambda m, **kw: m.bench_dgemm("toy", 32, 8, True, **kw),
    "dgemm_exact": lambda m, **kw: m.bench_dgemm_exact("toy", 8, 2, **kw),
    "solve_refined": lambda m, **kw: m.bench_solve_refined("toy", 1, **kw),
    "gwas": lambda m, **kw: m.bench_gwas("toy", 1, **kw),
    "ssgblup": lambda m, **kw: m.bench_ssgblup(2000, 256, 2048, 1, **kw),
    "ld_banded": lambda m, **kw: m.bench_ld_banded(4096, 128, 64, 1, **kw),
    "scaling": lambda m, **kw: m.bench_scaling(2, 1024, 256, 8, **kw),
    "sparse_solve": lambda m, **kw: m.bench_sparse_solve(n=300, **kw),
    "gblup_fullscale": lambda m, **kw: m.bench_gblup_fullscale(
        snps=4096, indiv=256, chunks=2, **kw),
}
# within these of the reference's counts (the CG tolerances are met by
# f32 sums in another order)
ITERATIONS = {"outer_iters": 0, "inner_iters": 2, "outer_cg_iterations": 2,
              "cg_iterations": 1}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The panels are small: one torch thread runs their many small ops
    without the thread contention of a loaded host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy_panel():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref.PANELS, "toy", TOY)
        mp.setitem(bm.PANELS, "toy", TOY)
        mp.setitem(bm.PANELS, "tiny", TINY)
        yield


@pytest.fixture(scope="module")
def rows(toy_panel):
    """name -> (reference row, port row), each cell run once a module."""
    made = {}

    def get(name):
        if name not in made:
            made[name] = (CELLS[name](ref), CELLS[name](bm, device=CPU))
        return made[name]
    return get


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_row_matches_reference(rows, name):
    want, got = rows(name)
    assert set(got) == set(want)
    for key in ("suite", "panel", "config", "devices"):
        assert got.get(key) == want.get(key), key
    for key, slack in ITERATIONS.items():
        if key in want:
            assert abs(got[key] - want[key]) <= slack, (key, got, want)
    json.dumps(got)   # plain Python numbers only
    if name == "solve_refined":
        assert want["outer_iters"] == 3 and got["outer_iters"] == 3
        assert got["true_f64_rel_residual"] <= 1e-10
    elif name == "sparse_solve":   # nnz is in the config
        assert got["rel_residual"] < 1e-4
        assert got["f64_grade_rel_residual"] <= 1e-12
    elif name == "gblup_fullscale":
        assert got["converged"] and got["cg_iterations"] > 0
    elif name == "ssgblup":
        assert got["outer_cg_iterations"] < 500
    elif name == "dgemm":
        # no card: no peak, so no share and no roofline flag
        assert got["mxu_utilization"] is None
        assert got["hbm_utilization"] is None
        assert "roofline_warning" not in got
        assert got["comparator_dense_xla_s"] > 0


GRM_KEYS = {"suite", "panel", "config", "seconds_per_call",
            "snp_indiv2_ops_per_s", "mxu_utilization_triangle", "spread_pct",
            "n_pairs"}
CMP_KEYS = {"comparator_dense_xla_s", "speedup_vs_dense"}


@pytest.mark.parametrize("comparator", [False, True])
def test_grm_row_keys_and_config(toy_panel, comparator):
    """benchmark.py:345-385: the reference's grm row."""
    row = bm.bench_grm("tiny", 2, comparator, device=CPU)
    want = GRM_KEYS | {"snps_per_s"} | (CMP_KEYS if comparator else set())
    assert set(row) == want
    assert (row["suite"], row["panel"], row["config"]) == (
        "grm", "tiny", "512x256 ZZ^T int8")
    assert row["mxu_utilization_triangle"] is None
    json.dumps(row)


def test_ld_row_keys_and_config(toy_panel):
    """benchmark.py:511-517: the reference's ld row."""
    row = bm.bench_ld("tiny", 2, device=CPU)
    assert set(row) == {"suite", "panel", "config", "seconds_per_call",
                        "snp_pairs_per_s"}
    assert (row["suite"], row["panel"], row["config"]) == (
        "ld", "tiny", "512x256 LD r (centered, normalized)")
    assert row["seconds_per_call"] > 0


def test_ref_panel_row_and_words(monkeypatch):
    """benchmark.py:452-462 at a toy ref panel: the reference's keys and
    config; the words are the hashed chunks side by side over zero
    padding, every field a genotype."""
    monkeypatch.setattr(bm, "REF_PANEL",
                        dict(rows=200, rows_pad=256, kw=256, chunk=128))
    row = bm.bench_grm_ref_panel(2, device=CPU)
    assert set(row) == GRM_KEYS
    assert (row["suite"], row["panel"], row["config"]) == (
        "grm", "ref_many_snps", "4096x200 ZZ^T int8 (padded 256), "
        "single-call K grid, on-device gen")
    zq = bm.ref_panel_words(CPU).numpy()
    assert zq.shape == (256, 256) and not zq[200:].any()
    for c in (0, 1):
        np.testing.assert_array_equal(zq[:200, 128 * c:128 * (c + 1)],
                                      numpy_chunk(c, 200, 128))
    planes = np.stack([(zq >> (2 * m)) & 3 for m in range(16)])
    assert planes.max() == 2 and np.isin(planes, (0, 1, 2)).all()


def numpy_hash(x):
    """benchmark.py:674-678 in numpy uint32 (wrapping products)."""
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def numpy_chunk(c, indiv, kw_chunk):
    """benchmark.py:680-692, ``gen_chunk(c)``, in numpy uint32."""
    with np.errstate(over="ignore"):
        salt = numpy_hash(np.uint32(c) * np.uint32(0x9E3779B9)
                          + np.uint32(1))
        idx = (np.arange(indiv, dtype=np.uint32)[:, None]
               * np.uint32(kw_chunk)
               + np.arange(kw_chunk, dtype=np.uint32)[None, :])
        r = numpy_hash(idx ^ salt)
    a = r & np.uint32(0x55555555)
    b = (r >> np.uint32(1)) & np.uint32(0x55555555)
    return (((b & ~a) << np.uint32(1)) | (a & ~b)).view(np.int32)


@pytest.mark.parametrize("c", [0, 1, 15])
def test_hash_chunk_words_bit_equal_to_reference(c):
    got = bm.hash_chunk_words(c, 256, 128, CPU)
    assert got.dtype == torch.int32 and got.shape == (256, 128)
    np.testing.assert_array_equal(got.numpy(), numpy_chunk(c, 256, 128))


def test_hash_chunk_words_refuses_an_overrunning_counter():
    with pytest.raises(ValueError, match="int32 counter"):
        bm.hash_chunk_words(0, 2 ** 20, 2 ** 12, CPU)


class FakeClock:
    """A clock that moves only when a timed run says so."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def runs(self, seconds):
        it = iter(seconds)

        def run():
            self.now += next(it)
        return run


@pytest.mark.parametrize("full,base", [
    ([9.0, 9.5, 8.8, 10.0, 9.2], [1.0, 1.2, 0.9, 1.5, 1.1]),
    ([1.0, 1.1, 0.9, 1.0, 1.2], [1.5, 1.4, 1.6, 1.3, 1.5]),  # per <= 0
])
def test_interleaved_per_iter_matches_reference_on_a_fake_clock(
        monkeypatch, full, base):
    clock = FakeClock()
    monkeypatch.setattr(time, "time", clock)
    monkeypatch.setattr(time, "perf_counter", clock)
    stats_ref, stats_port = {}, {}
    want = ref._interleaved_per_iter(clock.runs(base), clock.runs(full), 8,
                                     stats=stats_ref)
    got = bm._interleaved_per_iter(clock.runs(base), clock.runs(full), 8,
                                   stats=stats_port)
    assert got == pytest.approx(want, rel=1e-12) and got > 0
    assert stats_port == stats_ref
    assert (stats_port["spread_pct"] is None) == (full[0] < base[0])


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989e12, 1979e12, 3.35e12)),
    ("NVIDIA H100 SXM5 80GB", (989e12, 1979e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 1513e12, 2.0e12)),
    ("NVIDIA H100 NVL", (835e12, 1671e12, 3.9e12)),
])
def test_device_peaks_by_card_name(monkeypatch, name, want):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    peaks = bm.device_peaks("cuda")
    assert (peaks["bf16"], peaks["int8"], peaks["hbm"]) == want


def test_device_peaks_unknown_card_raises_and_cpu_has_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="A100-SXM4-80GB"):
        bm.device_peaks("cuda")
    assert bm.device_peaks(CPU) is None


def test_main_without_a_card_exits_naming_device_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bm.main(["--suite", "dgemm", "--panels", "toy"])
    assert capsys.readouterr().out == ""


# -- the reference's tests/test_benchmark_cli.py, on the port's module -------

def _run(monkeypatch, capsys, argv):
    calls = []

    def stub(name):
        def f(panel=None, device=None, **kw):
            assert device == torch.device(CPU)
            calls.append((name, panel))
            return {"suite": name, "panel": panel}
        return f

    def ref_stub(device=None, **kw):
        assert device == torch.device(CPU)
        calls.append(("ref", None))
        return {"suite": "grm", "panel": "ref_many_snps"}

    monkeypatch.setattr(bm, "bench_dgemm", stub("dgemm"))
    monkeypatch.setattr(bm, "bench_grm", stub("grm"))
    monkeypatch.setattr(bm, "bench_ld", stub("ld"))
    monkeypatch.setattr(bm, "bench_grm_ref_panel", ref_stub)
    monkeypatch.setattr(bm, "bench_scaling",
                        lambda **kw: {"suite": "scaling"})
    assert bm.main([*argv, "--device", CPU]) == 0
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    return calls, out


def test_suite_all_skips_grm_only_panels(monkeypatch, capsys):
    calls, out = _run(monkeypatch, capsys,
                      ["--suite", "all", "--panels", "small", "ref_many_snps"])
    # dgemm and ld must silently skip ref_many_snps, grm must run it
    assert ("dgemm", "small") in calls
    assert ("dgemm", "ref_many_snps") not in calls
    assert ("ld", "ref_many_snps") not in calls
    assert ("ref", None) in calls
    assert ("grm", "small") in calls
    assert any(o.get("suite") == "scaling" for o in out)


def test_single_suite_routing(monkeypatch, capsys):
    calls, out = _run(monkeypatch, capsys,
                      ["--suite", "grm", "--panels", "ref_many_snps"])
    assert calls == [("ref", None)]
    assert out == [{"suite": "grm", "panel": "ref_many_snps"}]


def test_ld_skip_row_for_oversized_panels():
    # real bench_ld short-circuits before any panel work for panels whose
    # snps^2 output exceeds one card
    row = bm.bench_ld("small", device=CPU)
    assert row["suite"] == "ld" and "skipped" in row


def test_sparse_solve_suite_routing(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(bm, "bench_sparse_solve",
                        lambda n, device: calls.append((n, device))
                        or {"suite": "sparse_solve"})
    assert bm.main(["--suite", "sparse_solve", "--sparse-n", "1234",
                    "--device", CPU]) == 0
    assert calls == [(1234, torch.device(CPU))]


def test_bench_sparse_solve_small_real():
    # the real row at toy size runs fine on CPU and self-checks its residual
    row = bm.bench_sparse_solve(n=300, ncol=2, iters=2, device=CPU)
    assert row["suite"] == "sparse_solve"
    assert row["rel_residual"] < 1e-4


def test_gblup_fullscale_suite_routing(monkeypatch, capsys):
    monkeypatch.setattr(bm, "bench_gblup_fullscale",
                        lambda device: {"suite": "gblup_fullscale"})
    assert bm.main(["--suite", "gblup_fullscale", "--device", CPU]) == 0
    assert "gblup_fullscale" in capsys.readouterr().out


def test_bench_gblup_fullscale_toy():
    row = bm.bench_gblup_fullscale(snps=4096, indiv=256, chunks=2,
                                   maxiter=200, tol=1e-3, device=CPU)
    assert row["converged"] and row["cg_iterations"] > 0


def test_dgemm_exact_suite_routing(monkeypatch, capsys):
    monkeypatch.setattr(bm, "bench_dgemm_exact",
                        lambda p, ncol, device: {"suite": "dgemm_exact",
                                                 "panel": p})
    bm.main(["--suite", "dgemm_exact", "--panels", "small", "--ncol", "4",
             "--device", CPU])
    out = capsys.readouterr().out
    assert '"dgemm_exact"' in out and '"small"' in out
