"""The port's spans (``utils.logging.span``) and the benchmark's readers of
them (``genobench/metrics/``).

Off (no profile recording) a span is one shared no-op and records nothing;
under ``torch.profiler.profile`` the entries, the CG loop, the products and
the launchers record their spans with parent and root, on the profiler's
clock, and ``device_trace`` writes them into its Chrome trace.  The readers
report nothing without program spans, and the idle time a hand-built run
charges to its spans.
"""
import importlib
import json
import os
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import (ProfilerActivity, profile,  # noqa: E402
                            record_function)

import miraculix_tpu_torch as mt  # noqa: E402
from miraculix_tpu_torch import _kernels, gblup, gwas  # noqa: E402
from miraculix_tpu_torch.io import bed  # noqa: E402
from miraculix_tpu_torch.ops import grm as grm_ops  # noqa: E402
from miraculix_tpu_torch.utils import logging as mlog  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from genobench import harness, trace  # noqa: E402
from genobench import spans as gspans  # noqa: E402

cg_mod = importlib.import_module("miraculix_tpu_torch.solve.cg")
CPU = "cpu"
INDIV, SNPS = 120, 700


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_spans():
    mlog.clear_spans()
    yield
    mlog.clear_spans()


@pytest.fixture(scope="module")
def panel():
    g = bed.simulate_genotypes(INDIV, SNPS, seed=5)
    y = np.random.default_rng(3).standard_normal(INDIV)
    return mt.from_dense(g, device=CPU), y


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def call(entry: str, g, y):
    """One call of an entry on the toy panel; returns its result."""
    if entry == "gblup":
        return gblup.gblup(g, y, n_pcs=0, tol=1e-4)
    if entry == "gwas_linear":
        return gwas.gwas_linear(g, y, covariates=y[:, None] ** 2)
    if entry == "grm_cg_solve":
        rhs = np.stack([y, np.ones(INDIV)], axis=1)
        return cg_mod.grm_cg_solve(g, rhs, lam=1.0, tol=1e-3)
    return grm_ops.grm(g)


def names(recs):
    return [r[0] for r in recs]


@pytest.mark.parametrize("entry", ["gblup", "gwas_linear", "grm_cg_solve",
                                   "grm"])
def test_off_a_span_is_one_shared_noop(panel, entry):
    g, y = panel
    assert not torch.autograd._profiler_enabled()
    call(entry, g, y)
    assert mlog.spans() == []
    off = mlog.span("cg.iteration")
    assert mlog.span("tall_dgemm", zq=torch.zeros(2, 2)) is off
    with off as inner:
        assert inner is off


# the spans each entry records, with the name of each one's parent
EXPECTED = {
    "gblup": {"gblup": None, "gblup.solve": "gblup",
              "grm_cg_solve": "gblup.solve", "cg": "grm_cg_solve",
              "cg.iteration": "cg", "cg.stop_test": ("cg", "cg.iteration"),
              "grm_matvec": ("cg.iteration", "gblup"),
              "dgemm": "grm_matvec"},
    "gwas_linear": {"gwas_linear": None, "gwas.t_pass": "gwas_linear",
                    "dgemm": "gwas.t_pass",
                    "gwas.row_sq_stats": "gwas_linear",
                    "packed_row_sq_stats": "gwas.row_sq_stats",
                    "gwas.denominators": "gwas_linear",
                    "gwas.epilogue": "gwas_linear",
                    "gwas.pvalues": "gwas.epilogue"},
    "grm_cg_solve": {"grm_cg_solve": None, "cg": "grm_cg_solve",
                     "cg.iteration": "cg",
                     "cg.stop_test": ("cg", "cg.iteration"),
                     "grm_matvec": "cg.iteration", "dgemm": "grm_matvec"},
    "grm": {"grm": None, "grm.crossprod": "grm", "grm.finish": "grm"},
}


@pytest.mark.parametrize("entry", sorted(EXPECTED))
def test_profiled_entries_record_their_spans(panel, entry):
    g, y = panel
    with recording():
        res = call(entry, g, y)
    recs = mlog.spans()
    want = EXPECTED[entry]
    assert set(names(recs)) == set(want)
    assert recs[0][0] == entry
    for i, (name, a, b, parent, root, attrs) in enumerate(recs):
        assert a <= b and root == 0
        if want[name] is None:
            assert parent is None
            continue
        p = recs[parent]
        assert p[0] in ((want[name],) if isinstance(want[name], str)
                        else want[name])
        assert p[1] <= a and b <= p[2]
    if entry in ("gblup", "grm_cg_solve"):
        its = res.cg_iterations if entry == "gblup" else res.iterations
        solves = names(recs).count("cg")
        assert solves == (2 if entry == "gblup" else 1)
        assert names(recs).count("cg.iteration") == its
        assert names(recs).count("cg.stop_test") == its + solves
        assert [r[5] for r in recs if r[0] == "cg"] == (
            [{"columns": 2}, {"columns": 1}] if entry == "gblup"
            else [{"columns": 2}])
    for r in recs:
        if r[0] == "dgemm":
            assert set(r[5]) == {"trans", "columns", "precision"}
    assert names(recs).count("gwas.t_pass") == (2 if entry == "gwas_linear"
                                                else 0)


def test_cg_columns_and_dgemm_attrs(panel):
    g, _ = panel
    v = torch.ones(INDIV, 3)
    with recording():
        cg_mod.cg(lambda x: 2.0 * x, v, tol=1e-6)
        cg_mod.grm_matvec(g, v[:, 0])
    recs = mlog.spans()
    assert recs[0][0] == "cg" and recs[0][5] == {"columns": 3}
    dg = [r[5] for r in recs if r[0] == "dgemm"]
    assert dg == [{"trans": "t", "columns": 1, "precision": "fast"},
                  {"trans": "n", "columns": 1, "precision": "fast"}]


def test_a_span_keeps_tensor_attrs_by_shape_and_nests():
    with recording():
        with mlog.span("outer", zq=torch.zeros(3, 5), mode="split") as s:
            with mlog.span("inner"):
                pass
        with mlog.span("next"):
            pass
    assert s is not mlog._OFF
    (n0, a0, b0, p0, r0, at0), (n1, a1, b1, p1, r1, _), (n2, *_, p2, r2, _) \
        = mlog.spans()
    assert (n0, p0, r0, at0) == ("outer", None, 0,
                                 {"zq": (3, 5), "mode": "split"})
    assert (n1, p1, r1) == ("inner", 0, 0) and a0 <= a1 <= b1 <= b0
    assert (n2, p2, r2) == ("next", None, 2)


def test_clear_spans_forgets_the_open_ones():
    with recording():
        with mlog.span("old"):
            mlog.clear_spans()
            with mlog.span("new"):
                pass
    assert [(r[0], r[3], r[4]) for r in mlog.spans()] == [("new", None, 0)]


def test_phase_timer_phase_is_a_span():
    t = mlog.PhaseTimer(verbose=False)
    with recording():
        with t.phase("pack"):
            with mlog.span("inner"):
                pass
    assert [(r[0], r[3]) for r in mlog.spans()] == [("pack", None),
                                                    ("inner", 0)]
    assert [n for n, _ in t.phases] == ["pack"]


def test_record_function_inside_a_span_lies_inside_on_the_clock():
    with recording() as prof:
        with mlog.span("outer"):
            time.sleep(0.002)
            with record_function("probe"):
                torch.ones(64) * 2
            time.sleep(0.002)
    (_, a, b, *_), = mlog.spans()
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert len(probe) == 1
    s = probe[0].start_ns()
    e = s + probe[0].duration_ns()
    assert a < s <= e < b


def test_device_trace_writes_the_spans(tmp_path):
    with recording():
        with mlog.span("before"):
            pass
    d = str(tmp_path / "trace")
    with mlog.device_trace(d):
        with mlog.span("probe", zq=torch.zeros(4, 2)):
            with record_function("inside"):
                torch.ones(8) * 3
    (f,) = os.listdir(d)
    tr = json.load(open(os.path.join(d, f)))
    ours = [e for e in tr["traceEvents"] if e.get("cat") == "program_span"]
    assert [(e["name"], e["args"]["zq"]) for e in ours] == [("probe",
                                                             [4, 2])]
    rf, = [e for e in tr["traceEvents"] if e.get("name") == "inside"
           and e.get("cat") == "user_annotation"]
    (sp,) = ours
    assert sp["ts"] <= rf["ts"] and rf["ts"] + rf["dur"] <= \
        sp["ts"] + sp["dur"]


class _Stop(Exception):
    pass


def _stop():
    raise _Stop


I32, F32 = torch.int32, torch.float32
# launcher, its arguments, the span's name and attrs
LAUNCH_CASES = {
    "tall_dgemm": (lambda z, b: _kernels.tall_dgemm(z, b), "tall_dgemm",
                   "split"),
    "tall_dgemm_cv": (lambda z, b: _kernels.tall_dgemm(
        z, b, cv=torch.zeros(b.shape[0])), "tall_dgemm_cv", "split"),
    "tall_dgemm_bf16": (lambda z, b: _kernels.tall_dgemm(z, b, mode="bf16"),
                        "tall_dgemm_bf16", "bf16"),
    "tall_dgemm_f32": (lambda z, b: _kernels.tall_dgemm(z, b, mode="f32"),
                       "tall_dgemm_f32", "f32"),
    "wide_dgemm": (lambda z, b: _kernels.wide_dgemm(z, b, "hilo"),
                   "wide_dgemm_hilo", "hilo"),
    "crossprod": (lambda z, b: _kernels.crossprod(z), "crossprod", None),
    "crossprod_rect": (lambda z, b: _kernels.crossprod_rect(z, z),
                       "crossprod_rect", None),
    "crossprod_tri": (lambda z, b: _kernels.crossprod_tri(z),
                      "crossprod_tri", None),
    "crossprod_weighted": (lambda z, b: _kernels.crossprod_weighted(
        z, torch.zeros(16, z.shape[1])), "crossprod_weighted", None),
    "matmul_int8": (lambda z, b: _kernels.matmul_int8(
        z, torch.zeros(40, 2, dtype=torch.int8)), "matmul_int8", None),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_a_launcher_call_is_a_span_named_by_its_launch_counter(
        case, monkeypatch):
    """Each launcher's span carries its ``LAUNCHES`` name, the packed
    words' shape and B's (or the weights' or digits') shape, as the
    benchmark's launch log keeps them; on the CPU the call stops where it
    needs the card."""
    fn, name, mode = LAUNCH_CASES[case]
    monkeypatch.setattr(_kernels, "_load", _stop)
    z, b = torch.zeros(32, 3, dtype=I32), torch.zeros(40, 2, dtype=F32)
    with recording():
        with pytest.raises((_Stop, ValueError)):
            fn(z, b)
    (rec,) = mlog.spans()
    assert rec[0] == name and name in _kernels.LAUNCHES
    assert rec[2] is not None and rec[5]["zq"] == (32, 3)
    other = {"crossprod": None, "crossprod_rect": (32, 3),
             "crossprod_tri": (32, 3), "crossprod_weighted": (16, 3),
             "matmul_int8": (40, 2)}.get(case, (40, 2))
    assert rec[5].get("b") == other and rec[5].get("mode") == mode


# -- the benchmark's readers ------------------------------------------------

NEW = ("cg.idle_ms_per_iteration", "gblup.host_idle_ms_per_job",
       "gwas.host_idle_ms_per_job", "kernels.host_us_per_launch")
MS = 1_000_000


def fake_run(device_ops, window=(0, 10 * MS)):
    t = trace.DeviceTrace.__new__(trace.DeviceTrace)
    t.device_ops, t.spans = device_ops, [("window", *window)]
    return harness.Run([{"ok": True, "s": 0.01}], 0.01, {}, t)


def made(recs):
    """Program spans (name, start, end, parent) as the port records them."""
    out = []
    for name, a, b, parent in recs:
        root = len(out) if parent is None else out[parent][4]
        out.append((name, a, b, parent, root, {}))
    return out


# window 0-10 ms; the device busy 2.5-3, 4.6-5.5 and 8-8.5 ms
GBLUP_SPANS = made([("gblup", 0, 9 * MS, None),
                    ("cg", 1 * MS, 7 * MS, 0),
                    ("cg.iteration", 2 * MS, 4 * MS, 1),
                    ("cg.stop_test", 3 * MS, 4 * MS, 2),
                    ("cg.iteration", 4 * MS, 6 * MS, 1),
                    ("tall_dgemm_cv", 4.5 * MS, 4.6 * MS, 4),
                    ("tall_dgemm", 5.5 * MS, 5.8 * MS, 4)])
GBLUP_OPS = [("tall_mma", 2.5 * MS, 3 * MS), ("tall_mma", 4.6 * MS, 5.5 * MS),
             ("elementwise", 8 * MS, 8.5 * MS)]
# window 0-10 ms, two jobs; the device busy 2-2.2 and 3.2-3.6 ms
GWAS_SPANS = made([("gwas_linear", 0, 8 * MS, None),
                   ("gwas.t_pass", 1 * MS, 3 * MS, 0),
                   ("dgemm", 1.5 * MS, 2.5 * MS, 1),
                   ("gwas.row_sq_stats", 3 * MS, 4 * MS, 0),
                   ("packed_row_sq_stats", 3 * MS, 3.8 * MS, 3),
                   ("gwas.epilogue", 5 * MS, 7 * MS, 0),
                   ("gwas.pvalues", 5.5 * MS, 7 * MS, 5),
                   ("gwas_linear", 8 * MS, 9 * MS, None)])
GWAS_OPS = [("sum", 2 * MS, 2.2 * MS), ("sum", 3.2 * MS, 3.6 * MS)]
# (spans, device ops, the reading): idle 0.5 + 1 + 0.5 + 0.1 + 0.5 ms in
# the two iterations; 1 + 1 + 0.5 ms in gblup outside cg; 5 + 1 ms in
# gwas_linear outside its passes, two jobs; launches of 100 and 300 us
READINGS = {
    "cg.idle_ms_per_iteration": (GBLUP_SPANS, GBLUP_OPS, 2.6 / 2),
    "gblup.host_idle_ms_per_job": (GBLUP_SPANS, GBLUP_OPS, 2.5),
    "gwas.host_idle_ms_per_job": (GWAS_SPANS, GWAS_OPS, 6.0 / 2),
    "kernels.host_us_per_launch": (GBLUP_SPANS, GBLUP_OPS, 200.0),
}


@pytest.mark.parametrize("metric", NEW)
def test_reader_on_a_hand_built_run(metric, monkeypatch):
    recs, ops, want = READINGS[metric]
    monkeypatch.setattr(mlog, "spans", lambda: recs)
    assert harness.reader(metric)(fake_run(ops)) == pytest.approx(want)


@pytest.mark.parametrize("metric", NEW)
def test_reader_reports_nothing_without_program_spans(metric, monkeypatch):
    read = harness.reader(metric)
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(fake_run(GBLUP_OPS)) is None             # none recorded
    other = GWAS_SPANS if "gwas" not in metric else GBLUP_SPANS
    monkeypatch.setattr(mlog, "spans", lambda: other)
    assert read(fake_run(GBLUP_OPS)) is None              # none of its kind
    later = [(n, a + 20 * MS, b + 20 * MS, p, r, at)
             for n, a, b, p, r, at in READINGS[metric][0]]
    monkeypatch.setattr(mlog, "spans", lambda: later)
    assert read(fake_run(GBLUP_OPS)) is None          # outside the window
    monkeypatch.delattr(mlog, "spans")                # a program without
    assert read(fake_run(GBLUP_OPS)) is None


@pytest.mark.parametrize("recs,ops", [(GBLUP_SPANS, GBLUP_OPS),
                                      (GWAS_SPANS, GWAS_OPS)])
def test_idle_charged_partitions_the_windows_idle(recs, ops, monkeypatch):
    monkeypatch.setattr(mlog, "spans", lambda: recs)
    run = fake_run(ops)
    charged, outside = gspans.idle_charged(run)
    idle = 10 * MS - trace.union_ns([(s, e) for _, s, e in ops])
    assert sum(charged.values()) + outside == pytest.approx(idle)
    assert outside == pytest.approx(1 * MS)


@pytest.mark.parametrize("cell,metrics", [
    ("small.gblup", ("cg.idle_ms_per_iteration",
                     "gblup.host_idle_ms_per_job")),
    ("many_snps.gwas", ("gwas.host_idle_ms_per_job",)),
    ("small.solve_block32", ("cg.idle_ms_per_iteration",))])
def test_traced_toy_run_reports_the_span_metrics(cell, metrics):
    """A traced toy-sized run of the cell on the CPU (no device operation:
    the whole window idle) reports the cell's span metrics; no launcher
    runs on the CPU, so the launch time is left out."""
    sys.path.insert(0, os.path.join(ROOT, "genobench", "tests"))
    try:
        import toy
    finally:
        sys.path.pop(0)
    result, _ = toy.drive(cell, seconds=0.2, traced=True)
    got = result["metrics"]
    assert all(got[m]["value"] > 0 for m in metrics), got
    assert "kernels.host_us_per_launch" not in got
    assert result["correct"]
