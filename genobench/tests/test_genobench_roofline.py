"""The roofline's work counts, peaks and share, the trace arithmetic and
the per-layer readers on a made-up trace."""
import types

import pytest

import toy  # noqa: F401
from genobench import harness, roofline, trace

H100 = "NVIDIA H100 80GB HBM3"


def test_peaks_by_card_name():
    assert roofline.peaks(H100) == dict(bf16=989e12, int8=1979e12,
                                        hbm=3.35e12)
    assert roofline.peaks("NVIDIA H100 PCIe")["hbm"] == 2.0e12
    with pytest.raises(ValueError):
        roofline.peaks("NVIDIA A100-SXM4-80GB")


def test_crossprod_work_at_hand_shapes():
    # 3 rows over 17 SNPs: the triangle's 6 pairs x 17 multiply-adds x 2;
    # 2 words a row; the 3 x 3 int32 square
    ops, nbytes = roofline.crossprod_work(3, 17)
    assert ops == 2 * 6 * 17
    assert nbytes == 4 * 3 * 2 + 4 * 9
    # the many_snps panel: ops bound on the H100 (0.223 s)
    ops, nbytes = roofline.crossprod_work(21000, 1_000_000)
    assert ops == 21000 * 21001 * 1_000_000
    assert nbytes == 4 * 21000 * 62500 + 4 * 21000 ** 2
    p = roofline.peaks(H100)
    assert roofline.bound_s(ops, nbytes, p["int8"], p["hbm"]) == \
        pytest.approx(21000 * 21001 * 1e6 / 1979e12)


def test_tall_work_at_hand_shapes():
    # B [5, 2] over a packing whose decoded columns are 33 (3 words)
    ops, nbytes = roofline.tall_work(5, 33, 2)
    assert ops == 2 * 5 * 33 * 2
    assert nbytes == 4 * 5 * 3 + 4 * 5 * 2 + 4 * 33 * 2
    # a 1-column 't' pass of the small panel: bytes bound (0.38 ms)
    ops, nbytes = roofline.tall_work(101000, 50241, 1)
    p = roofline.peaks(H100)
    assert roofline.bound_s(ops, nbytes, p["bf16"], p["hbm"]) == \
        pytest.approx(nbytes / 3.35e12)
    assert nbytes == 4 * 101000 * 3141 + 4 * 101000 + 4 * 50241


def test_share_refuses_above_105_percent():
    assert roofline.share([0.5, 0.25], 1.0, "k") == pytest.approx(75.0)
    assert roofline.share([1.04], 1.0, "k") == pytest.approx(104.0)
    assert roofline.share([], 1.0, "k") is None
    assert roofline.share([1.0], 0.0, "k") is None
    with pytest.raises(RuntimeError, match="miscounted"):
        roofline.share([1.06], 1.0, "k")


def test_union_and_families():
    assert trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.union_ns([(0, 10), (2, 3)]) == 10
    assert trace.union_ns([]) == 0
    assert trace.kernel_family("void tall_mma<4, 2>(unsigned const*)") == \
        "tall_dgemm"
    assert trace.kernel_family("tall_parts") == "tall_dgemm"
    assert trace.kernel_family("crossprod_kernel(unsigned const*, int)") == \
        "crossprod"
    assert trace.kernel_family("crossprod_rect_kernel") == "crossprod_rect"
    assert trace.kernel_family("mx::reduce_splits(float const*)") == \
        trace.SHARED
    assert trace.kernel_family("elementwise_kernel") is None


def fake_trace(device_ops, spans):
    t = trace.DeviceTrace.__new__(trace.DeviceTrace)
    t.device_ops, t.spans = device_ops, spans
    return t


def test_trace_reading():
    # window 0..1000 ns: a tall launch (parts, mma, reduction) inside a
    # span, an elementwise op, a wide reduction; gaps in two spans
    ops = [("tall_parts", 100, 150), ("tall_mma<1, 2>", 150, 350),
           ("mx::reduce_splits", 350, 400), ("elementwise", 500, 600),
           ("wide_mma", 700, 800), ("mx::reduce_splits", 800, 820)]
    spans = [("window", 0, 1000), ("job", 10, 990), ("dgemm", 90, 420),
             ("cg", 420, 900)]
    t = fake_trace(ops, spans)
    assert t.window_s() == 1e-6
    assert t.busy_s() == pytest.approx((300 + 100 + 120) / 1e9)
    assert t.family_seconds("tall_dgemm") == pytest.approx(300 / 1e9)
    assert t.family_seconds("wide_dgemm") == pytest.approx(120 / 1e9)
    # gaps 0-100 (window to 10, job to 90, then dgemm), 400-500 (dgemm to
    # 420, then cg), 600-700 (cg) and 820-1000 (cg to 900, job to 990,
    # then window)
    assert dict(t.idle_gaps()) == pytest.approx(
        {"window": 20 / 1e9, "job": 170 / 1e9, "dgemm": 30 / 1e9,
         "cg": 260 / 1e9})
    assert t.top_ops(2)[0] == ["tall_mma<1, 2>", 200 / 1e9]


def test_readers_on_a_made_up_run():
    ops = [("crossprod_kernel", 0, 2_000_000), ("tall_mma<4, 2>",
                                                2_000_000, 3_000_000)]
    t = fake_trace(ops, [("window", 0, 4_000_000)])
    dims = {(256, 128): (200, 2000), (2048, 128): (2000, 200)}
    log = [("crossprod", (256, 128), None),
           ("tall_dgemm", (256, 128), (200, 4))]
    run = harness.Run([{"ok": True, "s": 1.0, "cg_iterations": 3},
                       {"ok": True, "s": 1.0, "cg_iterations": 5},
                       {"ok": False, "s": 1.0, "cg_iterations": 9}],
                      4e-3, {"crossprod": 1, "tall_dgemm": 3}, t, log,
                      roofline.peaks(H100), dims)
    read = {n: harness.reader(n) for n in (
        "device.idle_share", "kernels.launches_per_job",
        "cg.iterations_per_job", "crossprod_roofline",
        "tall_dgemm_roofline")}
    assert read["device.idle_share"](run) == pytest.approx(25.0)
    assert read["kernels.launches_per_job"](run) == 2.0
    assert read["cg.iterations_per_job"](run) == 4.0
    c_ops, c_bytes = roofline.crossprod_work(200, 2000)
    want = 100 * max(c_ops / 1979e12, c_bytes / 3.35e12) / 2e-3
    assert read["crossprod_roofline"](run) == pytest.approx(want)
    t_ops, t_bytes = roofline.tall_work(200, 2000, 4)
    want = 100 * max(t_ops / 989e12, t_bytes / 3.35e12) / 1e-3
    assert read["tall_dgemm_roofline"](run) == pytest.approx(want)
    untraced = types.SimpleNamespace(trace=None)
    assert read["device.idle_share"](untraced) is None
    assert read["crossprod_roofline"](untraced) is None
    # a count too high fails the run
    run.launch_log = log * 30000
    with pytest.raises(RuntimeError, match="miscounted"):
        read["crossprod_roofline"](run)
