"""What a traced run records, from the benchmark's own files.

- Spans: ``torch.profiler.record_function`` around the port's layer
  entries, put in place by replacing the function object wherever a module
  of the port holds it (its own module and every ``from ... import``).
- Launch log: the shapes of every kernel launch, taken by wrapping the
  launchers of ``miraculix_tpu_torch._kernels``; the roofline readers count
  each launch's work from them.
- The device trace: ``torch.profiler`` over the window, CPU and CUDA, read
  once it stops into plain tuples (a span's mirror on the device's
  timeline is no device operation); the union of the device events' intervals
  (``chip_smoke.device_busy``'s arithmetic), the device operations by time
  and the idle gaps by the innermost span open while they last.

Nothing here runs in an untraced run.
"""
from __future__ import annotations

import importlib
import sys
from typing import Callable

import torch

SPAN_PREFIX = "genobench."
PKG = "miraculix_tpu_torch"

# the layer entries a span wraps: (module, function)
LAYER_ENTRIES = (
    ("ops.grm", "grm"),
    ("ops.grm", "snp_crossprod"),
    ("gblup", "gblup"),
    ("gwas", "gwas_linear"),
    ("gwas", "_t_pass"),
    ("gwas", "_snp_residual_denominators"),
    ("gwas", "_pvalues"),
    ("solve.cg", "cg"),
    ("solve.cg", "grm_cg_solve"),
    ("solve.cg", "grm_matvec"),
    ("ops.dgemm", "dgemm"),
    ("ops.common", "packed_row_sq_stats"),
)
# the launchers whose shapes the launch log keeps
LAUNCHERS = ("tall_dgemm", "wide_dgemm", "crossprod", "crossprod_rect",
             "crossprod_tri", "crossprod_weighted", "matmul_int8")


def union_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or b > end:
            busy += b - (a if end is None else max(a, end))
            end = b
    return busy


def holders(original: Callable) -> list:
    """(module, name) of every place a module of the port holds
    ``original``: its own module and every ``from ... import``."""
    places = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == PKG or name.startswith(PKG + ".")):
            continue
        places += [(mod, attr) for attr, val in list(vars(mod).items())
                   if val is original]
    return places


def _replace(original: Callable, wrapped: Callable) -> list:
    """Put ``wrapped`` wherever a module of the port holds ``original``;
    returns the places, to put it back."""
    places = holders(original)
    for mod, attr in places:
        setattr(mod, attr, wrapped)
    return places


class Recorder:
    """Spans and the launch log, in place while it is entered."""

    def __init__(self):
        self.launches: list = []   # (launcher, first shape, second shape)
        self._undo: list = []

    def _span(self, label: str, fn: Callable) -> Callable:
        def traced(*a, **kw):
            with torch.profiler.record_function(SPAN_PREFIX + label):
                return fn(*a, **kw)
        return traced

    def _logged(self, label: str, fn: Callable) -> Callable:
        log = self.launches

        def launched(*a, **kw):
            shapes = [tuple(t.shape) if isinstance(t, torch.Tensor)
                      else None for t in a[:2]]
            log.append((label, *(shapes + [None])[:2]))
            with torch.profiler.record_function(SPAN_PREFIX + "launch."
                                                + label):
                return fn(*a, **kw)
        return launched

    def __enter__(self):
        kernels = importlib.import_module(PKG + "._kernels")
        for name in LAUNCHERS:
            fn = getattr(kernels, name)
            self._undo.append((fn, _replace(fn, self._logged(name, fn))))
        for mod_name, fn_name in LAYER_ENTRIES:
            fn = getattr(importlib.import_module(f"{PKG}.{mod_name}"),
                         fn_name)
            self._undo.append((fn, _replace(fn, self._span(fn_name, fn))))
        return self

    def __exit__(self, *exc):
        for fn, places in reversed(self._undo):
            for mod, attr in places:
                setattr(mod, attr, fn)
        self._undo.clear()
        return False


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    return int(f()) if f is not None else int(getattr(e, what + "_us")()
                                              * 1000)


class DeviceTrace:
    """The profiler's events as plain tuples: device operations (name,
    start, end) and the benchmark's spans (name, start, end), in ns on the
    profiler's clock."""

    def __init__(self, prof):
        self.device_ops, self.spans = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start = _ns(e, "start")
            end = start + int(e.duration_ns())
            if not name.startswith(SPAN_PREFIX):
                if e.device_type() == cuda:
                    self.device_ops.append((name, start, end))
            elif e.device_type() != cuda:    # not the span's device mirror
                self.spans.append((name[len(SPAN_PREFIX):], start, end))

    def window(self) -> tuple[int, int]:
        """The traced window's span ("window")."""
        for name, a, b in self.spans:
            if name == "window":
                return a, b
        raise RuntimeError("the trace holds no window span")

    def window_s(self) -> float:
        a, b = self.window()
        return (b - a) / 1e9

    def in_window(self):
        a, b = self.window()
        return [(n, max(s, a), min(e, b)) for n, s, e in self.device_ops
                if e > a and s < b]

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.in_window()]) / 1e9

    def top_ops(self, k: int = 10) -> list:
        """The device operations that took most time, summed by name."""
        tot: dict = {}
        for n, s, e in self.in_window():
            tot[n] = tot.get(n, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The window's idle device time, each stretch of it charged to the
        innermost span open on the host while it lasted."""
        a, b = self.window()
        gaps, end = [], a
        for s, e in sorted((s, e) for _, s, e in self.in_window()):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if b > end:
            gaps.append((end, b))
        # span boundaries in time order (an end before a start at one time)
        marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
                       + [(e, 0, i) for i, (_, _, e) in enumerate(self.spans)])
        marks.append((b, 0, None))
        stack, tot, g, t = [], {}, 0, a
        for when, opens, i in marks:
            lo, hi = t, min(when, b)
            if hi > lo:
                label = self.spans[stack[-1]][0] if stack else \
                    "outside any span"
                while g < len(gaps) and gaps[g][1] <= lo:
                    g += 1
                h = g
                while h < len(gaps) and gaps[h][0] < hi:
                    part = min(hi, gaps[h][1]) - max(lo, gaps[h][0])
                    tot[label] = tot.get(label, 0) + part
                    h += 1
            t = max(t, when)
            if i is None:
                break
            if opens:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, v / 1e9] for n, v in top]

    def family_seconds(self, family: str) -> float:
        """Device seconds of the kernels of one launcher family
        (:func:`kernel_family`); the split reduction, which the tall and the
        wide kernels share, takes the family of the kernel before it."""
        total, prev = 0, None
        for n, s, e in sorted(self.in_window(), key=lambda t: t[1]):
            fam = kernel_family(n)
            if fam == SHARED:
                fam = prev
            if fam == family:
                total += e - s
            prev = fam
        return total / 1e9


SHARED = "shared"
# kernel-name fragments of csrc/*.cu by launcher family
FAMILIES = (("tall_dgemm", ("tall_parts", "tall_mma")),
            ("wide_dgemm", ("wide_parts", "wide_mma")),
            ("crossprod", ("crossprod_kernel",)),
            ("crossprod_rect", ("crossprod_rect_kernel",)),
            ("crossprod_weighted", ("weighted_digits", "weighted_mma")),
            ("matmul_int8", ("matmul_int8_kernel", "digit_quads_kernel")),
            (SHARED, ("reduce_splits",)))


def kernel_family(name: str):
    """The launcher family of a device operation's name, or None."""
    for fam, frags in FAMILIES:
        if any(f in name for f in frags):
            return fam
    return None
