"""Logging / tracing / banner utilities.

Parity with the reference's observability (SURVEY.md §5): the PRINT_LEVEL
env-gated logging (src/cuda/cuda_utils.cu:44-63), the STARTCLOCK/CLOCK
per-phase wall timers (src/miraculix/Vector.matrix.D.cc:51,89-221), the
compile banner with build info (cuda_utils.cu:65-82) and the free-memory
guard (``checkDevMemory``).  Adds a ``torch.profiler`` trace hook and the
program's spans, which record while a profile does.  The environment
variables keep the JAX package's names (``MIRACULIX_TPU_PRINT_LEVEL``,
``PRINT_LEVEL``).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled


def print_level() -> int:
    """Env-gated verbosity (reference PRINT_LEVEL / get_print_level)."""
    try:
        return int(os.environ.get("MIRACULIX_TPU_PRINT_LEVEL",
                                  os.environ.get("PRINT_LEVEL", "0")))
    except ValueError:
        return 0


def debug_info(msg: str, level: int = 1) -> None:
    """Print when verbosity >= level (reference debug_info)."""
    if print_level() >= level:
        print(f"[miraculix_tpu_torch] {msg}", file=sys.stderr, flush=True)


def compile_info() -> str:
    """The banner line: the port's, torch's and CUDA's versions and the
    CUDA cards (their count and the first one's name), or that there is
    none."""
    from .. import __version__

    if torch.cuda.is_available():
        cards = (f"{torch.cuda.device_count()} CUDA device(s): "
                 f"{torch.cuda.get_device_name(0)}")
    else:
        cards = "no CUDA device"
    return (f"miraculix_tpu_torch {__version__} | torch {torch.__version__} "
            f"| cuda {torch.version.cuda} | {cards}")


def print_compile_info() -> None:
    """Startup banner (reference print_compile_info: versions, device)."""
    print(compile_info(), file=sys.stderr)


class PhaseTimer:
    """Named phase wall timers (reference STARTCLOCK/CLOCK macros).

    >>> t = PhaseTimer()
    >>> with t.phase("pack"): ...
    >>> t.report()
    """

    def __init__(self, verbose: Optional[bool] = None):
        self.phases: List[Tuple[str, float]] = []
        self.verbose = print_level() >= 2 if verbose is None else verbose

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.time()
        try:
            with span(name):
                yield
        finally:
            dt = time.time() - t0
            self.phases.append((name, dt))
            if self.verbose:
                debug_info(f"{name}: {dt * 1e3:.2f} ms", level=0)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.phases:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> str:
        lines = [f"  {n:<24s} {dt * 1e3:10.2f} ms"
                 for n, dt in self.totals().items()]
        return "\n".join(lines)


# The program's spans, one (name, start_ns, end_ns, parent, root, attrs)
# each, in the order they began: times by time.time_ns(), the clock the
# profiler stamps its events with; parent the index of the span open when
# it began (None at the top), root the index of the outermost one (its
# own at the top), so one entry call's spans share it; end_ns None while
# the span is open.  Recorded only while a torch.profiler profile records,
# on the thread that runs it (others read the profiler as off).
_SPANS: list = []
_lock = threading.Lock()
_local = threading.local()        # .open: this thread's open _Span objects
_gen = 0                          # clear_spans() calls so far


class _Off:
    """The span of an unprofiled call: enters and exits, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "index", "gen", "start", "parent", "root")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "open", None)
        if stack is None:
            stack = _local.open = []
        top = stack[-1] if stack and stack[-1].gen == _gen else None
        for k, v in self.attrs.items():
            if isinstance(v, torch.Tensor):
                self.attrs[k] = tuple(v.shape)
        with _lock:
            self.gen, self.index = _gen, len(_SPANS)
            self.parent = None if top is None else top.index
            self.root = self.index if top is None else top.root
            self.start = time.time_ns()
            _SPANS.append((self.name, self.start, None, self.parent,
                           self.root, self.attrs))
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.open.pop()
        with _lock:
            if self.gen == _gen:
                _SPANS[self.index] = (self.name, self.start, end, self.parent,
                                      self.root, self.attrs)
        return False


def span(name: str, **attrs):
    """A span of the program's work, for ``with``: recorded (see
    :func:`spans`) while a ``torch.profiler`` profile records, the shared
    no-op otherwise, for one check.  ``attrs`` are kept with it, a tensor
    by its shape.  It adds no event to the profiler."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, attrs)


def spans() -> list:
    """The recorded spans (see ``_SPANS``), in the order they began."""
    return _SPANS


def clear_spans() -> None:
    """Forget the recorded spans; those still open record nothing."""
    global _gen
    with _lock:
        _SPANS.clear()
        _gen += 1


def _add_spans(path: str) -> None:
    """Append the recorded spans to the Chrome trace at ``path`` as
    complete events of one host track, on the trace's own time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = trace.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                   "args": {"name": "miraculix_tpu_torch spans"}})
    for i, (name, a, b, parent, root, attrs) in enumerate(list(_SPANS)):
        if b is not None:
            events.append({"ph": "X", "cat": "program_span", "name": name,
                           "pid": pid, "tid": 0, "ts": (a - base) / 1e3,
                           "dur": (b - a) / 1e3,
                           "args": dict(attrs, index=i, parent=parent,
                                        root=root)})
    with open(path, "w") as f:
        json.dump(trace, f, default=str)


@contextlib.contextmanager
def device_trace(dirname: Optional[str] = None) -> Iterator[None]:
    """Profile the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA activity where there is a card) and write a Chrome trace
    ``trace-<pid>-<ns>.json`` into ``dirname`` (default:
    ``miraculix_tpu_trace`` in the temporary directory), the program's
    spans of the enclosed work on a track of their own; view it in
    Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile

    if dirname is None:
        dirname = os.path.join(tempfile.gettempdir(), "miraculix_tpu_trace")
    os.makedirs(dirname, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(dirname,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof = profile(activities=acts)
    clear_spans()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        _add_spans(path)
        debug_info(f"profile written to {path}", level=0)


def check_device_memory(required_bytes: int, safety: float = 1.1, *,
                        device=None) -> bool:
    """Pre-flight free-memory guard (reference ``checkDevMemory``,
    src/cuda/cuda_utils.cu:163-186): warn when a planned allocation exceeds
    what the card reports free (``torch.cuda.mem_get_info``).  Returns True
    when the allocation looks safe.  ``device``: the card unless named; on
    the CPU, where there is no device memory to guard, the answer is True,
    as the reference's is where a device reports no memory statistics."""
    from ..geno import _device

    dev = _device(device)
    if dev.type != "cuda":
        return True
    free, total = torch.cuda.mem_get_info(dev)
    if required_bytes * safety > free:
        debug_info(
            f"requested {required_bytes / 1e9:.2f} GB exceeds free device "
            f"memory {free / 1e9:.2f} GB (total {total / 1e9:.2f} GB)",
            level=0,
        )
        return False
    return True
