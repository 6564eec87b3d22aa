"""Logging / tracing / banner utilities.

Parity with the reference's observability (SURVEY.md §5): the PRINT_LEVEL
env-gated logging (src/cuda/cuda_utils.cu:44-63), the STARTCLOCK/CLOCK
per-phase wall timers (src/miraculix/Vector.matrix.D.cc:51,89-221), the
compile banner with build info (cuda_utils.cu:65-82) and the free-memory
guard (``checkDevMemory``).  Adds a ``torch.profiler`` trace hook.  The
environment variables keep the JAX package's names
(``MIRACULIX_TPU_PRINT_LEVEL``, ``PRINT_LEVEL``).
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Dict, Iterator, List, Optional, Tuple


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
    import torch

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


@contextlib.contextmanager
def device_trace(dirname: Optional[str] = None) -> Iterator[None]:
    """Profile the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA activity where there is a card) and write a Chrome trace
    ``trace-<pid>-<ns>.json`` into ``dirname`` (default:
    ``miraculix_tpu_trace`` in the temporary directory); view it in
    Perfetto or chrome://tracing."""
    import torch
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
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        debug_info(f"profile written to {path}", level=0)


def check_device_memory(required_bytes: int, safety: float = 1.1, *,
                        device=None) -> bool:
    """Pre-flight free-memory guard (reference ``checkDevMemory``,
    src/cuda/cuda_utils.cu:163-186): warn when a planned allocation exceeds
    what the card reports free (``torch.cuda.mem_get_info``).  Returns True
    when the allocation looks safe.  ``device``: the card unless named; on
    the CPU, where there is no device memory to guard, the answer is True,
    as the reference's is where a device reports no memory statistics."""
    import torch

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
