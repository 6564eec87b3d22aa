"""One run of one cell: set-up, a closed-loop window of jobs, the check.

The cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names its pieces,
each found by name: ``configs/<config>.json`` (the deployment: a genotype
panel, where it has ``snps``, and whatever else its jobs read),
``traffic/<traffic>.json`` (the mix: its job kind and parameters),
``jobs/<kind>.py`` (the code behind a kind, handed the configuration
whole), and ``metrics/<name>.py`` (one reader a per-layer metric).
Adding a cell, a configuration, a mix, a job kind or a metric adds files
and entries and edits none.

The loop is closed with one caller: each job is submitted when the last
has returned, and timed from its submission to its synchronized result.
The window closes when the job running at ``--seconds`` has returned;
``job_s`` is the window over the jobs completed in it.  Untraced runs
report the end-to-end metrics; traced runs (``--trace 1``) report the
per-layer ones from the profiler's trace, the spans and the launch log.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "miraculix_tpu")
GIB = float(1 << 30)


class Refused(Exception):
    """A run that must end without a result (exit code 2)."""


def started_s_ago() -> float:
    """Seconds since this process started (/proc; 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - ticks / os.sysconf("SC_CLK_TCK"))


HOST_THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def environment() -> None:
    """Fixed build and kernel-cache directories inside the checkout, and
    one thread in each host thread pool (numpy's BLAS, OpenMP, torch's CPU
    ops): the load of one process with few threads, which steadies the
    host's share of a job.  Before numpy or torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    for var in HOST_THREADS:
        os.environ[var] = "1"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, here: Path = HERE) -> tuple:
    """(workload entry, configuration, traffic mix) of the cell ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            conf = load_json(here / "configs" / f"{w['config']}.json")
            mix = load_json(here / "traffic" / f"{w['traffic']}.json")
            return w, conf, mix
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def job_kind(name: str, here: Path = HERE):
    """The module ``jobs/<name>.py``."""
    path = here / "jobs" / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no job kind {name!r} ({path})")
    return importlib.import_module(f"{here.name}.jobs.{name}")


def reader(name: str, here: Path = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{here.name}_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark refuses."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


class Run:
    """What a window leaves for the metric readers."""

    def __init__(self, jobs, window_s, launches, trace=None, launch_log=(),
                 peaks=None, dims=None):
        self.jobs = jobs                      # [{"s", "ok", counters}]
        self.window_s = window_s
        self.launches = launches              # launch counts over the window
        self.trace = trace                    # trace.DeviceTrace or None
        self.launch_log = list(launch_log)    # (launcher, shape, shape)
        self.peaks = peaks
        self._dims = dims or {}

    @property
    def completed(self) -> int:
        return sum(1 for j in self.jobs if j["ok"])

    def real_dims(self, shape) -> tuple:
        """(rows, genotype columns) of the packing whose words have
        ``shape``, without the padding."""
        return self._dims[tuple(shape)]


def packing_dims(job) -> dict:
    """(rows, genotype columns) by the word shape of each packing of the
    job's panel, its ``GenoMatrix`` ``g``; none for a job without one."""
    from miraculix_tpu_torch.geno import GenoMatrix

    g = getattr(job, "g", None)
    if not isinstance(g, GenoMatrix):
        return {}
    return {tuple(g.zq_n.shape): (g.indiv, g.snps),
            tuple(g.zq_t.shape): (g.snps, g.indiv)}


def make_job(conf: dict, mix: dict, seed: int, dev):
    """The set-up of a cell's job: ``Job(spec, traffic, seed, config,
    device)`` of ``jobs/<kind>.py`` (the contract: ``jobs/__init__.py``);
    ``spec`` is None for a configuration without ``snps``."""
    from . import genotypes

    spec = genotypes.spec_of(conf, seed, dev) if "snps" in conf else None
    return job_kind(mix["job"]).Job(spec, mix, seed, conf, dev)


def window(job, seconds: float, sync, launches_now) -> tuple:
    """The closed loop: jobs until ``seconds`` have passed and the running
    one has returned.  Returns (job records, window seconds, launches)."""
    import torch

    records, before = [], launches_now()
    t_start = time.perf_counter()
    i = 0
    with torch.profiler.record_function("genobench.window"):
        while time.perf_counter() - t_start < seconds:
            job.prepare(i)
            t0 = time.perf_counter()
            with torch.profiler.record_function("genobench.job"):
                out = job.run(i)
            dt = time.perf_counter() - t0
            rec = job.record(i, out)
            del out
            rec["s"] = dt
            records.append(rec)
            i += 1
        sync()
        window_s = time.perf_counter() - t_start
    after = launches_now()
    return records, window_s, {k: after[k] - before[k] for k in after}


def end_to_end(records, window_s: float, setup_s: float,
               peak_bytes: int) -> dict:
    ok = [r["s"] for r in records if r["ok"]]
    vals = {"setup_s": setup_s, "peak_mem_gib": peak_bytes / GIB}
    if ok:
        vals["job_s"] = window_s / len(ok)
    if len(ok) >= 2:
        vals["job_p95_s"] = statistics.quantiles(ok, n=20,
                                                 method="inclusive")[18]
    return vals


def card_power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        return _main(args)
    except Refused as e:
        print(f"genobench: {e}", file=sys.stderr)
        return 2


def _main(args) -> int:
    environment()
    import torch

    torch.set_num_threads(1)
    import miraculix_tpu_torch  # noqa: F401  (the system under test)

    bench = benchmark()
    entry, conf, mix = cell(bench, args.workload)
    chips = int(entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise Refused(f"{args.workload} needs {chips} CUDA device(s); this "
                      f"machine has {have}")
    result, numbers = drive(bench, args.workload, conf, mix, args.seed,
                            args.seconds, bool(args.trace),
                            torch.device("cuda", 0), chips)
    bad = forbidden_modules()
    if bad:
        raise Refused("modules the benchmark refuses are loaded: "
                      + ", ".join(bad))
    for n, v, lim in numbers:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def drive(bench: dict, name: str, conf: dict, mix: dict, seed: int,
          seconds: float, traced: bool, dev, chips: int = 1) -> tuple:
    """Set-up, window and check of one run on ``dev``; returns (the result
    line's object, the compared numbers).  On a CPU device (tests only)
    the port runs its plain versions and no device number is read."""
    import torch

    from miraculix_tpu_torch import _kernels
    from . import roofline, trace

    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        _kernels._load()                  # builds on a checkout's first run
    job = make_job(conf, mix, seed, dev)
    job.prepare(0)
    warm = job.run(0)                     # the warm job: every shape
    del warm

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def launches_now():
        return dict(_kernels.LAUNCHES)

    sync()
    setup_s = started_s_ago()
    dims = packing_dims(job)
    _kernels.PLAIN_CALLS.clear()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    tr, log, peaks = None, (), None
    if traced:
        if cuda:
            peaks = roofline.peaks(torch.cuda.get_device_name(dev))
            print(f"genobench: peaks {peaks}; card, power limit: "
                  f"{card_power_limit()}", file=sys.stderr)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with trace.Recorder() as rec, torch.profiler.profile(
                activities=acts) as prof:
            records, window_s, launches = window(job, seconds, sync,
                                                 launches_now)
        log = rec.launches
        tr = trace.DeviceTrace(prof)
        del prof
    else:
        records, window_s, launches = window(job, seconds, sync,
                                             launches_now)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda and sum(_kernels.PLAIN_CALLS.values()):
        raise Refused(f"plain versions ran on the card: "
                      f"{dict(_kernels.PLAIN_CALLS)}")
    run = Run(records, window_s, launches, tr, log, peaks, dims)
    if traced:
        values = {}
        for m in metrics_of(bench, name, "per_layer"):
            v = reader(m["name"])(run)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
    else:
        e2e = end_to_end(records, window_s, setup_s, peak)
        values = {m["name"]: (e2e[m["name"]], m["unit"])
                  for m in metrics_of(bench, name, "end_to_end")
                  if m["name"] in e2e}

    job.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = job.check()
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for _, v, lim in numbers),
              "attempted": len(records),
              "failed": sum(1 for r in records if not r["ok"]),
              "metrics": {k: {"value": v, "unit": u}
                          for k, (v, u) in values.items()},
              "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in numbers}
    return result, numbers
