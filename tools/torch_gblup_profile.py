"""Time the GBLUP phases of miraculix_tpu_torch on one GPU, and profile two.

    python tools/torch_gblup_profile.py [--reps 5]

Simulates the many_indiv panel (65,536 SNPs x 16,384 animals, seed 0, as
``chip_smoke.py``), packs it on the card with ``from_dense``, builds the GRM
once, and calls ``gblup`` (cg) and ``gblup(solver="dense")`` ``--reps``
times each with ``chip_smoke.py``'s arguments, printing each call's seconds
(host clock around a synchronize) and the host seconds spent inside the tall
kernel's wrapper per call.  The process's first ``gblup`` (cg), before the
repeats, and one more after them run under ``torch.profiler``: the device's
busy time (the union of its kernels' intervals) against the call's wall
time, the device time by kernel, and the host entries (operators and CUDA
runtime calls) that took the most time.  The package imported is the first
on ``sys.path``: set ``PYTHONPATH`` to another tree's root to A/B two trees.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

# the repo root after PYTHONPATH's entries, so that PYTHONPATH picks the tree
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_SNPS, N_INDIV, SEED = 65536, 16384, 0


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_gblup_profile: no CUDA device", file=sys.stderr)
        return 2
    from miraculix_tpu_torch import _kernels, from_dense, gblup, grm
    from miraculix_tpu_torch.io import bed

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args().reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), f"| package {_kernels.__file__}", flush=True)
    dev = torch.device("cuda", 0)
    _kernels.build()
    geno = bed.simulate_genotypes(N_INDIV, N_SNPS, seed=SEED)
    gm = from_dense(geno, device=dev)
    y, _ = gblup.simulate_phenotypes(geno, h2=0.5, n_qtl=100, seed=SEED)
    del geno
    grm(gm)
    torch.cuda.synchronize()

    def profiled(label):
        """One gblup (cg) under torch.profiler: wall, device busy time (the
        union of its kernels' intervals), top device and host entries."""
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gblup.gblup(gm, y, h2=0.5, n_pcs=10)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -np.inf
        for s, e in spans:          # union of the kernels' intervals, in us
            if e > end:
                busy += e - max(s, end)
                end = e
        print(f"profiled {label} gblup cg: wall {wall:.4f} s, device busy "
              f"{busy / 1e6:.4f} s over {len(spans)} device events, idle "
              f"share {1 - busy / 1e6 / wall:.3f}", flush=True)
        avg = prof.key_averages()
        for ev in sorted(avg, key=lambda e: -e.device_time_total)[:6]:
            if ev.device_time_total > 0:
                print(f"  device {ev.device_time_total / 1e3:9.3f} ms "
                      f"x{ev.count:<4d} {ev.key[:70]}")
        for ev in sorted(avg, key=lambda e: -e.self_cpu_time_total)[:8]:
            print(f"  host   {ev.self_cpu_time_total / 1e3:9.3f} ms "
                  f"x{ev.count:<4d} {ev.key[:70]}")

    profiled("first")    # the process's first gblup: one-off costs show
    wrapper = _kernels.tall_dgemm
    host = []          # host seconds of each tall wrapper call

    def timed_wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = wrapper(*args, **kwargs)
        host.append(time.perf_counter() - t0)
        return out

    _kernels.tall_dgemm = timed_wrapper
    for solver in ("cg", "dense"):
        for i in range(reps):
            host.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gblup.gblup(gm, y, h2=0.5, n_pcs=10, solver=solver)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            print(f"gblup {solver} rep {i}: {secs:.4f} s; {len(host)} tall "
                  f"calls, host {1e3 * sum(host):.3f} ms in the wrapper "
                  f"(median {1e6 * statistics.median(host):.1f} us)",
                  flush=True)
    _kernels.tall_dgemm = wrapper
    profiled("warm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
