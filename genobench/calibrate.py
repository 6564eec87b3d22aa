"""The readings a cell's limits are set from, at the cell's own size.

    python3 genobench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--jobs 6]

For each seed, in one process: the cell's set-up, ``--jobs`` jobs through
the timed path (no window), and the check's numbers (the lower readings);
on the control seeds also the control, the float64 reference put in the
program's place with bfloat16 operands, against the same reference (the
upper readings).  One JSON line a seed.  The benchmark's runs never run
this; it needs the cell's cards, as a run does.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from genobench import harness  # noqa: E402


def readings(workload: str, seed: int, jobs: int, control: bool, dev
             ) -> dict:
    import torch

    bench = harness.benchmark()
    _, conf, mix = harness.cell(bench, workload)
    t0 = time.perf_counter()
    job = harness.make_job(conf, mix, seed, dev)
    for i in range(jobs):
        job.prepare(i)
        out = job.run(i)
        rec = job.record(i, out)
        del out
        if not rec["ok"]:
            print(f"seed {seed}: job {i} failed", file=sys.stderr)
    job.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    line = {"seed": seed,
            "program": {n: v for n, v, _ in job.check()}}
    if control:
        line["control"] = {n: v for n, v, _ in job.control(jobs)}
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--jobs", type=int, default=6)
    args = ap.parse_args(argv)
    harness.environment()
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("genobench: no CUDA device", file=sys.stderr)
        return 2
    from miraculix_tpu_torch import _kernels
    _kernels._load()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in args.seeds.split(","):
        line = readings(args.workload, int(s), args.jobs, int(s) in ctrl,
                        dev)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
