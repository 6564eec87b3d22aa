"""Toy-sized cells for the CPU tests: the cells of BENCHMARK.json with
their configurations shrunk, driven on the CPU (the port's plain
versions)."""
from __future__ import annotations

import contextlib
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from genobench import harness  # noqa: E402

CPU = torch.device("cpu")
SIZES = {"many_snps": dict(snps=8000, indiv=600),
         "small": dict(snps=6000, indiv=900)}
SEED = 2**31 + 12345


def cells() -> list:
    return [w["name"] for w in harness.benchmark()["workloads"]]


def parts(name: str) -> tuple:
    """(benchmark, configuration shrunk to its toy size, traffic mix)."""
    bench = harness.benchmark()
    entry, conf, mix = harness.cell(bench, name)
    return bench, dict(conf, **SIZES[entry["config"]]), mix


def drive(name: str, seconds: float = 0.5, traced: bool = False,
          seed: int = SEED) -> tuple:
    bench, conf, mix = parts(name)
    return harness.drive(bench, name, conf, mix, seed, seconds, traced, CPU)


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
