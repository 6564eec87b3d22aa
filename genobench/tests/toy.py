"""Toy-sized cells for the CPU tests: the cells of BENCHMARK.json with
their configurations shrunk, driven on the CPU (the port's plain
versions).

A configuration's toy size is the file ``sizes/<config>.json``: its
top-level keys replace the configuration's keys of the same name, a nested
block whole.  A cell whose configuration has no such file is left out of
the tests that drive cells, and ``test_every_configuration_has_toy_sizes``
names the file it lacks."""
from __future__ import annotations

import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = str(HERE.parent.parent)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from genobench import harness  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def sizes_file(config: str) -> Path:
    return HERE / "sizes" / f"{config}.json"


def workloads() -> list:
    return harness.benchmark()["workloads"]


def cells() -> list:
    """The cells whose configuration has a toy size."""
    return [w["name"] for w in workloads()
            if sizes_file(w["config"]).is_file()]


def kind(name: str) -> str:
    """The job kind of the cell ``name``."""
    return harness.cell(harness.benchmark(), name)[2]["job"]


def parts(name: str) -> tuple:
    """(benchmark, configuration shrunk to its toy size, traffic mix)."""
    bench = harness.benchmark()
    entry, conf, mix = harness.cell(bench, name)
    return bench, dict(conf, **harness.load_json(
        sizes_file(entry["config"]))), mix


def drive(name: str, seconds: float = 0.5, traced: bool = False,
          seed: int = SEED) -> tuple:
    bench, conf, mix = parts(name)
    return harness.drive(bench, name, conf, mix, seed, seconds, traced, CPU)

