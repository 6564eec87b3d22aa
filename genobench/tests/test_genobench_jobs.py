"""Every cell's job against the float64 reference at a toy size on the CPU:
sound runs pass, the bfloat16 control fails, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell's
job kind can have (``faults/<kind>.py``; one card: no exchange between
cards to leave out)."""
import pytest

import faulting
import toy
from genobench import calibrate, harness


@pytest.mark.parametrize("name", toy.cells())
def test_sound_run_is_correct(name):
    result, numbers = toy.drive(name)
    assert result["correct"], numbers
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {n for n, _, _ in numbers}
    e2e = {m["name"] for m in harness.metrics_of(
        harness.benchmark(), name, "end_to_end")}
    assert {"setup_s", "job_s"} <= set(result["metrics"]) <= e2e


@pytest.mark.parametrize("name", toy.cells())
def test_control_fails_and_program_passes(name, monkeypatch):
    bench, conf, mix = toy.parts(name)
    monkeypatch.setattr(harness, "cell", lambda b, n, here=None: (
        None, conf, mix))
    line = calibrate.readings(name, toy.SEED, 3, True, toy.CPU)
    limits = mix["limits"]
    assert all(v <= limits[n] for n, v in line["program"].items()), line
    assert any(v > limits[n] for n, v in line["control"].items()), line


def test_every_configuration_has_toy_sizes():
    """Every cell's configuration has its toy size, ``sizes/<config>.json``
    (the cells without one are driven by no test)."""
    missing = sorted({str(toy.sizes_file(w["config"]))
                      for w in toy.workloads()
                      if not toy.sizes_file(w["config"]).is_file()})
    assert not missing, f"no toy-size file: {missing}"


def test_every_cell_has_faults():
    """Every cell's job kind has a faults file, ``faults/<kind>.py``, with
    at least one fault."""
    kinds = {toy.kind(w["name"]) for w in toy.workloads()}
    bare = sorted(str(faulting.faults_file(k)) for k in kinds
                  if not faulting.faults(k))
    assert not bare, f"no faults (a FAULTS list with one or more): {bare}"


@pytest.mark.parametrize("name,fault,where", [
    (name, fault, where) for name in toy.cells()
    for fault, where in faulting.faults(toy.kind(name))])
def test_fault_is_not_correct(name, fault, where, monkeypatch):
    module, fn_name, make = where
    faulting.planted(monkeypatch, module, fn_name, make, toy.parts(name)[2])
    result, numbers = toy.drive(name, seconds=0.2)
    assert not result["correct"], (fault, numbers)
