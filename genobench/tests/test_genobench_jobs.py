"""Every cell's job against the float64 reference at a toy size on the CPU:
sound runs pass, the bfloat16 control fails, and a run with the timed path
broken underneath comes out not correct, once for each fault the cell can
have (one card: no exchange between cards to leave out)."""
import importlib

import numpy as np
import pytest
import torch

import toy
from genobench import calibrate, harness, trace

PORT = "miraculix_tpu_torch"


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


def planted(monkeypatch, module: str, fn_name: str, make):
    """Replace a function of the port wherever a module holds it."""
    fn = getattr(importlib.import_module(f"{PORT}.{module}"), fn_name)
    wrapped = make(fn)
    for mod, attr in trace.holders(fn):
        monkeypatch.setattr(mod, attr, wrapped)


def half_batch(fn):
    """Half of the columns left out and filled with the mean of the rest
    (half of the contraction rows, doubled, for one column)."""
    def broken(zq, b, center_vec=None, mode="split"):
        n = b.shape[1]
        if n == 1:
            b2 = b.clone()
            b2[1::2] = 0
            return fn(zq, 2 * b2, center_vec, mode)
        k = n // 2
        out = fn(zq, b[:, :k], center_vec, mode)
        c, v = out if isinstance(out, tuple) else (out, None)
        c = torch.cat([c, c.mean(dim=1, keepdim=True).expand(-1, n - k)], 1)
        if v is None:
            return c
        return c, torch.cat([v, v.mean().expand(n - k)])
    return broken


def crossprod_half(fn):
    def broken(zq, *a, **kw):
        return 2 * fn(zq[:, : zq.shape[1] // 2].contiguous(), *a, **kw)
    return broken


def unchanged_state(columns=None):
    """A CG that returns its start unchanged (for ``columns``-wide blocks
    only, where given)."""
    def make(fn):
        def broken(matvec, b, *a, **kw):
            width = 1 if b.dim() == 1 else b.shape[1]
            if columns is not None and width != columns:
                return fn(matvec, b, *a, **kw)
            res = fn(matvec, b, *a, **{**kw, "maxiter": 0})
            return res._replace(iterations=1)
        return broken
    return make


def altered(field, limit):
    """The entry's answer altered where it is produced: one value moved
    by 10 x the limit of its number, relative to its scale."""
    def make(fn):
        def broken(*a, **kw):
            out = fn(*a, **kw)
            if isinstance(out, torch.Tensor):            # the GRM
                out[3, 5] += 10 * limit
                return out
            x = getattr(out, field)
            if isinstance(x, torch.Tensor):
                x[0, 0] += 10 * limit * float(x[:, 0].abs().max())
            elif field == "t":
                x[0] += 10 * limit
            else:
                x[0] += 10 * limit * float(np.abs(x).max())
            return out
        return broken
    return make


def limit(name, number):
    return toy.parts(name)[2]["limits"][number]


FAULTS = {
    "many_snps.grm": [
        ("altered", ("ops.grm", "grm", altered(None, limit(
            "many_snps.grm", "grm")))),
        ("half_batch", ("ops.grm", "packed_crossprod", crossprod_half)),
    ],
    "small.gblup": [
        ("unchanged_state", ("solve.cg", "cg", unchanged_state(1))),
        ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
        ("altered", ("gblup", "gblup", altered("g_hat", limit(
            "small.gblup", "g_hat")))),
    ],
    "many_snps.gwas": [
        ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
        ("altered", ("gwas", "gwas_linear", altered("t", limit(
            "many_snps.gwas", "t")))),
    ],
    "small.solve_block32": [
        ("unchanged_state", ("solve.cg", "cg", unchanged_state())),
        ("half_batch", ("ops.dgemm", "packed_matmul_tall", half_batch)),
        ("altered", ("solve.cg", "grm_cg_solve", altered("x", limit(
            "small.solve_block32", "x")))),
    ],
}


def test_every_cell_has_faults():
    assert set(FAULTS) == set(toy.cells())


@pytest.mark.parametrize("name,fault,where", [
    (name, fault, where) for name, faults in FAULTS.items()
    for fault, where in faults])
def test_fault_is_not_correct(name, fault, where, monkeypatch):
    module, fn_name, make = where
    planted(monkeypatch, module, fn_name, make)
    result, numbers = toy.drive(name, seconds=0.2)
    assert not result["correct"], (fault, numbers)
