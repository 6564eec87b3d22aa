"""Faults planted beneath a run: the makers that the job kinds' fault files
share, and the loader that finds a kind's faults by its name.

``faults/<kind>.py`` holds ``FAULTS``, a list of ``(fault, (module,
function, make))``: ``make(fn, mix)`` gives the broken version of the
port's ``miraculix_tpu_torch.<module>.<function>`` ``fn`` for a cell of
traffic mix ``mix``, planted wherever a module of the port holds ``fn``.
"""
from __future__ import annotations

import importlib
import importlib.util

import numpy as np
import torch

import toy
from genobench import trace

PORT = "miraculix_tpu_torch"


def faults_file(kind: str):
    return toy.HERE / "faults" / f"{kind}.py"


def faults(kind: str) -> list:
    """The ``FAULTS`` of the kind's file; none where it has no file."""
    path = faults_file(kind)
    if not path.is_file():
        return []
    spec = importlib.util.spec_from_file_location(
        f"genobench_faults_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.FAULTS)


def planted(monkeypatch, module: str, fn_name: str, make, mix: dict):
    """Replace a function of the port wherever a module holds it."""
    fn = getattr(importlib.import_module(f"{PORT}.{module}"), fn_name)
    wrapped = make(fn, mix)
    for mod, attr in trace.holders(fn):
        monkeypatch.setattr(mod, attr, wrapped)


def half_batch(fn, mix):
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


def crossprod_half(fn, mix):
    def broken(zq, *a, **kw):
        return 2 * fn(zq[:, : zq.shape[1] // 2].contiguous(), *a, **kw)
    return broken


def unchanged_state(columns=None):
    """A CG that returns its start unchanged (for ``columns``-wide blocks
    only, where given)."""
    def make(fn, mix):
        def broken(matvec, b, *a, **kw):
            width = 1 if b.dim() == 1 else b.shape[1]
            if columns is not None and width != columns:
                return fn(matvec, b, *a, **kw)
            res = fn(matvec, b, *a, **{**kw, "maxiter": 0})
            return res._replace(iterations=1)
        return broken
    return make


def altered(field, number):
    """The entry's answer altered where it is produced: one value moved
    by 10 x the limit of the cell's ``number``, relative to its scale."""
    def make(fn, mix):
        lim = mix["limits"][number]

        def broken(*a, **kw):
            out = fn(*a, **kw)
            if isinstance(out, torch.Tensor):            # the GRM
                out[3, 5] += 10 * lim
                return out
            x = getattr(out, field)
            if isinstance(x, torch.Tensor):
                x[0, 0] += 10 * lim * float(x[:, 0].abs().max())
            elif field == "t":
                x[0] += 10 * lim
            else:
                x[0] += 10 * lim * float(np.abs(x).max())
            return out
        return broken
    return make
