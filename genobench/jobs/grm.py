"""The scaled VanRaden GRM of the whole panel, float32, left on the device:
``miraculix_tpu_torch.ops.grm.grm(g)``.

The check compares every job's answer through a digest taken after the
job's timer stops, G V for ``proj_cols`` standard normal columns V
(centered; ``grm_proj``: the largest gap of G V relative to the largest
entry of the reference's G V), and the last job's whole G element by
element (``grm``: the largest absolute gap), against the float64
reference.  Only the last job's G outlives the job: each job drops its
predecessor's before it starts.
"""
from __future__ import annotations

import torch

from .. import genotypes, panel, traits
from . import sync
from ..reference import grm as ref


class Job:
    def __init__(self, spec: genotypes.Spec, traffic: dict, seed: int,
                 config: dict, device: torch.device):
        from miraculix_tpu_torch.ops import grm as port_grm

        self.spec, self.traffic, self.limits = spec, traffic, traffic["limits"]
        self.entry = port_grm.grm
        self.g = panel.make(spec).geno
        dev, n = spec.device, spec.indiv
        gen = genotypes.generator(dev, seed, traits.STREAM_CHECK)
        v = torch.randn((n, traffic["proj_cols"]), generator=gen,
                        dtype=torch.float64, device=dev)
        self.v = v - v.mean(dim=0)
        self.v32 = self.v.to(torch.float32)
        self.proj = []
        self.last = None

    def prepare(self, i: int) -> None:
        self.last = None

    def run(self, i: int):
        out = self.entry(self.g)
        sync(self.spec.device)
        return out

    def record(self, i: int, out) -> dict:
        self.proj.append((out @ self.v32).cpu())
        self.last = out
        return {"ok": True}

    def release(self) -> None:
        self.g = None

    def _compare(self, proj: list, last: torch.Tensor,
                 want: torch.Tensor) -> list:
        want_proj = (want @ self.v).cpu()
        scale = float(want_proj.abs().max())
        gap_proj = max(float((p.to(torch.float64) - want_proj).abs().max())
                       for p in proj) / scale
        gap = 0.0
        for r0 in range(0, want.shape[0], 4096):     # in row blocks
            gap = max(gap, float((last[r0:r0 + 4096].to(torch.float64)
                                  - want[r0:r0 + 4096]).abs().max()))
        return [("grm", gap, self.limits["grm"]),
                ("grm_proj", gap_proj, self.limits["grm_proj"])]

    def check(self) -> list:
        return self._compare(self.proj, self.last, ref.full(self.spec))

    def control(self, jobs: int) -> list:
        """The reference delivered in bfloat16, in the program's place."""
        want = ref.full(self.spec)
        g16 = want.to(torch.bfloat16)
        proj = [(g16.to(torch.float64) @ self.v).cpu()] * jobs
        return self._compare(proj, g16, want)
