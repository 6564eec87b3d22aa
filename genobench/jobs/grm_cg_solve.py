"""A block solve (G + lam I) X = B on the scaled GRM:
``miraculix_tpu_torch.solve.cg.grm_cg_solve(g, B, lam=lam, scale=True,
tol=tau)``, B [indiv, ``cols``] standard normal, drawn from the seed for
each job, lam = (1 - h2) / h2.

tau is absolute on each column's residual norm; tau = ``tol_rel`` x
sqrt(indiv), the expected norm of a column of B, so every solve stops at
about the same relative residual.  A job whose residual norms are not all
within tau counts as failed.

The check keeps the answers of the jobs a Bernoulli(``keep_share``) draw
from the seed picks (at most ``check_jobs``; the last job where none is
drawn), and compares X with the float64 reference: ``x``, the largest gap
of a column relative to that column's largest |X|.
"""
from __future__ import annotations

import importlib

import torch

from .. import genotypes, panel, traits
from . import sync
from ..reference import solve as ref
from ..reference.zpass import GrmOperator, dense

MAX_DRAWS = 1 << 16


class Job:
    def __init__(self, spec: genotypes.Spec, traffic: dict, seed: int,
                 config: dict, device: torch.device):
        port_cg = importlib.import_module("miraculix_tpu_torch.solve.cg")
        self.spec, self.traffic, self.limits = spec, traffic, traffic["limits"]
        self.seed = seed
        self.entry = port_cg.grm_cg_solve
        self.g = panel.make(spec).geno
        h2 = traffic["h2"]
        self.lam = (1.0 - h2) / h2
        self.tau = traffic["tol_rel"] * spec.indiv ** 0.5
        self.keep = traits.keep_draws(MAX_DRAWS, traffic["keep_share"], seed)
        self.kept = {}
        self.last = None
        self.b = None

    def rhs(self, i: int) -> torch.Tensor:
        gen = genotypes.generator(self.spec.device, self.seed,
                                  traits.STREAM_JOB, i)
        return torch.randn((self.spec.indiv, self.traffic["cols"]),
                           generator=gen, dtype=torch.float32,
                           device=self.spec.device)

    def prepare(self, i: int) -> None:
        self.b = self.rhs(i)

    def run(self, i: int):
        out = self.entry(self.g, self.b, lam=self.lam, scale=True,
                         tol=self.tau, maxiter=self.traffic["maxiter"])
        sync(self.spec.device)
        return out

    def record(self, i: int, out) -> dict:
        if (i < MAX_DRAWS and self.keep[i]
                and len(self.kept) < self.traffic["check_jobs"]):
            self.kept[i] = out.x.cpu()
        self.last = (i, out.x)
        ok = bool(torch.all(out.residual_norm <= self.tau))
        return {"ok": ok, "cg_iterations": out.iterations}

    def release(self) -> None:
        if not self.kept and self.last is not None:
            self.kept[self.last[0]] = self.last[1].cpu()
        self.g = self.b = self.last = None

    def _compare(self, answers: dict, op: GrmOperator) -> list:
        gap = 0.0
        for i, x in answers.items():
            want = ref.block_solve(op, self.rhs(i).to(torch.float64),
                                   self.lam)
            got = x.to(device=want.device, dtype=torch.float64)
            gap = max(gap, float(((got - want).abs().amax(dim=0)
                                  / want.abs().amax(dim=0)).max()))
        return [("x", gap, self.limits["x"])]

    def check(self) -> list:
        return self._compare(self.kept, GrmOperator(dense(self.spec)))

    def control(self, jobs: int) -> list:
        """The reference with bfloat16 operands in the program's place."""
        z = dense(self.spec)
        op = GrmOperator(z, rnd=torch.bfloat16)
        answers = {}
        for i in range(min(jobs, self.traffic["check_jobs"])):
            answers[i] = ref.block_solve(
                op, self.rhs(i).to(torch.float64), self.lam,
                tol_rel=self.traffic["tol_rel"],
                maxiter=self.traffic["control_maxiter"])
        return self._compare(answers, GrmOperator(z))
