"""GBLUP of one trait on the panel's matvecs:
``miraculix_tpu_torch.gblup.gblup(g, y_t, h2=h2_t, n_pcs=0,
covariates=C, solver="cg", tol=tol_t)``, cycling over the ``traits``
traits made at set-up (trait t: h2 = ``h2[t % len(h2)]``, ``qtl`` QTL of
one of ``qtl_sets`` sets with effects of its own, the covariates C with
effects of their own, and an intercept that the entry adds).  Many traits
make the window's work the same from seed to seed: a solve's iterations
vary with its trait.

tol: the entry's CG stops when each column's residual norm of the unscaled
system (Z_c Z_c^T + lam sigma2 I) b = rhs is at most tol, an absolute
number.  Each trait's tol_t = ``tol_rel`` x ||y_t||, so every solve stops
at the same residual relative to the trait's own scale, which float32
reaches well inside ``maxiter``.  A job whose CG did not converge counts
as failed.

The check takes one kept job of each h2, drawn from the seed, and compares
with the float64 reference ``g_hat`` (the largest gap relative to the
reference's largest |g_hat|) and the fitted values X beta + g_hat, where the
fixed effects beta enter (``fitted``: the largest gap relative to the
reference's largest |fitted|).  beta alone is no number of its own: its
gap under the bfloat16 control reads only 2.5x a sound run's (the BLUE is
a ratio of two solves with one operator, whose rounding cancels), so no
limit could separate the two.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import genotypes, panel, traits
from . import sync
from ..reference import solve as ref
from ..reference.zpass import GrmOperator, dense

F64 = torch.float64


class Job:
    def __init__(self, spec: genotypes.Spec, traffic: dict, seed: int,
                 config: dict, device: torch.device):
        from miraculix_tpu_torch import gblup as port_gblup

        self.spec, self.traffic, self.limits = spec, traffic, traffic["limits"]
        self.seed = seed
        self.entry = port_gblup.gblup
        dev, n = spec.device, spec.indiv
        sets, q = traffic["qtl_sets"], traffic["qtl"]
        idx = traits.qtl(spec.snps, sets, q, seed, dev)
        packed = panel.make(spec, columns=idx.reshape(-1).tolist())
        self.g = packed.geno
        self.cov = traits.covariates(n, traffic["covariates"], seed, dev)
        self.y = traits.phenotypes(packed.columns.view(n, sets, q),
                                   traffic["traits"], self.cov,
                                   traffic["h2"], seed)
        del packed
        self.cov_np = self.cov.cpu().numpy()
        self.y_np = list(self.y.T.cpu().numpy())
        self.tols = [traffic["tol_rel"] * float(np.linalg.norm(y))
                     for y in self.y_np]
        self.kept = {}

    def h2(self, i: int) -> float:
        t = i % self.traffic["traits"]
        return self.traffic["h2"][t % len(self.traffic["h2"])]

    def prepare(self, i: int) -> None:
        pass

    def run(self, i: int):
        t = i % self.traffic["traits"]
        out = self.entry(self.g, self.y_np[t], h2=self.h2(i), n_pcs=0,
                         covariates=self.cov_np, solver="cg",
                         tol=self.tols[t], maxiter=self.traffic["maxiter"])
        sync(self.spec.device)
        return out

    def record(self, i: int, out) -> dict:
        self.kept[i] = (out.beta, out.g_hat)
        return {"ok": bool(out.converged), "cg_iterations": out.cg_iterations}

    def release(self) -> None:
        self.g = None

    def _x(self) -> torch.Tensor:
        n = self.spec.indiv
        return torch.cat([torch.ones((n, 1), dtype=F64,
                                     device=self.spec.device), self.cov], 1)

    def _chosen(self, done: list) -> list:
        """One job of each h2 among ``done``, drawn from the seed."""
        out = []
        for k, h in enumerate(self.traffic["h2"]):
            cand = [i for i in done if self.h2(i) == h]
            if cand:
                out.append(traits.pick(cand, self.seed, k))
        return out

    def _compare(self, answers: dict, op: GrmOperator) -> list:
        x = self._x()
        gap_g = gap_f = 0.0
        for i, (beta, g_hat) in answers.items():
            t = i % self.traffic["traits"]
            want = ref.gblup(op, x, self.y[:, t], self.h2(i))
            fitted = x @ want["beta"] + want["g_hat"]
            dev = x.device
            beta = torch.as_tensor(np.asarray(beta), dtype=F64, device=dev)
            g_hat = torch.as_tensor(np.asarray(g_hat), dtype=F64,
                                    device=dev)
            gap_g = max(gap_g, float((g_hat - want["g_hat"]).abs().max()
                                     / want["g_hat"].abs().max()))
            gap_f = max(gap_f, float((x @ beta + g_hat - fitted).abs().max()
                                     / fitted.abs().max()))
        return [("g_hat", gap_g, self.limits["g_hat"]),
                ("fitted", gap_f, self.limits["fitted"])]

    def check(self) -> list:
        chosen = self._chosen(sorted(self.kept))
        return self._compare({i: self.kept[i] for i in chosen},
                             GrmOperator(dense(self.spec)))

    def control(self, jobs: int) -> list:
        """The reference with bfloat16 operands in the program's place."""
        z = dense(self.spec)
        op = GrmOperator(z, rnd=torch.bfloat16)
        x = self._x()
        answers = {}
        for i in self._chosen(list(range(jobs))):
            t = i % self.traffic["traits"]
            got = ref.gblup(op, x, self.y[:, t], self.h2(i),
                            tol_rel=self.traffic["tol_rel"],
                            maxiter=self.traffic["control_maxiter"])
            answers[i] = (got["beta"].cpu().numpy(),
                          got["g_hat"].cpu().numpy())
        return self._compare(answers, GrmOperator(z))
