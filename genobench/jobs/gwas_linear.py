"""A linear association scan over every SNP:
``miraculix_tpu_torch.gwas.gwas_linear(g, y_t, covariates=C)``, cycling
over the ``traits`` traits made at set-up (trait t: h2 = ``h2[t % len(h2)]``,
``qtl`` QTL of one of ``qtl_sets`` sets, the covariates C with effects of
their own).

A job whose statistics are not all finite counts as failed.  The check
compares every job's answer with the float64 reference (one walk over the
panel for all traits): ``beta``, the largest gap of beta in units of the
reference's standard error; ``se``, the largest relative gap of the
standard error; ``t``, the largest absolute gap of the t statistic.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import genotypes, panel, traits
from . import sync
from ..reference import gwas as ref

F64 = torch.float64


class Job:
    def __init__(self, spec: genotypes.Spec, traffic: dict, seed: int,
                 config: dict, device: torch.device):
        from miraculix_tpu_torch import gwas as port_gwas

        self.spec, self.traffic, self.limits = spec, traffic, traffic["limits"]
        self.entry = port_gwas.gwas_linear
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
        self.kept = {}

    def prepare(self, i: int) -> None:
        pass

    def run(self, i: int):
        out = self.entry(self.g, self.y_np[i % self.traffic["traits"]],
                         covariates=self.cov_np)
        sync(self.spec.device)
        return out

    def record(self, i: int, out) -> dict:
        self.kept[i] = (out.beta, out.se, out.t)
        ok = all(bool(np.isfinite(a).all()) for a in (out.beta, out.se,
                                                      out.t))
        return {"ok": ok}

    def release(self) -> None:
        self.g = None

    def _x(self) -> torch.Tensor:
        n = self.spec.indiv
        return torch.cat([torch.ones((n, 1), dtype=F64,
                                     device=self.spec.device), self.cov], 1)

    def _compare(self, answers: dict, want: dict) -> list:
        w = {k: v.cpu().numpy() for k, v in want.items()}
        gap = {"beta": 0.0, "se": 0.0, "t": 0.0}
        for i, (beta, se, t) in answers.items():
            k = i % self.traffic["traits"]
            wb, ws, wt = w["beta"][:, k], w["se"][:, k], w["t"][:, k]
            gap["beta"] = max(gap["beta"], float(np.max(np.abs(beta - wb)
                                                        / ws)))
            gap["se"] = max(gap["se"], float(np.max(np.abs(se / ws - 1.0))))
            gap["t"] = max(gap["t"], float(np.max(np.abs(t - wt))))
        return [(k, v, self.limits[k]) for k, v in gap.items()]

    def check(self) -> list:
        want = ref.scan(self.spec, self._x(), self.y)
        return self._compare(self.kept, want)

    def control(self, jobs: int) -> list:
        """The reference with bfloat16 operands in the program's place."""
        want = ref.scan(self.spec, self._x(), self.y)
        got = ref.scan(self.spec, self._x(), self.y, rnd=torch.bfloat16)
        g = {k: v.cpu().numpy() for k, v in got.items()}
        answers = {i: tuple(g[k][:, i % self.traffic["traits"]]
                            for k in ("beta", "se", "t"))
                   for i in range(jobs)}
        return self._compare(answers, want)
