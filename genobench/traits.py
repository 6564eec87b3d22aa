"""Inputs that traffic mixes draw from the seed on the device: QTL,
covariates, phenotypes, and the sample of jobs whose answers are kept."""
from __future__ import annotations

import torch

from .genotypes import generator

STREAM_QTL = 11
STREAM_COV = 12
STREAM_TRAIT = 13
STREAM_KEEP = 14
STREAM_CHECK = 15
STREAM_JOB = 16

F64 = torch.float64


def qtl(snps: int, sets: int, per_set: int, seed: int, device
        ) -> torch.Tensor:
    """``sets`` x ``per_set`` distinct SNP indices (int64)."""
    gen = generator(device, seed, STREAM_QTL)
    idx = torch.randperm(snps, generator=gen, device=device)
    return idx[:sets * per_set].reshape(sets, per_set)


def covariates(indiv: int, k: int, seed: int, device) -> torch.Tensor:
    """Standard normal covariates, float64 [indiv, k]."""
    gen = generator(device, seed, STREAM_COV)
    return torch.randn((indiv, k), generator=gen, dtype=F64, device=device)


def phenotypes(qtl_genotypes: torch.Tensor, traits: int, cov: torch.Tensor,
               h2: list, seed: int) -> torch.Tensor:
    """``traits`` traits on the QTL sets (int8 [indiv, sets, per_set]):
    trait t has h2 = ``h2[t % len(h2)]`` and QTL set
    ``(t // len(h2)) % sets``, and y = mu + cov b + g + e, g the centered
    QTL genotypes times standard normal effects of its own, scaled to
    variance 1, e normal with variance (1 - h2) / h2, mu and b standard
    normal.  float64 [indiv, traits]."""
    n, sets, q = qtl_genotypes.shape
    dev = cov.device
    gen = generator(dev, seed, STREAM_TRAIT)
    eff = torch.randn((traits, q), generator=gen, dtype=F64, device=dev)
    mu = torch.randn(traits, generator=gen, dtype=F64, device=dev)
    b = torch.randn((cov.shape[1], traits), generator=gen, dtype=F64,
                    device=dev)
    e = torch.randn((n, traits), generator=gen, dtype=F64, device=dev)
    g = torch.empty((n, traits), dtype=F64, device=dev)
    for s in range(sets):
        mine = [t for t in range(traits) if (t // len(h2)) % sets == s]
        if mine:
            z = qtl_genotypes[:, s].to(F64)
            g[:, mine] = (z - z.mean(dim=0)) @ eff[mine].T
    g = (g - g.mean(dim=0)) / g.std(dim=0)
    sd_e = torch.tensor([((1.0 - h2[k % len(h2)]) / h2[k % len(h2)]) ** 0.5
                         for k in range(traits)], dtype=F64, device=dev)
    return mu[None, :] + cov @ b + g + e * sd_e[None, :]


def keep_draws(count: int, share: float, seed: int) -> list:
    """Which of the first ``count`` jobs keep their answers for the check:
    a Bernoulli(``share``) draw from the seed for each (on the host)."""
    gen = generator(torch.device("cpu"), seed, STREAM_KEEP)
    return (torch.rand(count, generator=gen) < share).tolist()


def pick(candidates: list, seed: int, stream: int) -> int:
    """One of ``candidates``, drawn from the seed."""
    gen = generator(torch.device("cpu"), seed, STREAM_CHECK, stream)
    return candidates[int(torch.randint(len(candidates), (1,),
                                        generator=gen))]
