"""Genotype panels made on the device from a seed, in plain torch.

A panel is ``indiv`` x ``snps`` genotypes in {0, 1, 2}, as PLINK
``--simulate`` makes them: every SNP has its own allele frequency p, drawn
from the configuration's law, every genotype is Binomial(2, p) (Hardy-
Weinberg), SNPs are independent (no LD) and no call is missing.

The panel is made in units of rows (individuals), each from its own
generator seeded by (seed, unit), so any consumer can walk the units in
order and see the same genotypes: the packer at set-up, and the plain
reference, which makes them again after the window.  This module imports
nothing but torch: the reference builds on it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

_MASK64 = (1 << 64) - 1
UNIT_ELEMENTS = 1 << 27   # genotypes a unit holds, about (128M int8)
UNIT_ALIGN = 128          # a unit's rows are a multiple of this


def mix(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64 over each in turn)."""
    x = 0x9E3779B97F4A7C15
    for w in words:
        x = (x ^ (int(w) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        x = z ^ (z >> 31)
    return x >> 1


def generator(device: torch.device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded by ``mix(*words)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(*words))
    return gen


STREAM_FREQ = 1
STREAM_UNIT = 2


@dataclasses.dataclass(frozen=True)
class Spec:
    """What fixes a panel: its shape, the allele-frequency law (p uniform on
    [p_lo, p_hi]), the seed, and the device it is made on."""
    snps: int
    indiv: int
    seed: int
    p_lo: float
    p_hi: float
    device: torch.device

    @property
    def unit_rows(self) -> int:
        rows = UNIT_ELEMENTS // max(self.snps, 1) // UNIT_ALIGN * UNIT_ALIGN
        return max(UNIT_ALIGN, rows)


def spec_of(config: dict, seed: int, device) -> Spec:
    """The panel of a configuration file (``snps``, ``indiv`` and the
    ``allele_freq`` law) at ``seed``."""
    law = config["allele_freq"]
    if law.get("law") != "uniform":
        raise ValueError(f"unknown allele-frequency law {law!r}")
    return Spec(snps=int(config["snps"]), indiv=int(config["indiv"]),
                seed=int(seed), p_lo=float(law["low"]),
                p_hi=float(law["high"]), device=torch.device(device))


def allele_p(spec: Spec) -> torch.Tensor:
    """Each SNP's allele frequency p (float64 [snps]) under the law."""
    gen = generator(spec.device, spec.seed, STREAM_FREQ)
    u = torch.rand(spec.snps, generator=gen, dtype=torch.float64,
                   device=spec.device)
    return spec.p_lo + (spec.p_hi - spec.p_lo) * u


def thresholds(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int32 thresholds on a 31-bit uniform u: genotype = (u >= t0) +
    (u >= t1), so P(0) = (1 - p)^2 and P(2) = p^2 (to 2^-31)."""
    scale = float(1 << 31)
    t0 = torch.floor((1.0 - p) ** 2 * scale).to(torch.int32)
    t1 = torch.floor((1.0 - p * p) * scale).to(torch.int32)
    return t0, t1


def units(spec: Spec) -> Iterator[tuple[int, int, torch.Tensor]]:
    """(r0, r1, genotypes int8 [r1 - r0, snps]) for each unit of rows, in
    order; each unit is drawn by one generator call."""
    t0, t1 = thresholds(allele_p(spec))
    step = spec.unit_rows
    for k, r0 in enumerate(range(0, spec.indiv, step)):
        r1 = min(r0 + step, spec.indiv)
        gen = generator(spec.device, spec.seed, STREAM_UNIT, k)
        u = torch.randint(0, 1 << 31, (r1 - r0, spec.snps), generator=gen,
                          dtype=torch.int32, device=spec.device)
        g = (u >= t0).to(torch.int8)
        g += (u >= t1).to(torch.int8)
        del u
        yield r0, r1, g
