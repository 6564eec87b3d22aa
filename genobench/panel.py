"""The benchmark's packer: genotypes -> the port's ``GenoMatrix``.

One walk over the units of :mod:`genobench.genotypes` fills both planar16
packings (the layout of ``miraculix_tpu_torch.io.codec``: word ``W[r, c]``
of a rows x cols matrix holds the genotypes of columns ``c + m * Kw``,
m = 0..15, at bits 2m; rows padded to 256, ``Kw = ceil(cols / 16)`` padded
to 128), the per-SNP allele frequencies and the per-individual
pseudo-frequencies, on the device, with no host copy of the panel.  A
traffic mix can ask for columns of the genotypes (QTL) on the same walk.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import genotypes

ROW_MULT = 256   # packed rows pad to this (GenoMatrix's default)
LANE = 128       # the packed word axis pads to this


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def dims(rows: int, cols: int) -> tuple[int, int]:
    """(padded rows, words a row) of a rows x cols planar16 packing."""
    return round_up(rows, ROW_MULT), round_up(max(-(-cols // 16), 1), LANE)


def shifted(g: torch.Tensor, plane: int) -> torch.Tensor:
    """int32 ``g << 2 * plane`` with the bit pattern of the unsigned word
    (plane 15 sets the sign bit)."""
    w = g.to(torch.int64) << (2 * plane)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def pack_rows(g: torch.Tensor, kw: int) -> torch.Tensor:
    """planar16 words int32 [rows, kw] of genotypes ``g`` [rows, cols]."""
    rows, cols = g.shape
    full = torch.zeros((rows, 16 * kw), dtype=torch.int8, device=g.device)
    full[:, :cols] = g
    planes = full.view(rows, 16, kw)
    w = torch.zeros((rows, kw), dtype=torch.int32, device=g.device)
    for m in range(16):
        w |= shifted(planes[:, m], m)
    return w


class Packed:
    """The result of one walk: the port's panel and the columns asked for."""

    def __init__(self, geno, columns: Optional[torch.Tensor]):
        self.geno = geno
        self.columns = columns


def make(spec: genotypes.Spec,
         columns: Optional[Sequence[int]] = None) -> Packed:
    """Pack the panel of ``spec`` into a ``GenoMatrix`` on its device; with
    ``columns``, also gather those SNPs' genotypes (int8 [indiv, k])."""
    from miraculix_tpu_torch.geno import GenoMatrix

    dev, n, s = spec.device, spec.indiv, spec.snps
    ipad, kws = dims(n, s)
    spad, kwi = dims(s, n)
    zq_n = torch.zeros((ipad, kws), dtype=torch.int32, device=dev)
    zq_t = torch.zeros((spad, kwi), dtype=torch.int32, device=dev)
    snp_sum = torch.zeros(s, dtype=torch.int64, device=dev)
    indiv_sum = torch.zeros(n, dtype=torch.int64, device=dev)
    cols = None
    if columns is not None:
        idx = torch.as_tensor(list(columns), dtype=torch.int64, device=dev)
        cols = torch.empty((n, idx.numel()), dtype=torch.int8, device=dev)
    for r0, r1, g in genotypes.units(spec):
        zq_n[r0:r1] = pack_rows(g, kws)
        snp_sum += g.sum(dim=0, dtype=torch.int64)
        indiv_sum[r0:r1] = g.sum(dim=1, dtype=torch.int64)
        if cols is not None:
            cols[r0:r1] = g[:, idx]
        # zq_t: individual r is word r % kwi, plane r // kwi of SNP row s
        for plane in range(r0 // kwi, (r1 - 1) // kwi + 1):
            a, b = max(r0, plane * kwi), min(r1, (plane + 1) * kwi)
            seg = g[a - r0:b - r0].T.contiguous()
            zq_t[:s, a - plane * kwi:b - plane * kwi] |= shifted(seg, plane)
        del g
    freq = (snp_sum.to(torch.float64) / (2.0 * n)).to(torch.float32)
    pseudo = (indiv_sum.to(torch.float64) / (2.0 * s)).to(torch.float32)
    geno = GenoMatrix(snps=s, indiv=n, zq_n=zq_n, zq_t=zq_t, freq=freq,
                      pseudo_freq=pseudo)
    return Packed(geno, cols)
