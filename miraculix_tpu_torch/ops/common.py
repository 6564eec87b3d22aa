"""Planar16 helpers shared by the ops: plain torch, and the row statistics'
kernel on CUDA words.

Words are held as int32 (torch has no ``>>`` for uint32 on the CPU);
``(w >> 2m) & 3`` is still the genotype of plane ``m`` for every plane,
plane 15 included, because the mask drops the sign-extended bits.
"""
from __future__ import annotations

import torch

from .. import _kernels
from ..utils.logging import span


def decode_planar16(words: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Decode planar16 words [R, W] to genotypes [R, 16*W] in natural
    (plane-major) column order: column ``m*W + w`` is word ``w``, plane ``m``."""
    return torch.cat([((words >> (2 * m)) & 3).to(dtype) for m in range(16)],
                     dim=1)


def packed_indicator2(zq: torch.Tensor) -> torch.Tensor:
    """Packed {0,1} indicator of genotype == 2: a field holding binary 10
    gives (b1 AND NOT b0) at the field's low bit."""
    return ((zq >> 1) & ~zq) & 0x55555555


def packed_row_sq_stats_plain(zq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_row_sq_stats`: 16 plane passes."""
    s1 = torch.zeros(zq.shape[0], dtype=torch.int32, device=zq.device)
    c2 = torch.zeros_like(s1)
    for m in range(16):
        plane = (zq >> (2 * m)) & 3
        s1 += plane.sum(dim=1, dtype=torch.int32)
        c2 += (plane == 2).sum(dim=1, dtype=torch.int32)
    return (s1 + 2 * c2).to(torch.float32)


def packed_row_sq_stats(zq: torch.Tensor) -> torch.Tensor:
    """Per-row sum of z^2 over a planar16 packing, exactly, as f32 [rows]:
    sum z^2 = sum z + 2 * #{z = 2} for z in {0, 1, 2}.  CUDA words launch
    ``csrc/row_sq_stats.cu`` (one read of the packing); CPU words take the
    plain version, which counts in no ``PLAIN_CALLS`` (it is no product)."""
    with span("packed_row_sq_stats"):
        if zq.is_cuda:
            return _kernels.row_sq_stats(zq.contiguous())
        return packed_row_sq_stats_plain(zq)
