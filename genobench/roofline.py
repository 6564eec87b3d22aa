"""Peaks of the card and the work a kernel launch needs, from its shapes.

A launch's bound is the least time the card could take for the work the
call needs, max(operations / compute peak, bytes / HBM peak): every packed
input byte read once, the right-hand side read once, the output written
once.  Passes, splits and padding that the implementation adds count for
nothing, so a share of the bound cannot pass 100% unless the count is
wrong: :func:`share` refuses one above 105%.
"""
from __future__ import annotations

from typing import Iterable

# Dense peaks (no sparsity) by card, from NVIDIA's data sheets: bf16 tensor
# FLOP/s, int8 tensor OP/s, HBM bytes/s.  Matched on the card's name in this
# order; the SXM part reports itself as "H100 80GB HBM3".
CARD_PEAKS = (
    (("H100 NVL",), dict(bf16=835e12, int8=1671e12, hbm=3.9e12)),
    (("H100 PCIe",), dict(bf16=756e12, int8=1513e12, hbm=2.0e12)),
    (("H100 SXM", "H100 80GB HBM3"), dict(bf16=989e12, int8=1979e12,
                                           hbm=3.35e12)),
)

SHARE_LIMIT = 105.0   # percent: a share above it is a fault in the count


def peaks(card: str) -> dict:
    """The dense peaks of the card named ``card``; another card raises."""
    for keys, p in CARD_PEAKS:
        if any(k in card for k in keys):
            return dict(p)
    raise ValueError(f"no peak table for the card {card!r}")


def words(cols: int) -> int:
    """Packed 32-bit words that hold ``cols`` genotypes (16 a word)."""
    return -(-cols // 16)


def crossprod_work(rows: int, snps: int) -> tuple[float, float]:
    """The integer GRM crossproduct Z Z^T of ``rows`` individuals over
    ``snps`` SNPs: its triangle's multiply-adds (2 operations each), the
    packed rows read once and the int32 square written once."""
    ops = float(rows) * (rows + 1) * snps
    nbytes = 4.0 * rows * words(snps) + 4.0 * rows * rows
    return ops, nbytes


def tall_work(contract: int, out: int, cols: int) -> tuple[float, float]:
    """decode(Z)^T B for B [contract, cols] float32, the output [out, cols]
    float32: 2 contract out cols operations (bf16 tensor cores), the packed
    [contract, out] genotypes, B and the output each moved once."""
    ops = 2.0 * contract * out * cols
    nbytes = (4.0 * contract * words(out) + 4.0 * contract * cols
              + 4.0 * out * cols)
    return ops, nbytes


def bound_s(ops: float, nbytes: float, op_peak: float, hbm: float) -> float:
    return max(ops / op_peak, nbytes / hbm)


def share(bounds: Iterable[float], device_s: float, what: str):
    """100 x the summed bounds over the summed device seconds of the same
    launches, or None where no launch ran; above SHARE_LIMIT raises."""
    total = sum(bounds)
    if device_s <= 0 or total <= 0:
        return None
    pct = 100.0 * total / device_s
    if pct > SHARE_LIMIT:
        raise RuntimeError(f"{what}: {pct:.4f}% of the roofline, above "
                           f"{SHARE_LIMIT}%: the work or the time is "
                           "miscounted")
    return pct
