"""dgemm_compressed: genotype matrix x dense matrix, straight off packed bits.

Torch twin of ``miraculix_tpu.ops.dgemm`` at ``precision="fast"`` for RHS of
at most 64 columns.  For genotype matrix Z (indiv, snps) and frequencies f:

    trans='n':  C[indiv, n] = (Z - M) @ B,   B: [snps, n]
    trans='t':  C[snps,  n] = (Z - M)^T @ B, B: [indiv, n]

The packed product runs in :func:`packed_matmul_tall` (kernels K1/K2 of
``csrc/tall_dgemm.cu`` on CUDA tensors); centering is a rank-1 epilogue whose
contraction-side reduction (c^T B or 1^T B) the kernel fuses whenever
centering applies.
"""
from __future__ import annotations

import torch

from .. import _kernels
from ..geno import GenoMatrix
from .common import decode_planar16

TALL_LIMIT = 64  # widest RHS of the tall schedule (the reference's fast tier)


def packed_matmul_tall_plain(zq_other: torch.Tensor, b: torch.Tensor,
                             center_vec=None):
    """Plain version of :func:`packed_matmul_tall`: decode densely in f32
    and multiply."""
    contract = b.shape[0]
    d = decode_planar16(zq_other[:contract], torch.float32)
    c = d.T @ b
    if center_vec is None:
        return c
    return c, center_vec @ b


def packed_matmul_tall(zq_other: torch.Tensor, b: torch.Tensor,
                       center_vec=None):
    """decode(zq_other)^T @ B -> f32 [16*kw, n], plus v = center_vec^T B [n]
    when ``center_vec`` [contract] is given.

    ``zq_other`` is the packing of the OTHER orientation: its packed rows are
    the contraction axis and its decoded columns the output rows (pass zq_t
    for Z @ B, zq_n for Z^T @ B).  ``b``: [contract, n], contract <= packed
    rows, n <= 64.  Output rows past the real count are zero.  CUDA tensors
    launch K1 (K2 with ``center_vec``); CPU tensors take the plain version.
    """
    b = b.to(torch.float32)
    cv = None if center_vec is None else center_vec.to(torch.float32)
    if not zq_other.is_cuda:
        return packed_matmul_tall_plain(zq_other, b, cv)
    ct, v = _kernels.tall_dgemm(zq_other.contiguous(), b.contiguous(),
                                None if cv is None else cv.contiguous())
    return ct.T if cv is None else (ct.T, v)


def _resolve_center(center, device) -> tuple:
    """``center`` -> (mode, user vector): none / rowmeans / colmeans / user."""
    if center is True:
        return "rowmeans", None
    if center is False or center is None:
        return "none", None
    if isinstance(center, str):
        mode = center.lower()
        if mode in ("none", "nocentering"):
            return "none", None
        if mode in ("rowmeans", "row"):
            return "rowmeans", None
        if mode in ("colmeans", "col"):
            return "colmeans", None
        raise ValueError(f"unknown centering mode {center!r}")
    return "user", torch.as_tensor(center, dtype=torch.float32, device=device)


def dgemm(g: GenoMatrix, b, trans: str = "n", center=True,
          normalize: bool = False, precision: str = "fast",
          ignore_missings: bool = True) -> torch.Tensor:
    """The ``dgemm_compressed`` entry point with the reference's centering and
    normalization semantics.

    ``center``: True / "rowmeans" (M = 2*1*f^T), "colmeans" (M = 2*pf*1^T),
    a per-SNP vector u (M = 1*u^T), or False / "none".  ``normalize`` divides
    by sqrt(2 sum p(1-p)) over SNP frequencies for 't' and over
    per-individual pseudo-frequencies for 'n'.  ``ignore_missings=False``
    makes recorded missing entries contribute 0 to the centered product.
    Returns f32 [rows, n] on the panel's device.
    """
    trans = trans.lower()
    if trans not in ("n", "t"):
        raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
    if precision not in ("bf16", "fast", "f32", "f64"):
        raise ValueError(f"precision must be one of bf16/fast/f32/f64, "
                         f"got {precision!r}")
    if precision != "fast":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet (ROADMAP queue B: B1 "
            "bf16/f32 modes and B5 for bf16/f32, B10 and A10 for f64)")
    dev = g.device
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    if b.dim() == 1:
        b = b[:, None]
    if b.shape[1] > TALL_LIMIT:
        raise NotImplementedError(
            f"RHS of {b.shape[1]} columns: the wide schedule (> {TALL_LIMIT}) "
            "is not ported yet (ROADMAP queue B: B3/B4)")
    mode, user_vec = _resolve_center(center, dev)
    if trans == "n":
        zq_other, rows, cols = g.zq_t, g.indiv, g.snps
    else:
        zq_other, rows, cols = g.zq_n, g.snps, g.indiv
    if b.shape[0] != cols:
        raise ValueError(
            f"B has {b.shape[0]} rows, expected {cols} for trans='{trans}'")
    if mode == "colmeans" and g.pseudo_freq is None:
        raise ValueError("colmeans centering needs pseudo_freq")

    if mode == "none":
        c = packed_matmul_tall(zq_other, b)[:rows]
    else:
        # per-row: the center varies along the contraction axis (the
        # kernel reduces c^T B); otherwise along the output axis (1^T B)
        per_row = (mode in ("rowmeans", "user")) if trans == "n" \
            else mode == "colmeans"
        ovec = (2.0 * g.freq if mode == "rowmeans"
                else 2.0 * g.pseudo_freq if mode == "colmeans" else user_vec)
        cv = ovec if per_row else torch.ones(cols, dtype=torch.float32,
                                             device=dev)
        c, v = packed_matmul_tall(zq_other, b, center_vec=cv)
        c = c[:rows]
        c = c - v[None, :] if per_row else c - ovec[:rows, None] * v[None, :]
        if not ignore_missings and g.miss_rows_n is not None:
            c = _missing_correction(g, b, c, trans, mode, user_vec)
    if normalize:
        s2 = g.sigma2 if trans == "t" else g.pseudo_sigma2
        c = c / torch.sqrt(s2)
    return c


def _missing_correction(g: GenoMatrix, b, c, trans: str, mode: str,
                        user_vec=None):
    """A missing entry entered the packed product as genotype 0 and so
    contributed (0 - center) * B-row; add the center back at each missing
    coordinate (i, s) so that it contributes 0."""
    mi, ms = g.miss_rows_n, g.miss_cols_n
    if mode == "colmeans":
        cent = (2.0 * g.pseudo_freq)[mi]
    elif mode == "user":
        cent = user_vec[ms]
    else:
        cent = (2.0 * g.freq)[ms]
    if trans == "n":
        return c.index_add(0, mi, cent[:, None] * b[ms])
    return c.index_add(0, ms, cent[:, None] * b[mi])
