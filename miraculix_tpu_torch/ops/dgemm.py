"""dgemm_compressed: genotype matrix x dense matrix, straight off packed bits.

Torch twin of ``miraculix_tpu.ops.dgemm`` at the ``fast``, ``bf16``, ``f32``
and ``f64`` tiers.  For genotype matrix Z (indiv, snps) and frequencies f:

    trans='n':  C[indiv, n] = (Z - M) @ B,   B: [snps, n]
    trans='t':  C[snps,  n] = (Z - M)^T @ B, B: [indiv, n]

The packed product runs on one of two schedules, chosen as the reference
chooses: :func:`packed_matmul_tall` (``csrc/tall_dgemm.cu``, bf16 tensor
cores, one pass per bf16 part of B: hi + lo at the fast tier as the
reference's split, hi at bf16, hi + mid + lo at f32) for RHS of up to 64
columns at the fast tier and 128 at the bf16/f32 tiers, and
:func:`packed_matmul` (``csrc/wide_dgemm.cu``, the same bf16 passes) for
wider RHS.  Centering is
a rank-1 epilogue whose contraction-side reduction (c^T B or 1^T B) the
tall kernel fuses at the fast tier.  The f64 tier splits B into int8 digits
and runs them through the exact digit kernel (``csrc/matmul_int8.cu``) in
one launch per product; digits and recombination stay on the device in
float64 (:func:`packed_matmul_exact`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..geno import GenoMatrix, on_compute
from ..utils.logging import span
from .common import decode_planar16

TALL_LIMITS = {"fast": 64, "bf16": 128, "f32": 128}  # widest tall RHS per tier
TALL_MODES = {"fast": "split", "bf16": "bf16", "f32": "f32"}
TALL_RHS = {"split": "hilo", "bf16": "bf16", "f32": "f32"}  # B' per mode


def tall_rhs_parts(b: torch.Tensor, mode: str) -> list:
    """The bf16 parts of f32 ``b`` that the tall kernel multiplies by, one
    tensor-core pass each, every part rounded to nearest even: [hi] ("bf16"),
    [hi, lo] with lo = bf16(b - hi) ("split", the reference's
    ``_tall_split_rows``), [hi, mid, lo] with mid = bf16(b - hi) and
    lo = bf16(b - hi - mid) ("f32"; the parts sum to b exactly, f32
    subnormals aside)."""
    parts, rest = [], b.to(torch.float32)
    for _ in range(_kernels.TALL_PASSES[mode]):
        p = rest.to(torch.bfloat16)
        parts.append(p)
        rest = rest - p.to(torch.float32)    # exact: p is rest's leading bits
    return parts


def rhs_values(b: torch.Tensor, rhs: str) -> torch.Tensor:
    """The f32 RHS values a kernel instance multiplies by: B itself ("f32":
    its three bf16 parts sum to B), bf16(B) rounded to nearest even
    ("bf16"), or the sum of B's bf16 hi and lo halves ("split", "hilo": the
    reference's two passes; exact in f32)."""
    if rhs == "f32":
        return b
    hi = b.to(torch.bfloat16).to(torch.float32)
    if rhs == "bf16":
        return hi
    return hi + (b - hi).to(torch.bfloat16).to(torch.float32)


F64_BLOCK = 1 << 25   # decoded float64 elements a plain product's block holds


def _block_rows(words: torch.Tensor) -> int:
    """Packed rows of ``words`` whose float64 decode fills one block."""
    return max(1, F64_BLOCK // (16 * words.shape[1]))


def packed_matmul_tall_plain(zq_other: torch.Tensor, b: torch.Tensor,
                             center_vec=None, mode: str = "split"):
    """Plain version of :func:`packed_matmul_tall`: decode(zq)^T times the
    sum of the mode's bf16 parts of B (hi + lo in split mode, bf16(B) in
    bf16 mode, B itself in f32 mode), summed in float64 over contraction
    blocks and rounded to f32 once (a one-column f32 product would be one
    long f32 dot); v from B in f32."""
    _kernels.PLAIN_CALLS["packed_matmul_tall"] += 1
    contract = b.shape[0]
    bv = rhs_values(b, TALL_RHS[mode]).to(torch.float64)
    c = torch.zeros((16 * zq_other.shape[1], b.shape[1]),
                    dtype=torch.float64, device=b.device)
    step = _block_rows(zq_other)
    for r0 in range(0, contract, step):
        r1 = min(r0 + step, contract)
        c += decode_planar16(zq_other[r0:r1], torch.float64).T @ bv[r0:r1]
    c = c.to(torch.float32)
    if center_vec is None:
        return c
    return c, center_vec @ b


def packed_matmul_tall(zq_other: torch.Tensor, b: torch.Tensor,
                       center_vec=None, mode: str = "split"):
    """decode(zq_other)^T @ B -> f32 [16*kw, n], plus v = center_vec^T B [n]
    when ``center_vec`` [contract] is given (split mode only).

    ``zq_other`` is the packing of the OTHER orientation: its packed rows are
    the contraction axis and its decoded columns the output rows (pass zq_t
    for Z @ B, zq_n for Z^T @ B).  ``b``: [contract, n], contract <= packed
    rows.  ``mode``: "split" (the fast tier) multiplies by B's bf16 hi + lo
    (the reference's two passes, ~3e-6 relative), "bf16" by bf16(B), "f32"
    by B (three bf16 parts, exact); v = center_vec^T B is f32.  Output rows
    past the real count are zero.  CUDA tensors launch the tall kernel; CPU
    tensors take the plain version.
    """
    if mode not in TALL_MODES.values():
        raise ValueError(f"mode must be split/bf16/f32, got {mode!r}")
    if center_vec is not None and mode != "split":
        raise ValueError("center_vec fusion is a split-mode feature")
    b = b.to(torch.float32)
    cv = None if center_vec is None else center_vec.to(torch.float32)
    if not zq_other.is_cuda:
        return packed_matmul_tall_plain(zq_other, b, cv, mode)
    ct, v = _kernels.tall_dgemm(zq_other.contiguous(), b.contiguous(),
                                None if cv is None else cv.contiguous(), mode)
    return ct.T if cv is None else (ct.T, v)


def wide_rhs(n: int, split: bool, single_bf16: bool) -> str:
    """The wide kernel instance for an n-column RHS, as the reference picks
    its kernel: ``single_bf16`` -> "bf16"; ``split`` -> "split" above 64
    columns (its in-kernel split), "hilo" at 64 or fewer (its host hi||lo
    concatenation): one two-pass instance under two launch counters;
    otherwise "f32".  (The reference also cuts RHS wider
    than 512 columns into chunks for its VMEM budget; the kernel takes any
    width in one launch.)"""
    if single_bf16:
        return "bf16"
    if split:
        return "split" if n > 64 else "hilo"
    return "f32"


def packed_matmul_plain(zq: torch.Tensor, b: torch.Tensor, *,
                        split: bool = True,
                        single_bf16: bool = False) -> torch.Tensor:
    """Plain version of :func:`packed_matmul`: decode times the instance's
    RHS values, summed in float64 by row blocks and rounded to f32 once."""
    _kernels.PLAIN_CALLS["packed_matmul"] += 1
    b = b.to(torch.float32)
    bv = rhs_values(b, wide_rhs(b.shape[1], split, single_bf16)).to(
        torch.float64)
    step = _block_rows(zq)
    return torch.cat([
        decode_planar16(zq[r0:r0 + step], torch.float64)[:, :b.shape[0]] @ bv
        for r0 in range(0, zq.shape[0], step)]).to(torch.float32)


def packed_matmul(zq: torch.Tensor, b, *, split: bool = True,
                  single_bf16: bool = False,
                  per_plane: bool = True) -> torch.Tensor:
    """Raw product decode(zq) @ B_padded -> f32 [rows_pad, n].

    ``zq``: int32 planar16 [rows_pad, kw]; ``b``: [cols, n] with
    cols <= 16*kw (rows past ``cols`` count as zero).  No centering.
    ``single_bf16`` overrides ``split``: B rounded once to bf16 (~2e-3
    relative, the speed tier); ``split`` (the fast tier) multiplies by B's
    bf16 hi + lo, the reference's two passes; ``split=False`` by B (three
    bf16 parts, f32 grade).
    ``per_plane`` selects a TPU scheduling variant of the same function and
    changes nothing here.  CUDA tensors launch the wide kernel; CPU tensors
    take the plain version.
    """
    b = torch.as_tensor(b, dtype=torch.float32, device=zq.device)
    if b.dim() != 2 or b.shape[0] > 16 * zq.shape[1]:
        raise ValueError(f"B {tuple(b.shape)} does not fit packed words "
                         f"{tuple(zq.shape)}")
    if not zq.is_cuda:
        return packed_matmul_plain(zq, b, split=split,
                                   single_bf16=single_bf16)
    return _kernels.wide_dgemm(zq.contiguous(), b.contiguous(),
                               wide_rhs(b.shape[1], split, single_bf16))


INT8_PRODUCT_MAX = 192   # |genotype x digit| <= 3 * 64 in the f64 tier


def _check_int8_capacity(kw: int) -> None:
    if INT8_PRODUCT_MAX * 16 * kw >= 2 ** 31:
        raise ValueError(
            f"{16 * kw} genotype columns could overflow the exact int32 "
            "digit accumulator (limit ~11.2M SNPs); chunk the contraction "
            "(packed_matmul_exact does this automatically)")


def packed_matmul_int8_plain(zq: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_matmul_int8`: decode to float64 (exact
    below 2^53), multiply and cast to int32.  (A CPU ``int8 @ int8`` would
    wrap.)"""
    _kernels.PLAIN_CALLS["packed_matmul_int8"] += 1
    d = decode_planar16(zq, torch.float64)[:, :b.shape[0]]
    return (d @ b.to(torch.float64)).to(torch.int32)


def _matmul_int8(zq: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """decode(zq) @ D for digits ``d`` already known to be int8 values."""
    if not zq.is_cuda:
        return packed_matmul_int8_plain(zq, d)
    return _kernels.matmul_int8(zq.contiguous(),
                                d.to(torch.int8).contiguous())


def packed_matmul_int8(zq: torch.Tensor, b) -> torch.Tensor:
    """decode(zq) @ B with an integer digit RHS, exact int32 accumulation.

    ``b``: integer values in [-128, 127] (the f64 tier's digits lie in
    [-64, 64]), [cols <= 16*kw, n] in plane-major row order; rows past
    ``cols`` count as zero.  Raises where 192 * 16*kw could overflow int32.
    Returns int32 [rows, n].  CUDA tensors launch the digit kernel (B10);
    CPU tensors take the plain version."""
    _check_int8_capacity(zq.shape[1])
    b = torch.as_tensor(b, device=zq.device)
    if b.dim() != 2 or b.shape[0] > 16 * zq.shape[1] or b.shape[1] < 1:
        raise ValueError(f"digits {tuple(b.shape)} do not fit packed words "
                         f"{tuple(zq.shape)}")
    if b.dtype.is_floating_point or b.dtype.is_complex:
        raise ValueError("digits must be integers in [-128, 127]")
    if b.dtype != torch.int8 and b.numel():
        # the one read back to the host; int8 digits are in range by type
        lo, hi = (int(v) for v in torch.aminmax(b))
        if lo < -128 or hi > 127:
            raise ValueError("digits must be integers in [-128, 127]")
    return _matmul_int8(zq, b)


def packed_matmul_exact(zq: torch.Tensor, b, *, digits: int = 8,
                        as_numpy: bool = True, _kw_cap: int = 2 ** 19):
    """decode(zq) @ B to float64 grade by integer-digit splitting.

    Each column of B is scaled by a power of two into (-1/2, 1/2) and
    expanded in base 2^7 as ``digits`` int8 digits (round half to even, so
    residuals stay in [-1/2, 1/2] and digits in [-64, 64]); the digit
    matrices, stacked side by side, go through ONE exact int8 product (B10)
    and the int32 partials recombine in float64 with power-of-two weights in
    the reference's order.  Every step is exact, so the digits equal the
    reference's bit for bit; the only error is the base-2^7 truncation of B
    (~2^-(7*digits) of each column's max) plus one f64 rounding per
    addition.  All of it runs on ``zq``'s device.  Contractions whose int32
    sums could overflow (or longer than ``_kw_cap`` words, a knob for tests)
    are chunked over the packed-word axis and the f64 partials summed.
    Returns numpy float64 when ``as_numpy`` (default), else a float64
    tensor on the device."""
    rows, kw = zq.shape
    dev = zq.device
    b64 = torch.as_tensor(b, dtype=torch.float64, device=dev)
    if b64.dim() != 2 or b64.shape[0] > 16 * kw:
        raise ValueError(f"B {tuple(b64.shape)} does not fit packed words "
                         f"{tuple(zq.shape)}")
    cols, n = b64.shape
    if INT8_PRODUCT_MAX * 16 * kw >= 2 ** 31 or kw > _kw_cap:
        kw_cap = min(_kw_cap, 2 ** 19)
        acc = torch.zeros((rows, n), dtype=torch.float64, device=dev)
        for c0 in range(0, kw, kw_cap):
            c1 = min(c0 + kw_cap, kw)
            # decoded column m*kw + c of the full packing is column
            # m*(c1 - c0) + (c - c0) of the chunk's
            idx = (torch.arange(16, device=dev)[:, None] * kw
                   + torch.arange(c0, c1, device=dev)[None, :]).reshape(-1)
            bc = torch.zeros((idx.numel(), n), dtype=torch.float64,
                             device=dev)
            valid = idx < cols
            bc[valid] = b64[idx[valid]]
            acc += packed_matmul_exact(zq[:, c0:c1], bc, digits=digits,
                                       as_numpy=False, _kw_cap=kw_cap)
        return acc.cpu().numpy() if as_numpy else acc
    d, unit = exact_digits(b64, digits)
    acc = exact_recombine(_matmul_int8(zq, d), unit, digits)
    return acc.cpu().numpy() if as_numpy else acc


def exact_digits(b64: torch.Tensor, digits: int) -> tuple:
    """The digit pass's operand: float64 B [cols, n] -> (int8 digits
    [cols, digits * n], digit j of column i in column j*n + i; the float64
    unit [n] of each column's first digit).  Each column is scaled by a
    power of two into (-1/2, 1/2) and expanded in base 2^7, rounding half to
    even, so residuals stay in [-1/2, 1/2] and digits in [-64, 64]."""
    cols, n = b64.shape
    absmax = b64.abs().amax(dim=0)
    # absmax = m * 2^e with m in [0.5, 1): |b| / 2^e < 1, so |x| < 1/2
    e = torch.where(absmax > 0, torch.frexp(absmax).exponent,
                    torch.zeros((), dtype=torch.int32, device=b64.device))
    unit = 2.0 * torch.exp2(e.to(torch.float64))
    x = b64 / unit
    planes = []
    for _ in range(digits):
        d = torch.round(x * 128.0)           # half to even, as np.rint
        x = x * 128.0 - d                    # residual in [-1/2, 1/2]
        planes.append(d)
    return (torch.stack(planes, dim=1).reshape(cols, digits * n)
            .to(torch.int8), unit)


def exact_recombine(p: torch.Tensor, unit: torch.Tensor,
                    digits: int) -> torch.Tensor:
    """The digit products p int32 [rows, digits * n] -> float64 [rows, n],
    digit j weighted by unit * 128^-(j + 1), in the reference's order."""
    n = unit.shape[0]
    acc = torch.zeros((p.shape[0], n), dtype=torch.float64, device=p.device)
    for j in range(digits):
        acc += p[:, j * n:(j + 1) * n].to(torch.float64) * (
            unit * 128.0 ** -(j + 1))[None, :]
    return acc


def packed_matmul_f64(zq: torch.Tensor, b, *, as_numpy: bool = False,
                      **kw_args):
    """The ``precision='f64'`` tier: :func:`packed_matmul_exact` (float64
    tensor on the device unless ``as_numpy``)."""
    return packed_matmul_exact(zq, b, as_numpy=as_numpy, **kw_args)


def _resolve_center(center, device, dtype=torch.float32) -> tuple:
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
    return "user", torch.as_tensor(center, dtype=dtype, device=device)


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
    ``precision``: "fast" (B's bf16 hi + lo), "bf16" (B rounded once to bf16,
    ~2e-3 relative), "f32", or "f64" (exact digit products, ~1e-16
    relative).  Returns f32 [rows, n] on the panel's device; at "f64" the
    caller's B and user center are taken in float64, the whole epilogue
    runs on the device in float64, and the result is numpy float64.
    """
    with span("dgemm", trans=trans, columns=_columns(b),
              precision=precision):
        c = _dgemm(on_compute(g), b, trans, center, normalize, precision,
                   ignore_missings)
        return c.cpu().numpy() if precision == "f64" else c


def _columns(b) -> int:
    """B's columns (1 for a vector), read without converting a tensor."""
    if isinstance(b, torch.Tensor):
        return 1 if b.dim() < 2 else b.size(1)
    shape = np.shape(b)
    return shape[1] if len(shape) > 1 else 1


def _dgemm(g: GenoMatrix, b, trans: str = "n", center=True,
                 normalize: bool = False, precision: str = "fast",
                 ignore_missings: bool = True) -> torch.Tensor:
    """:func:`dgemm` on a panel whose words live on its compute device,
    the result left there (float64 at "f64"): the streamed container
    accumulates its chunks' products with it."""
    trans = trans.lower()
    if trans not in ("n", "t"):
        raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
    if precision not in ("bf16", "fast", "f32", "f64"):
        raise ValueError(f"precision must be one of bf16/fast/f32/f64, "
                         f"got {precision!r}")
    dev = g.device
    dtype = torch.float64 if precision == "f64" else torch.float32
    b = torch.as_tensor(b, dtype=dtype, device=dev)
    if b.dim() == 1:
        b = b[:, None]
    mode, user_vec = _resolve_center(center, dev, dtype)
    if trans == "n":
        zq, zq_other, rows, cols = g.zq_n, g.zq_t, g.indiv, g.snps
    else:
        zq, zq_other, rows, cols = g.zq_t, g.zq_n, g.snps, g.indiv
    if b.shape[0] != cols:
        raise ValueError(
            f"B has {b.shape[0]} rows, expected {cols} for trans='{trans}'")
    if mode == "colmeans" and g.pseudo_freq is None:
        raise ValueError("colmeans centering needs pseudo_freq")
    tall = (precision != "f64" and b.shape[1] <= TALL_LIMITS[precision]
            and b.shape[0] <= zq_other.shape[0])
    if mode != "none":
        # per-row: the center varies along the contraction axis (the
        # epilogue needs c^T B); otherwise along the output axis (1^T B)
        per_row = (mode in ("rowmeans", "user")) if trans == "n" \
            else mode == "colmeans"
        ovec = (2.0 * g.freq.to(dtype) if mode == "rowmeans"
                else 2.0 * g.pseudo_freq.to(dtype) if mode == "colmeans"
                else user_vec)
        cv = ovec if per_row else torch.ones(cols, dtype=dtype, device=dev)
    if tall and precision == "fast" and mode != "none":
        c, v = packed_matmul_tall(zq_other, b, center_vec=cv)
    else:
        if precision == "f64":
            c = packed_matmul_f64(zq, b)
        elif tall:
            c = packed_matmul_tall(zq_other, b, mode=TALL_MODES[precision])
        else:
            c = packed_matmul(zq, b, split=precision == "fast",
                              single_bf16=precision == "bf16")
        v = None if mode == "none" else cv @ b
    c = c[:rows]
    if mode != "none":
        c = c - v[None, :] if per_row else c - ovec[:rows, None] * v[None, :]
        if not ignore_missings and g.miss_rows_n is not None:
            c = _missing_correction(g, b, c, trans, mode, user_vec)
    if normalize:
        s2 = g.sigma2 if trans == "t" else g.pseudo_sigma2
        c = c / torch.sqrt(s2.to(dtype))
    return c


def _missing_correction(g: GenoMatrix, b, c, trans: str, mode: str,
                        user_vec=None):
    """A missing entry entered the packed product as genotype 0 and so
    contributed (0 - center) * B-row; add the center back at each missing
    coordinate (i, s) so that it contributes 0.  Works in ``b``'s type."""
    mi, ms = g.miss_rows_n, g.miss_cols_n
    if mode == "colmeans":
        cent = (2.0 * g.pseudo_freq.to(b.dtype))[mi]
    elif mode == "user":
        cent = user_vec[ms]
    else:
        cent = (2.0 * g.freq.to(b.dtype))[ms]
    if trans == "n":
        return c.index_add(0, mi, cent[:, None] * b[ms])
    return c.index_add(0, ms, cent[:, None] * b[mi])
