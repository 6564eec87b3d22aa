"""C-shaped API facade: 1:1 parity with the reference's stable "5codesAPI".

Every function mirrors one entry of src/miraculix/5codes.h:86-157 /
5codesAPI.c so that reference callers (and the reference's own tests)
translate mechanically.  State follows the reference's latch-then-call
model: ``set_options`` stores process-global options
(setOptions_compressed, 5codesAPI.c:43-70) which ``plink2compressed``
snapshots into the storage object.

The storage object replaces both the 5codes CPU container and the GPU
``GPU_gemm_storage`` (dgemm_compressed_cuda.h:87-100): packed planar16
buffers for both orientations on one device (the CUDA card unless a call
names another), plus the frequency cache.  Results come back as numpy
arrays, as the reference returns them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import geno as _geno
from .options import Options, get_global_options, set_global_options
from .ops.dgemm import dgemm as _dgemm
from .ops.sparse import sparse_times_geno
from .utils import panel_cache


def _resolve_device(device) -> torch.device:
    """``device`` (the card unless named) with a CUDA index filled in, so
    that "cuda" and "cuda:0" name one panel in the cache."""
    dev = _geno._device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _numpy(out) -> np.ndarray:
    """A result as a host numpy array (a CUDA tensor is copied back)."""
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def _returned(out, C: Optional[np.ndarray]) -> np.ndarray:
    """``out`` as numpy, written into the caller's ``C`` when given."""
    out = _numpy(out)
    if C is not None:
        C[...] = out
        return C
    return out


def set_options(
    use_gpu: int | bool = False,
    cores: int = 0,
    floatLoop: int = 0,
    meanSubstract: int = 0,
    ignore_missings: int = 1,
    do_not_center: int = 0,
    do_normalize: int = 0,
    use_miraculix_freq: int = 0,
    variant: int = 0,
    print_details: int = 0,
) -> None:
    """``setOptions_compressed`` parity (5codesAPI.c:43-70).

    ``use_gpu`` is latched and advisory, as in the reference: the device
    comes from each call's ``device=`` (the card unless named), so the
    default ``use_gpu=0`` moves no work to the CPU.  ``floatLoop`` (0 ==
    use doubles in the reference) maps to the 'fast' bf16-split kernel in
    both settings: its f32-grade accuracy already exceeds the tolerances
    the reference's double path is tested to (1e-4 relative,
    tests/dgemm_compressed/test_5codesapi.f90); callers needing float64
    grade use precision='f64' on the functional API.
    """
    set_global_options(Options(
        use_gpu=bool(use_gpu),
        cores=cores,
        precision="fast",
        mean_subtract=bool(meanSubstract),
        ignore_missings=bool(ignore_missings),
        center=not do_not_center,
        normalize=bool(do_normalize),
        use_internal_freq=bool(use_miraculix_freq),
        variant=variant,
        verbose=print_details,
    ))


def plink2compressed(
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    f: Optional[np.ndarray] = None,
    max_n: int = 0,
    *,
    device=None,
) -> _geno.GenoMatrix:
    """``plink2compressed`` parity (5codesAPI.c:80-96): preprocess raw PLINK
    bytes (header-stripped .bed payload, [ceil(indiv/4), snps]) into the
    storage object on ``device``.  ``plink_transposed`` is accepted for
    signature parity but not required — the packed transpose is derived
    internally (compressed_operations.jl:45-66 equivalent).  ``f`` overrides
    internally computed allele frequencies (external-freq mode).

    Content-hash cache: repeated ``dgemm_plink`` / ``sparse_times_plink``
    calls on the same buffer reuse the packed panel instead of re-ingesting
    (the reference's direct-PLINK kernel exists to avoid conversion cost,
    plink256.cc:54-61); the key names the device."""
    del plink_transposed, max_n  # both orientations derive from `plink`
    dev = _resolve_device(device)
    keep_missing = not get_global_options().ignore_missings
    key = ("plink", snps, indiv, keep_missing,
           panel_cache.digest_array(plink),
           None if f is None else panel_cache.digest_array(f), str(dev))
    return panel_cache.get_or_build(
        key,
        lambda: _geno.from_plink(plink, snps, indiv, freq=f,
                                 keep_missing_info=keep_missing, device=dev),
    )


def dgemm_compressed(
    trans: str,
    compressed: _geno.GenoMatrix,
    n: Optional[int] = None,
    B: np.ndarray = None,
    Ldb: int = 0,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
):
    """``dgemm_compressed`` parity (5codesAPI.c:98-110).

    trans='N': C[indiv, n] = (Z - 2·1fᵀ) B with B [snps, n];
    trans='T': C[snps, n] = (Z - 2·1fᵀ)ᵀ B.  Options (centering,
    normalization, missing handling, precision) come from the latched
    global options.  Runs on the panel's device.  If ``C`` (a numpy array)
    is given it is filled in place and returned; otherwise a new array is
    returned.
    """
    del n, Ldb, Ldc  # shapes carry the information in Python
    opts = get_global_options()
    out = _dgemm(
        compressed,
        np.asarray(B),
        trans=trans,
        center=opts.center,
        normalize=opts.normalize,
        precision=opts.precision,
        ignore_missings=opts.ignore_missings,
    )
    return _returned(out, C)


def dgemm_plink(
    trans: str,
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    f: Optional[np.ndarray],
    n: Optional[int] = None,
    B: np.ndarray = None,
    Ldb: int = 0,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
    *,
    device=None,
):
    """``dgemm_plink`` parity (5codesAPI.c:112-130): multiply straight off
    raw PLINK bytes with no separate preprocessing call.  The reference's
    AVX2 path requires indiv % 32 == 0 and no centering (f == NULL,
    5codesChar.cc:495-523); the packed panel has neither restriction —
    packing IS the conversion, cached by content."""
    obj = plink2compressed(plink, plink_transposed, snps, indiv, f=f,
                           device=device)
    opts = get_global_options()
    # full latched-option parity with dgemm_compressed: the two facade
    # entries agree under the same set_options state
    out = _dgemm(
        obj, np.asarray(B), trans=trans,
        center=opts.center and f is not None,
        normalize=opts.normalize,
        precision=opts.precision,
        ignore_missings=opts.ignore_missings,
    )
    return _returned(out, C)


def sparse_times_plink(
    transsparse: str,
    transcompressed: str,
    plink: np.ndarray,
    plink_transposed: Optional[np.ndarray],
    snps: int,
    indiv: int,
    nIdx: int,
    rowIdxB: np.ndarray,
    colIdxB: np.ndarray,
    B: np.ndarray,
    C: Optional[np.ndarray] = None,
    Ldc: int = 0,
    *,
    device=None,
):
    """``sparse_times_plink`` parity (5codesAPI.c:135-157): CSR sparse S
    [nIdx, indiv] times genotype matrix, C [nIdx, snps] = S Z (1-based CSR
    indices as the Fortran callers supply).  transcompressed='T' swaps to
    Zᵀ; transsparse='T' treats the CSR triplets as Sᵀ storage."""
    del Ldc
    obj = plink2compressed(plink, plink_transposed, snps, indiv,
                           device=device)
    out = sparse_times_geno(
        obj, rowIdxB, colIdxB, B, nIdx,
        trans_sparse=transsparse, trans_geno=transcompressed,
    )
    return _returned(out, C)


def get_compressed_freq(compressed: _geno.GenoMatrix,
                        f: Optional[np.ndarray] = None) -> np.ndarray:
    """``get_compressed_freq`` parity (5codesAPI.c:37-39)."""
    out = _numpy(compressed.freq).astype(np.float64)
    if f is not None:
        f[...] = out
        return f
    return out


def free_compressed(compressed: _geno.GenoMatrix) -> None:
    """``free_compressed`` parity (5codesAPI.c:159-161): evict the panel
    from the cache and drop every tensor it holds (both packings, both
    frequency vectors, the missing coordinates), so that their device
    memory is released now rather than at garbage collection."""
    panel_cache.evict_value(compressed)
    for name, value in list(vars(compressed).items()):
        if isinstance(value, torch.Tensor):
            setattr(compressed, name, None)
