"""Sparse matrix x compressed genotype products.

Torch twin of ``miraculix_tpu.ops.sparse`` (the reference's
``sparse_times_plink``): S is a CSR matrix [n_idx, contract] (1-based by
default, as the reference's Fortran callers supply it), and the product is
C = op(S) @ op(Z).  Two regimes, routed as the reference routes them:

- dense: S is densified on the host and C^T = op(Z)^T S^T is one packed
  product on the panel's device (the tall f32 kernel up to 128 rows of S,
  the wide kernel beyond, the exact digit kernel at ``precision="f64"``);
- segment sum (pedigree-incidence scale, n_idx in the thousands and up):
  nnz chunks gather the referenced packed rows, decode them and scatter-add
  ``v * Z[row]`` into the output with ``index_add_``, so nothing larger than
  one chunk and the [n_idx, out_cols] result is ever resident.  This is
  plain torch (XLA-side code in the reference).  On the card its f32
  atomics add in a different order on each run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geno import GenoMatrix, on_compute
from .common import decode_planar16
from .dgemm import packed_matmul, packed_matmul_f64, packed_matmul_tall


def _csr_flat(row_ptr, col_idx, vals, n_rows: int, index_base: int):
    """CSR -> flat 0-based (row_ids, col_ids, vals) numpy triplets."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64) - index_base
    col_ids = np.asarray(col_idx, dtype=np.int64) - index_base
    vals = np.asarray(vals, dtype=np.float64)
    if len(row_ptr) != n_rows + 1:
        raise ValueError(f"row_ptr must have {n_rows + 1} entries")
    row_ids = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    return row_ids, col_ids, vals


def csr_to_dense(row_ptr, col_idx, vals, n_rows: int, n_cols: int,
                 index_base: int = 1) -> np.ndarray:
    """CSR triplets -> dense float64 numpy [n_rows, n_cols]."""
    rows, cols, vals = _csr_flat(row_ptr, col_idx, vals, n_rows, index_base)
    dense = np.zeros((n_rows, n_cols), dtype=np.float64)
    np.add.at(dense, (rows, cols), vals)
    return dense


def _segsum_apply(zq: torch.Tensor, out_rows: torch.Tensor,
                  gather_rows: torch.Tensor, vals: torch.Tensor, n_idx: int,
                  chunk: int) -> torch.Tensor:
    """acc[out_rows] += vals * decode(zq[gather_rows]), f32 [n_idx, 16*kw],
    over nnz chunks of ``chunk`` entries."""
    acc = torch.zeros((n_idx, 16 * zq.shape[1]), dtype=torch.float32,
                      device=zq.device)
    for c0 in range(0, out_rows.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        d = decode_planar16(zq[gather_rows[sl]], torch.float32)
        acc.index_add_(0, out_rows[sl], d.mul_(vals[sl, None]))
    return acc


def sparse_times_geno_segsum(g: GenoMatrix, row_ptr, col_idx, vals,
                             n_idx: int, trans_sparse: str = "n",
                             trans_geno: str = "n", index_base: int = 1,
                             chunk: int = 8192) -> torch.Tensor:
    """O(nnz) gather/segment-sum evaluation of op(S) @ op(Z) (same semantics
    as :func:`sparse_times_geno`), f32 [n_idx, out_cols] on the panel's
    device.  Every index is checked on the host before any device work: an
    index out of range would kill a CUDA context."""
    g = on_compute(g)
    tg, ts = trans_geno.lower(), trans_sparse.lower()
    if tg == "n":
        contract, out_cols, zq = g.indiv, g.snps, g.zq_n
    else:
        contract, out_cols, zq = g.snps, g.indiv, g.zq_t
    csr_rows = n_idx if ts == "n" else contract
    r, c, v = _csr_flat(row_ptr, col_idx, vals, csr_rows, index_base)
    out_rows, gather_rows = (r, c) if ts == "n" else (c, r)
    if gather_rows.size and (gather_rows.max() >= contract
                             or gather_rows.min() < 0):
        raise ValueError("sparse column index exceeds the contraction axis")
    if out_rows.size and (out_rows.max() >= n_idx or out_rows.min() < 0):
        raise ValueError(
            f"sparse row index out of range for n_idx={n_idx} "
            f"(found {int(out_rows.min())}..{int(out_rows.max())}; "
            f"index_base={index_base} mismatch?)")
    dev = zq.device
    acc = _segsum_apply(
        zq, torch.as_tensor(out_rows, device=dev),
        torch.as_tensor(gather_rows, device=dev),
        torch.as_tensor(v, dtype=torch.float32, device=dev), n_idx,
        max(1, chunk))
    return acc[:, :out_cols]


def sparse_times_geno(g: GenoMatrix, row_ptr, col_idx, vals, n_idx: int,
                      trans_sparse: str = "n", trans_geno: str = "n",
                      index_base: int = 1, precision: str = "f32",
                      method: str = "auto") -> torch.Tensor:
    """C = op(S) @ op(Z) on the panel's device:

    - trans_geno='n': op(Z) = Z [indiv, snps], S maps individuals,
      C [n_idx, snps];
    - trans_geno='t': op(Z) = Z^T, S maps SNPs, C [n_idx, indiv];
    - trans_sparse='t': S is stored transposed ([contract, n_idx] CSR).

    No centering.  ``precision``: "f32" (default), "fast" (the split tier)
    or "f64" (exact digit products; S and the result stay float64).
    ``method``: "dense", "segsum" (f32 only: any other tier raises), or
    "auto", which takes segsum at n_idx > 4096 at the f32 tier only.
    Returns f32 (f64 at "f64") [n_idx, out_cols]."""
    g = on_compute(g)
    tg, ts = trans_geno.lower(), trans_sparse.lower()
    if method == "segsum" and precision != "f32":
        raise ValueError(
            f"precision={precision!r} is not available on the segsum path "
            "(f32 scatter-add accumulation only); use method='dense' to "
            "keep the requested tier, or precision='f32'")
    if method == "segsum" or (method == "auto" and n_idx > 4096
                              and precision == "f32"):
        return sparse_times_geno_segsum(
            g, row_ptr, col_idx, vals, n_idx, trans_sparse=ts,
            trans_geno=tg, index_base=index_base)
    if tg == "n":
        contract, out_cols = g.indiv, g.snps
    else:
        contract, out_cols = g.snps, g.indiv
    if ts == "n":
        st = csr_to_dense(row_ptr, col_idx, vals, n_idx, contract,
                          index_base).T                    # [contract, n_idx]
    else:
        st = csr_to_dense(row_ptr, col_idx, vals, contract, n_idx, index_base)
    # C^T = op(Z)^T S^T: the wide schedule reads the packing whose rows are
    # the output axis, the tall one the packing whose rows are the
    # contraction axis
    zq_other = g.zq_t if tg == "n" else g.zq_n
    if precision == "f64":
        return packed_matmul_f64(zq_other, st)[:out_cols].T
    stj = torch.as_tensor(st, dtype=torch.float32, device=g.device)
    zq_same = g.zq_n if tg == "n" else g.zq_t
    if precision == "f32" and n_idx <= 128 and st.shape[0] <= zq_same.shape[0]:
        return packed_matmul_tall(zq_same, stj, mode="f32")[:out_cols].T
    return packed_matmul(zq_other, stj,
                         split=precision == "fast")[:out_cols].T
