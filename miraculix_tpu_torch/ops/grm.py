"""Crossproducts, the GRM family and the LD family.

Torch twin of ``miraculix_tpu.ops.grm``.  The packed crossproducts run in the
kernels of ``csrc/crossprod.cu`` (K3 on the upper tile pairs; B8 on a
rectangular grid; B12 on the masked grid) and ``csrc/crossprod_weighted.cu``
(B9) for CUDA tensors; CPU tensors take the plain versions.

- GRM (VanRaden, the Schlather decomposition):
      M -= (m 1^T + 1 m^T) / n;  M += (sum m) / n^2;  M /= 2 sum p(1-p)
  with m = M 1 the row sums of the raw integer crossproduct.
- LD correlation r:  M -= 4n f f^T;  M /= sigma sigma^T, sigma = sqrt(diag M).
- Missing genotypes (panels that record them): each missing entry is made to
  contribute exactly 0 to the centered product (mean imputation): exact
  centering by 2f, plus the add-back matrix D (2f_s at each missing
  coordinate) through ``ops/sparse`` (D Z^T) and a host scipy D D^T.
- Banded LD (``ld_windowed``, ``ld_score``, ``ld_prune``): one rectangular
  product per row block of the SNP-major packing against the block plus its
  window, centered, gathered to the band and divided on the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _kernels
from ..geno import (ROW_MULT, GenoMatrix, _device, _words, from_dense,
                    on_compute)
from ..io import bed, codec, native
from ..utils.logging import span
from .common import decode_planar16, packed_row_sq_stats
from .dgemm import dgemm
from .sparse import sparse_times_geno


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.float64)


def _np(dtype: torch.dtype):
    """The numpy type of a torch floating type."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _check_capacity(kw: int) -> None:
    if 4 * 16 * kw >= 2 ** 31:
        raise ValueError(
            f"{16 * kw} packed SNP columns could overflow the exact int32 "
            "accumulator (limit ~536M); chunk the SNP axis and sum partials")


def packed_crossprod_plain(zq: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_crossprod`: decode to float64 (exact
    below 2^53) and multiply."""
    _kernels.PLAIN_CALLS["packed_crossprod"] += 1
    _check_capacity(zq.shape[1])
    d = decode_planar16(zq, torch.float64)
    return (d @ d.T).to(torch.int32)


def _mirror_merge(w: torch.Tensor, tile: int) -> torch.Tensor:
    """An entry was computed iff its tile touches or lies above the
    diagonal; every other entry is its mirror's (the reference's merge)."""
    blk = torch.arange(w.shape[0], device=w.device) // tile * tile
    computed = (blk[None, :] + tile) > blk[:, None]
    return torch.where(computed, w, w.T)


def packed_crossprod(zq: torch.Tensor, triangle: bool = True,
                     wrap: bool = True) -> torch.Tensor:
    """Raw integer crossproduct decode(zq) decode(zq)^T -> int32 [rows, rows],
    exact while 4*snps < 2^31.  CUDA tensors launch K3 (the upper tile
    pairs, mirrored in the kernel); ``triangle=False`` the rectangular
    kernel B8 on (zq, zq); ``wrap=False`` the masked-grid kernel B12 and the
    mirror merge.  CPU tensors take the plain version."""
    _check_capacity(zq.shape[1])
    if not zq.is_cuda:
        return packed_crossprod_plain(zq)
    zq = zq.contiguous()
    if not triangle:
        return _kernels.crossprod_rect(zq, zq)
    if not wrap:
        return _mirror_merge(_kernels.crossprod_tri(zq),
                             _kernels.crossprod_tile())
    return _kernels.crossprod(zq)


def _check_rect(zq_a: torch.Tensor, zq_b: torch.Tensor) -> None:
    if zq_a.shape[1] != zq_b.shape[1]:
        raise ValueError("packed K widths differ")
    _check_capacity(zq_a.shape[1])


def packed_crossprod_rect_plain(zq_a: torch.Tensor,
                                zq_b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`packed_crossprod_rect` (float64 decode)."""
    _kernels.PLAIN_CALLS["packed_crossprod_rect"] += 1
    _check_rect(zq_a, zq_b)
    da = decode_planar16(zq_a, torch.float64)
    db = decode_planar16(zq_b, torch.float64)
    return (da @ db.T).to(torch.int32)


def packed_crossprod_rect(zq_a: torch.Tensor,
                          zq_b: torch.Tensor) -> torch.Tensor:
    """Rectangular integer crossproduct decode(zq_a) decode(zq_b)^T -> int32
    [rows_a, rows_b], exact.  CUDA tensors launch B8."""
    _check_rect(zq_a, zq_b)
    if not zq_a.is_cuda:
        return packed_crossprod_rect_plain(zq_a, zq_b)
    return _kernels.crossprod_rect(zq_a.contiguous(), zq_b.contiguous())


def _weights(w, kw: int, device) -> torch.Tensor:
    """Per-SNP weights [<= 16*kw] -> f32 [16, kw] plane-major, 0 past them."""
    w = torch.as_tensor(w, device=device).to(torch.float32)
    if w.dim() != 1 or w.shape[0] > 16 * kw:
        raise ValueError(f"w must be 1-D with <= {16 * kw} entries")
    wmat = torch.zeros(16 * kw, dtype=torch.float32, device=device)
    wmat[: w.shape[0]] = w
    return wmat.reshape(16, kw)


def packed_crossprod_weighted_plain(zq: torch.Tensor, w) -> torch.Tensor:
    """Plain version of :func:`packed_crossprod_weighted`: (d w) d^T in
    float64, cast to f32."""
    _kernels.PLAIN_CALLS["packed_crossprod_weighted"] += 1
    wmat = _weights(w, zq.shape[1], zq.device).to(torch.float64)
    d = decode_planar16(zq, torch.float64)
    return ((d * wmat.reshape(1, -1)) @ d.T).to(torch.float32)


def packed_crossprod_weighted(zq: torch.Tensor, w,
                              triangle: bool = True) -> torch.Tensor:
    """Per-SNP-weighted crossproduct decode(zq) diag(w) decode(zq)^T -> f32
    [rows, rows] at f32 grade.  ``w``: [snps] (or up to [16*kw]) weights in
    natural SNP order; padded SNPs get weight 0.  CUDA tensors launch B9 on
    the upper tile pairs with its mirror (``triangle=False``: every tile):
    w is split into three bf16 digits by bit masking, as the reference
    splits w*z (they sum to w exactly), and each digit is one bf16
    tensor-core pass whose products z_i * z_j * h_d are exact; each digit's
    sum runs from zero over one 32-word stage and is added, smallest digit
    first, to f32 totals."""
    if not zq.is_cuda:
        return packed_crossprod_weighted_plain(zq, w)
    return _kernels.crossprod_weighted(
        zq.contiguous(), _weights(w, zq.shape[1], zq.device), triangle)


def called_indicator_packing(g: GenoMatrix, use=None) -> torch.Tensor:
    """Planar16 packing (int32 words on the panel's device) of the CALLED
    indicator: 1 where the genotype was observed, 0 at missing entries, at
    row/column padding and at SNPs excluded by the boolean mask ``use``.
    Its crossproduct is the pairwise non-missing count matrix."""
    g = on_compute(g)
    ipad, kw = g.zq_n.shape
    n, snps = g.indiv, g.snps
    valid = (np.arange(16)[:, None] * kw + np.arange(kw)[None, :]) < snps
    if use is not None:
        use = np.asarray(use, bool)
        if use.shape[0] != snps:
            raise ValueError(f"use mask has {use.shape[0]} entries for "
                             f"{snps} SNPs")
        upad = np.zeros(16 * kw, bool)
        upad[:snps] = use
        valid = valid & upad.reshape(16, kw)
    word = (valid.astype(np.uint64)
            << (2 * np.arange(16, dtype=np.uint64))[:, None]).sum(
        axis=0).astype(np.uint32)
    arr = np.zeros((ipad, kw), np.uint32)
    arr[:n] = word[None, :]
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        mi = g.miss_rows_n.cpu().numpy()
        ms = g.miss_cols_n.cpu().numpy()
        masks = ~(np.uint32(1) << (2 * (ms // kw)).astype(np.uint32))
        np.bitwise_and.at(arr, (mi, ms % kw), masks.astype(np.uint32))
    return _words(arr).to(g.device)


def pairwise_nonmissing(g: GenoMatrix, use=None) -> torch.Tensor:
    """Pairwise non-missing SNP counts N[i, j] = #{s: called in both i and j
    (and use[s])}, exact int32 [indiv, indiv]: one crossproduct (K3) of the
    called-indicator packing."""
    g = on_compute(g)
    ind = called_indicator_packing(g, use=use)
    return packed_crossprod(ind)[: g.indiv, : g.indiv]


def snp_crossprod(g: GenoMatrix, snpmajor_output: bool = False) -> torch.Tensor:
    """M = Z Z^T [indiv, indiv] (GRM direction), or Z^T Z [snps, snps] with
    ``snpmajor_output=True`` (LD direction); int32."""
    g = on_compute(g)
    if snpmajor_output:
        return packed_crossprod(g.zq_t)[: g.snps, : g.snps]
    return packed_crossprod(g.zq_n)[: g.indiv, : g.indiv]


def _resolve_missing(g: GenoMatrix, correct_missing) -> bool:
    """``correct_missing`` defaulted, as in the reference, to whether the
    panel tracks missing entries; True on an untracked panel raises."""
    if correct_missing is None:
        correct_missing = g.miss_rows_n is not None
    if correct_missing and g.miss_rows_n is None:
        raise ValueError("correct_missing requires a panel built with "
                         "keep_missing_info=True")
    return correct_missing


def _missing_d_csr(g: GenoMatrix):
    """The add-back matrix D of the missing genotypes: D[i, s] = 2f_s at each
    recorded missing coordinate (a missing entry was packed as 0, and
    centering left -2f_s there; Zc + D makes it contribute 0).  Returns the
    1-based CSR of D (host numpy), d2[i] = (D 2f)[i], and the coordinates
    (mi, ms) sorted by individual."""
    mi = g.miss_rows_n.cpu().numpy().astype(np.int64)
    ms = g.miss_cols_n.cpu().numpy().astype(np.int64)
    f = _host(g.freq)
    order = np.argsort(mi, kind="stable")
    mi, ms = mi[order], ms[order]
    w = 2.0 * f[ms]
    ia = np.concatenate([[0], np.cumsum(np.bincount(mi,
                                                    minlength=g.indiv))]) + 1
    d2 = np.zeros(g.indiv)
    np.add.at(d2, mi, w * 2.0 * f[ms])
    return ia, ms + 1, w, d2, (mi, ms)


def _ddt_dense(rows, cols, w, n_rows: int, n_cols: int, w2=None,
               dtype=np.float64) -> np.ndarray:
    """D1 D2^T as a dense host [n_rows, n_rows] array of ``dtype`` (scipy;
    D1 has entries ``w`` and D2 ``w2``, by default ``w``, at (rows, cols)).
    nnz is the number of missing entries, so this is cheap at realistic
    missing rates.  The product is formed in float64 and each entry cast
    once."""
    from scipy import sparse

    d1 = sparse.csr_matrix((w, (rows, cols)), shape=(n_rows, n_cols))
    d2 = d1 if w2 is None else sparse.csr_matrix((w2, (rows, cols)),
                                                 shape=(n_rows, n_cols))
    return (d1 @ d2.T).astype(dtype).toarray()


def _add_sym(m: torch.Tensor, a: torch.Tensor, dense: np.ndarray) -> None:
    """m += a + a^T + dense, in place and in that order (the reference's
    order of operations; at 16K animals every temporary is another GB)."""
    m.add_(a).add_(a.T).add_(torch.from_numpy(dense).to(m.device))


def grm(g: GenoMatrix, scale: bool = True, dtype=torch.float32,
        correct_missing: Optional[bool] = None,
        pair_denominator: bool = False) -> torch.Tensor:
    """VanRaden genomic relationship matrix [indiv, indiv] via the Schlather
    decomposition.

    ``correct_missing`` (default: on when the panel carries missing
    information) makes each missing entry contribute exactly 0: exact
    centering by 2f, Zc Zc^T = Z Z^T - u 1^T - 1 u^T + 4 sum f^2 with
    u = Z (2f), plus (D Zc^T) + (D Zc^T)^T + D D^T for the add-back D.
    ``pair_denominator`` (plink --make-rel missingness) divides each pair by
    its own sum of 2pq over the SNPs called in both (one weighted
    crossproduct of the called-indicator packing, B9) instead of the global
    2 sum p(1-p); it needs missing info, implies the correction and ignores
    ``scale``; pairs sharing no called SNP come back 0."""
    with span("grm"):
        g = on_compute(g)
        with span("grm.crossprod"):
            m = snp_crossprod(g).to(dtype)
        with span("grm.finish"):
            return _grm_finish(g, m, scale, dtype, correct_missing,
                               pair_denominator)


def _grm_finish(g: GenoMatrix, m: torch.Tensor, scale: bool, dtype,
                correct_missing, pair_denominator: bool) -> torch.Tensor:
    """The GRM from the raw crossproduct ``m``, in place: centered (with
    the missing entries' correction where asked), then scaled."""
    n = g.indiv
    if pair_denominator:
        if g.miss_rows_n is None:
            raise ValueError("pair_denominator requires a panel built with "
                             "keep_missing_info=True")
        correct_missing = True
    if _resolve_missing(g, correct_missing):
        f = g.freq.to(dtype)
        u = dgemm(g, 2.0 * g.freq[:, None], trans="n", center=False,
                  precision="f32")[:n, 0].to(dtype)
        # in place, in the reference's order of operations
        m.sub_(u[None, :]).sub_(u[:, None]).add_(4.0 * torch.sum(f * f))
        ia, ja, w, d2, (mi, ms) = _missing_d_csr(g)
        a = sparse_times_geno(g, ia, ja, w, n, trans_geno="t",
                              precision="f32").to(dtype)      # D Z^T
        a.sub_(torch.as_tensor(d2, dtype=dtype, device=a.device)[:, None])
        _add_sym(m, a, _ddt_dense(mi, ms, w, n, g.snps, dtype=_np(dtype)))
        del a
    else:
        colsum = m.sum(dim=1)
        total = colsum.sum()
        # in place (same order of operations as the reference): at 16K
        # animals each temporary would be another GB of device memory
        m.sub_(colsum[None, :] / n).sub_(colsum[:, None] / n).add_(
            total / (n * n))
    if pair_denominator:
        f32 = g.freq.to(torch.float32)
        denom = packed_crossprod_weighted(
            called_indicator_packing(g), 2.0 * f32 * (1.0 - f32))[:n, :n]
        m.div_(torch.clamp(denom, min=1e-30).to(dtype))
        return m.masked_fill_(denom <= 0, 0.0)
    if scale:
        m.div_(g.sigma2.to(dtype))
    return m


def _ld_finish(m: torch.Tensor, squared: bool) -> torch.Tensor:
    """Divide a centered SNP crossproduct by sigma sigma^T in place, sigma
    the root of its clamped diagonal (1 where that is 0: monomorphic SNPs
    give 0 rows, not NaN)."""
    diag = torch.clamp(torch.diagonal(m), min=0.0)
    sigma = torch.where(diag > 0, torch.sqrt(diag), torch.ones_like(diag))
    m.div_(sigma[:, None]).div_(sigma[None, :])
    return m.mul_(m) if squared else m


def ld(g: GenoMatrix, dtype=torch.float32, squared: bool = False,
       correct_missing: Optional[bool] = None) -> torch.Tensor:
    """LD matrix: the centered SNP-SNP correlation r of allele counts
    [snps, snps] (r^2 with ``squared``), from one K3 crossproduct of the
    SNP-major packing; finished in place (at 16K SNPs every temporary is
    another GB).  ``correct_missing`` (default: on when the panel carries
    missing information) centers exactly by 2f and adds the missing
    entries' add-back D, so the crossproduct is (Zc + D)^T (Zc + D) and the
    diagonal an exact variance."""
    g = on_compute(g)
    n = g.indiv
    m = snp_crossprod(g, snpmajor_output=True).to(dtype)
    f = g.freq.to(dtype)
    if not _resolve_missing(g, correct_missing):
        m.addr_((4.0 * n) * f, f, alpha=-1.0)   # M -= 4n f f^T, no temporary
        return _ld_finish(m, squared)
    # Zc^T Zc = Z^T Z - (2f) s^T - s (2f)^T + 4n f f^T, s = Z^T 1
    s = g.snp_sums().to(dtype)
    m.addr_(2.0 * f, s, alpha=-1.0).addr_(s, 2.0 * f, alpha=-1.0)
    m.addr_((4.0 * n) * f, f)
    _, _, w, _, (mi, ms) = _missing_d_csr(g)
    # D^T Zc = D^T Z - (D^T 1)(2f)^T; the CSR of D^T grouped by SNP
    order = np.argsort(ms, kind="stable")
    mi_s, ms_s = mi[order], ms[order]
    w_s = 2.0 * _host(g.freq)[ms_s]
    ia_t = np.concatenate(
        [[0], np.cumsum(np.bincount(ms_s, minlength=g.snps))]) + 1
    a = sparse_times_geno(g, ia_t, mi_s + 1, w_s, g.snps, trans_geno="n",
                          precision="f32").to(dtype)          # D^T Z
    colsum_d = torch.as_tensor(np.bincount(ms, weights=w, minlength=g.snps),
                               dtype=dtype, device=a.device)
    a.addr_(colsum_d, 2.0 * f, alpha=-1.0)
    _add_sym(m, a, _ddt_dense(ms, mi, w, g.snps, n, dtype=_np(dtype)))
    del a
    return _ld_finish(m, squared)


def missing_indicator_packing_t(g: GenoMatrix, row0: int = 0,
                                rows_out: Optional[int] = None
                                ) -> torch.Tensor:
    """Planar16 packing (SNP-major, like ``zq_t``; int32 words on the
    panel's device) of the MISSING indicator: 1 exactly at recorded missing
    coordinates.  Restricted to SNP rows [row0, row0 + rows_out), zero past
    the panel, so that blocked callers build only their tile's slice."""
    g = on_compute(g)
    spad, kwi = g.zq_t.shape
    nrows = (spad - row0) if rows_out is None else rows_out
    arr = np.zeros((nrows, kwi), np.uint32)
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        mi = g.miss_rows_n.cpu().numpy()
        ms = g.miss_cols_n.cpu().numpy()
        sel = (ms >= row0) & (ms < row0 + nrows)
        if sel.any():
            np.bitwise_or.at(
                arr, (ms[sel] - row0, mi[sel] % kwi),
                (np.uint32(1) << (2 * (mi[sel] // kwi)).astype(np.uint32)))
    return _words(arr).to(g.device)


def _row_slab(zq: torch.Tensor, a0: int, a1: int, device=None) -> torch.Tensor:
    """Packed rows [a0, a1) of ``zq`` on ``device`` (zq's by default), zero
    past its end."""
    device = zq.device if device is None else device
    sl = zq[a0:min(a1, zq.shape[0])]
    if sl.shape[0] == a1 - a0:
        return sl.to(device).contiguous()
    out = torch.zeros((a1 - a0, zq.shape[1]), dtype=zq.dtype, device=device)
    out[: sl.shape[0]] = sl.to(device)
    return out


def _band_index(rb: int, window: int, device) -> torch.Tensor:
    """[rb, window] partner column of band entry (s, d) in a block tile."""
    return (torch.arange(rb, device=device)[:, None] + 1
            + torch.arange(window, device=device)[None, :])


def _ld_band_block(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0: int,
                   window: int, n: int, snps: int):
    """One banded-LD row block on the device (no-missing path): rectangular
    crossproduct (B8) -> rank-1 centering -> band gather -> sigma division.
    Returns the f32 [rb, window] band, 0 where the partner lies past the
    panel or on another chromosome; that validity mask; and the partner
    column of each entry."""
    m = packed_crossprod_rect(zi, zj).to(torch.float32)
    m -= ((4.0 * n) * fr)[:, None] * fc_pad[None, :]
    rb = zi.shape[0]
    lidx = _band_index(rb, window, m.device)
    valid = ((r0 + lidx) < snps) & (code_pad[:rb, None] == code_pad[lidx])
    band = torch.gather(m, 1, lidx) / (sig_r[:, None] * sig_pad[lidx])
    return torch.where(valid, band, torch.zeros((), device=m.device)), \
        valid, lidx


def _ld_score_block(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0: int,
                    window: int, n: int, snps: int, adjusted: bool):
    """One LD-score row block on the device: banded r^2 (GCTA-adjusted),
    masked, summed both ways.  Returns the outgoing sums [rb] and the
    incoming partner sums [rb + window].  The incoming sum scatters each row
    of r^2 to its partner columns (one entry per position, no collision)
    and sums the columns, so it repeats bit for bit from run to run, which
    a CUDA ``index_add_`` would not."""
    band, valid, lidx = _ld_band_block(zi, zj, fr, fc_pad, sig_r, sig_pad,
                                       code_pad, r0, window, n, snps)
    rb = band.shape[0]
    r2 = band * band
    if adjusted:
        r2 = torch.where(valid, r2 - (1.0 - r2) / float(n - 2),
                         torch.zeros((), device=band.device))
    wide = torch.zeros((rb, rb + window), dtype=torch.float32,
                       device=band.device)
    return r2.sum(dim=1), wide.scatter_(1, lidx, r2).sum(dim=0)


def _ld_mask_block(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0: int,
                   thr, window: int, n: int, snps: int):
    """One LD-prune row block on the device: banded r^2 above ``thr``,
    masked -> uint8 [rb, window] offender mask."""
    band, valid, _ = _ld_band_block(zi, zj, fr, fc_pad, sig_r, sig_pad,
                                    code_pad, r0, window, n, snps)
    return (valid & (band * band > thr)).to(torch.uint8)


class _Band:
    """Row-block geometry and the padded per-SNP vectors of the no-missing
    banded-LD path: sigma from the packed row stats (variance = sum z^2 -
    4 n f^2), 1.0 past the panel so the division is a no-op there;
    frequencies 0 past it; chromosome codes -1 past it."""

    def __init__(self, g: GenoMatrix, window: int, row_block: int,
                 chrom=None):
        snps, n = g.snps, g.indiv
        self.zq = g.zq_t
        self.rb = max(512, (row_block // 512) * 512)
        self.wb = -(-window // 512) * 512
        self.nb = -(-snps // self.rb)
        full = snps + self.rb + self.wb
        self.freq = f = _host(g.freq)
        self.zsq = _host(packed_row_sq_stats(g.zq_t))[:snps]
        var = self.zsq - 4.0 * n * f * f
        sig = np.ones(full, np.float64)
        sig[:snps] = np.where(var > 0, np.sqrt(var), 1.0)
        f_full = np.zeros(full, np.float64)
        f_full[:snps] = f
        code = np.full(full, -1, np.int32)
        code[:snps] = _chrom_codes(chrom, snps)
        dev = g.device
        self.sig = torch.as_tensor(sig, dtype=torch.float32, device=dev)
        self.f = torch.as_tensor(f_full, dtype=torch.float32, device=dev)
        self.code = torch.as_tensor(code, device=dev)

    def args(self, i: int):
        """(zi, zj, fr, fc_pad, sig_r, sig_pad, code_pad, r0) of block i."""
        r0, rb, wb = i * self.rb, self.rb, self.wb
        return (_row_slab(self.zq, r0, r0 + rb),
                _row_slab(self.zq, r0, r0 + rb + wb),
                self.f[r0: r0 + rb], self.f[r0: r0 + rb + wb],
                self.sig[r0: r0 + rb], self.sig[r0: r0 + rb + wb],
                self.code[r0: r0 + rb + wb], r0)


def _chrom_codes(chrom, snps: int) -> np.ndarray:
    if chrom is None:
        return np.zeros(snps, np.int32)
    ch = np.asarray(chrom)
    if ch.shape[0] != snps:
        raise ValueError(f"chrom has {ch.shape[0]} labels for {snps} SNPs")
    return np.unique(ch, return_inverse=True)[1].astype(np.int32)


def _missing_band(g: GenoMatrix, correct_missing) -> bool:
    """The banded functions' default: correct where missing entries are
    recorded."""
    if correct_missing is None:
        correct_missing = (g.miss_rows_n is not None
                           and g.miss_rows_n.shape[0] > 0)
    if correct_missing and g.miss_rows_n is None:
        raise ValueError("correct_missing requires a panel built with "
                         "keep_missing_info=True")
    return correct_missing


def ld_windowed(g: GenoMatrix, window: int, row_block: int = 4096,
                squared: bool = False, out: Optional[np.ndarray] = None,
                chrom=None, correct_missing: Optional[bool] = None
                ) -> np.ndarray:
    """Banded LD: ``out[s, d]`` = r(SNP ``s``, SNP ``s+d+1``) for d in
    [0, window), host float32 [snps, window]; entries whose partner runs
    past the panel, or (with per-SNP labels ``chrom``) onto another
    chromosome, are 0.

    Per row block, ONE rectangular crossproduct (B8) of the block's SNP-major
    packing against the block plus its window.  Without missing correction
    the block is centered, gathered and divided on the device and only the
    band transfers.  ``correct_missing`` (default: on when the panel records
    missing entries) applies the exact correction of the reference: up to
    three more rectangular passes of the missing-indicator packing per block
    that holds missing entries, then host float64.
    """
    g = on_compute(g)
    snps, n = g.snps, g.indiv
    if window < 1:
        raise ValueError("window must be >= 1")
    correct_missing = _missing_band(g, correct_missing)
    if out is None:
        out = np.zeros((snps, window), dtype=np.float32)
    bd = _Band(g, window, row_block, chrom)
    rb, wb, f = bd.rb, bd.wb, bd.freq
    if correct_missing:
        code = bd.code[:snps].cpu().numpy()
        # exact corrected variance: sum over called (z - 2f)^2 =
        # sum z^2 - 4f s + 4f^2 (n - missing count)
        ssum = _host(g.snp_sums())[:snps]
        mcols = g.miss_cols_n.cpu().numpy().astype(np.int64)
        mc = np.bincount(mcols, minlength=snps).astype(np.float64)
        var = bd.zsq - 4.0 * f * ssum + 4.0 * f * f * (n - mc)
        sigma = np.where(var > 0, np.sqrt(var), 1.0)
        blk_has_miss = np.bincount(mcols // rb, minlength=bd.nb) > 0

    for i in range(bd.nb):
        r0, r1 = i * rb, min((i + 1) * rb, snps)
        nrow = r1 - r0
        if not correct_missing:
            band, _, _ = _ld_band_block(*bd.args(i), window, n, snps)
            out[r0:r1] = band.cpu().numpy()[:nrow]
            continue
        zi, zj = bd.args(i)[:2]
        ahead = r0 + np.arange(nrow)[:, None] + 1 + np.arange(window)[None, :]
        partner = np.minimum(ahead, snps - 1)
        valid = (ahead < snps) & (code[partner] == code[r0:r1][:, None])
        tile = _host(packed_crossprod_rect(zi, zj))[:nrow]
        c1 = min(r0 + rb + window, snps) - r0   # valid partner columns
        tile[:, c1:] = 0.0
        # exact centered band (Zc = Z - 1(2f)^T + D):
        #   raw - 2f_c s_s - 2f_s s_c + 4 f_s f_c (n - mc_s - mc_c + mm)
        #       + 2f_s sum_{i in miss(s)} z_ic + 2f_c sum_{i in miss(c)} z_is
        fr_, fc_ = f[r0:r1], f[r0: r0 + c1]
        sr_, sc_ = ssum[r0:r1], ssum[r0: r0 + c1]
        mcr, mcc = mc[r0:r1], mc[r0: r0 + c1]
        rmiss = blk_has_miss[i]
        cmiss = (mc[r0: r0 + c1] > 0).any()
        mzr = mzc = mmrc = 0.0
        if rmiss or cmiss:
            mi_j = missing_indicator_packing_t(g, r0, rb + wb)
            mi_i = mi_j[:rb]    # the row block is the band's head
        if rmiss:
            mzr = _host(packed_crossprod_rect(mi_i, zj))[:nrow, :c1]
        if cmiss:
            mzc = _host(packed_crossprod_rect(zi, mi_j))[:nrow, :c1]
        if rmiss and cmiss:
            mmrc = _host(packed_crossprod_rect(mi_i, mi_j))[:nrow, :c1]
        tile[:, :c1] = (
            tile[:, :c1]
            - 2.0 * fc_[None, :] * sr_[:, None]
            - 2.0 * fr_[:, None] * sc_[None, :]
            + 4.0 * np.outer(fr_, fc_)
            * (n - mcr[:, None] - mcc[None, :] + mmrc)
            + 2.0 * fr_[:, None] * mzr
            + 2.0 * fc_[None, :] * mzc
        )
        # band extraction: row k pairs with columns k+1 .. k+window
        sw = np.lib.stride_tricks.sliding_window_view(tile, window, axis=1)
        band = sw[np.arange(nrow), np.arange(nrow) + 1]
        band = band / (sigma[r0:r1][:, None] * sigma[partner])
        out[r0:r1] = np.where(valid, band, 0.0).astype(np.float32)
    if squared:
        np.square(out, out=out)
    return out


def ld_score(g: GenoMatrix, window: int = 512, row_block: int = 4096,
             adjusted: bool = True, chrom=None,
             correct_missing: Optional[bool] = None) -> np.ndarray:
    """Per-SNP LD score: 1 + sum of r^2 over all partners within ``window``
    positions (both directions), the gcta ``--ld-score`` statistic.
    ``adjusted`` applies GCTA's r^2 - (1 - r^2)/(n - 2) to every real pair;
    pairs across a ``chrom`` boundary never contribute.  Without missing
    correction each row block is scored on the device and only two vectors
    transfer; the corrected path scores the host band of
    :func:`ld_windowed`.  Returns float64 [snps]."""
    g = on_compute(g)
    snps, n = g.snps, g.indiv
    window = min(window, max(snps - 1, 1))
    correct_missing = _missing_band(g, correct_missing)
    if adjusted and n < 3:
        raise ValueError("adjusted LD scores need >= 3 individuals")
    if not correct_missing:
        bd = _Band(g, window, row_block, chrom)
        score = np.ones(snps, np.float64)
        for i in range(bd.nb):
            r0, r1 = i * bd.rb, min((i + 1) * bd.rb, snps)
            row, inc = _ld_score_block(*bd.args(i), window, n, snps,
                                       adjusted)
            score[r0:r1] += _host(row)[: r1 - r0]
            lim = min(r0 + bd.rb + window, snps)
            score[r0:lim] += _host(inc)[: lim - r0]
        return score

    band = ld_windowed(g, window, row_block=row_block, squared=True,
                       chrom=chrom, correct_missing=correct_missing)
    if adjusted:
        band -= (1.0 - band) / np.float32(n - 2)
        # out-of-panel and cross-chromosome partners stay exactly 0
        code = _chrom_codes(chrom, snps)
        for d in range(window):
            lim = max(snps - d - 1, 0)
            band[lim:, d] = 0.0
            band[:lim, d][code[:lim] != code[d + 1: d + 1 + lim]] = 0.0
    score = 1.0 + band.sum(axis=1, dtype=np.float64)
    for d in range(window):  # incoming pairs: band[s-d-1, d] contributes to s
        score[d + 1:] += band[: snps - d - 1, d]
    return score


def ld_prune(g: GenoMatrix, window: int = 512, r2_threshold: float = 0.2,
             row_block: int = 4096, chrom=None,
             correct_missing: Optional[bool] = None) -> np.ndarray:
    """Greedy pairwise LD pruning (``plink --indep-pairwise``): scan SNPs
    left to right; for every still-kept pair within ``window`` whose r^2
    exceeds ``r2_threshold``, drop the member with the LOWER MAF (ties drop
    the later SNP).  Pairs across a ``chrom`` boundary are never
    candidates.  Without missing correction each row block thresholds its
    band on the device and only a uint8 mask transfers.  The scan runs in
    the native codec (``mx_ld_prune_mask`` on the mask, ``mx_ld_prune`` on
    the corrected band), or in :func:`_ld_prune_greedy` where that is
    unavailable.  Returns a boolean keep-mask [snps]."""
    g = on_compute(g)
    snps = g.snps
    f = _host(g.freq)
    maf = np.minimum(f, 1.0 - f)
    if not _missing_band(g, correct_missing):
        window_c = min(window, max(snps - 1, 1))
        bd = _Band(g, window_c, row_block, chrom)
        thr = torch.tensor(r2_threshold, dtype=torch.float32,
                           device=g.device)
        offend = np.empty((snps, window_c), np.uint8)
        for i in range(bd.nb):
            r0, r1 = i * bd.rb, min((i + 1) * bd.rb, snps)
            blk = _ld_mask_block(*bd.args(i), thr, window_c, g.indiv, snps)
            offend[r0:r1] = blk.cpu().numpy()[: r1 - r0]
        keep = native.ld_prune_mask(offend, maf)
        return (_ld_prune_greedy(offend > 0, maf, snps, window_c)
                if keep is None else keep)
    band2 = ld_windowed(g, window=window, row_block=row_block, squared=True,
                        chrom=chrom, correct_missing=True)
    keep = native.ld_prune(band2, maf, r2_threshold)
    return (_ld_prune_greedy(band2 > r2_threshold, maf, snps, window)
            if keep is None else keep)


def _ld_prune_greedy(offend: np.ndarray, maf, snps: int,
                     window: int) -> np.ndarray:
    """The greedy scan over a boolean offender band (the reference's
    semantics oracle for its native scans)."""
    keep = np.ones(snps, bool)
    for s in range(snps):
        if not keep[s]:
            continue
        hi = min(s + 1 + window, snps)
        part = np.arange(s + 1, hi)
        mask = keep[part] & offend[s, : hi - s - 1]
        if not mask.any():
            continue
        bad = part[mask]
        # drop the lower-MAF member of each offending pair
        drop_self = maf[s] < maf[bad]
        if drop_self.any():
            keep[s] = False
            # s is gone: its remaining pairs are moot
            keep[bad[~drop_self]] = False
            continue
        keep[bad] = False
    return keep


def _blocked_tiles(zq: torch.Tensor, count: int, rb: int, device, out,
                   finish):
    """Fill host ``out`` [count, count] with the upper tile pairs of
    decode(zq) decode(zq)^T (B8 per pair) and their mirrors, moving one
    pair of ``rb``-row blocks of ``zq`` (a device or host source) to
    ``device`` at a time; ``finish(tile, r0, r1, c0, c1)`` turns the int32
    tile into the stored values."""
    nb = -(-zq.shape[0] // rb)
    for i in range(nb):
        r0, r1 = i * rb, min((i + 1) * rb, count)
        if r0 >= count:
            break
        zi = _row_slab(zq, r0, r0 + rb, device)
        for j in range(i, nb):
            c0, c1 = j * rb, min((j + 1) * rb, count)
            if c0 >= count:
                break
            zj = zi if j == i else _row_slab(zq, c0, c0 + rb, device)
            tile = finish(packed_crossprod_rect(zi, zj).cpu().numpy()
                          [: r1 - r0, : c1 - c0], r0, r1, c0, c1)
            out[r0:r1, c0:c1] = tile
            if j > i:
                out[c0:c1, r0:r1] = tile.T
    return out


def _ingest_zq_n(path: str):
    """(host words zq_n, freq, indiv) of a .bed fileset: the fused native
    ingestion of that one packing, with no dense matrix; or decode and pack
    where the native codec is unavailable."""
    payload, snps, indiv = bed.read_bed_payload(path)
    ipad, kws = codec.planar16_dims(indiv, snps, row_mult=ROW_MULT)
    spad, kwi = codec.planar16_dims(snps, indiv, row_mult=ROW_MULT)
    out = native.bed_ingest(payload, snps, indiv, spad, kwi, ipad, kws,
                            want_t=False, want_pfreq=False)
    if out is not None:
        return _words(out[1]), out[2], indiv
    dense = codec.plink_to_dense(codec.transpose_u8(payload), indiv)
    return (_words(codec.pack_planar16(dense, row_mult=ROW_MULT)),
            codec.allele_freq(dense, axis=0), indiv)


def grm_blocked(source, row_block: int = 8192, scale: bool = True,
                out: Optional[np.ndarray] = None, device=None) -> np.ndarray:
    """Out-of-core VanRaden GRM for panels whose relationship matrix does
    not fit the card: one [row_block x row_block] crossproduct tile (B8) at
    a time over the full SNP axis, upper tile pairs only, accumulated into
    a host float32 matrix; the finish runs on the host in float64.

    ``source``: a GenoMatrix (its compute device; a host-resident panel's
    row blocks move there one at a time), a dense uint8 genotype matrix or
    a .bed path (packed on the host, a path by the fused native ingestion of
    the one packing it needs; only row blocks go to ``device``, the card
    unless named).  Missing genotypes contribute the packed-0 bias.
    Returns the [indiv, indiv] (scaled) GRM as host numpy float32."""
    if isinstance(source, GenoMatrix):
        zq, indiv = source.zq_n, source.indiv
        freq = source.freq.cpu().numpy()
        device = source.device
    else:
        device = _device(device)
        if isinstance(source, str):
            zq, freq, indiv = _ingest_zq_n(source)
        else:
            dense = np.asarray(source, dtype=np.uint8)
            indiv = dense.shape[0]
            freq = codec.allele_freq(dense, axis=0)
            zq = _words(codec.pack_planar16(dense, row_mult=ROW_MULT))
    rb = max(512, (row_block // 512) * 512)
    if out is None:
        out = np.zeros((indiv, indiv), dtype=np.float32)
    _blocked_tiles(zq, indiv, rb, device, out,
                   lambda t, *_: t.astype(np.float32))
    # VanRaden finish (Schlather decomposition), host f64
    n = indiv
    colsum = out.sum(axis=1, dtype=np.float64)
    total = colsum.sum()
    out -= (colsum[None, :] / n).astype(np.float32)
    out -= (colsum[:, None] / n).astype(np.float32)
    out += np.float32(total / (n * n))
    if scale:
        f = np.asarray(freq, dtype=np.float64)
        out /= np.float32(2.0 * np.sum(f * (1.0 - f)))
    return out


def ld_blocked(g: GenoMatrix, row_block: int = 8192,
               out: Optional[np.ndarray] = None) -> np.ndarray:
    """Out-of-core LD correlation (r) matrix: SNP x SNP tiles (B8 over the
    full individual axis) centered in host float64 and accumulated into a
    host float32 matrix; a host-resident panel's row blocks move to its
    compute device one at a time."""
    snps, n = g.snps, g.indiv
    rb = max(512, (row_block // 512) * 512)
    if out is None:
        out = np.zeros((snps, snps), dtype=np.float32)
    f = _host(g.freq)

    def center(tile, r0, r1, c0, c1):
        return tile.astype(np.float64) - (4.0 * n) * np.outer(f[r0:r1],
                                                              f[c0:c1])
    _blocked_tiles(g.zq_t, snps, rb, g.device, out, center)
    diag = np.maximum(np.diag(out).copy(), 0.0)  # see ld(): degenerate SNPs
    sigma = np.where(diag > 0, np.sqrt(diag), 1.0)
    out /= sigma[None, :]
    out /= sigma[:, None]
    return out


def dominance_grm(g, scale: bool = True, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Genotypic dominance relationship matrix (Su et al. 2012, GCTA
    ``--make-grm-d``):

        D = (H - hbar)(H - hbar)' / sum_s 2pq (1 - 2pq)

    with H = 1[z == 1] and p the additive allele frequencies.  The het panel
    is decoded on the host, packed with :func:`from_dense` on the panel's
    device (``device`` for dense input, the card unless named) and run
    through :func:`grm` unscaled; its own frequencies are hbar/2.  Missing
    genotypes count as non-het."""
    if isinstance(g, GenoMatrix):
        dense = codec.unpack_planar16(g.zq_n.cpu().numpy(), g.indiv, g.snps)
        p = _host(g.freq)
        device = g.device
    else:
        dense = np.asarray(g, np.uint8)
        p = codec.allele_freq(dense, axis=0)
    het = (dense == 1).astype(np.uint8)
    d = grm(from_dense(het, device=device), scale=False, dtype=dtype)
    if scale:
        pq = 2.0 * p * (1.0 - p)
        d.div_(max(float(np.sum(pq * (1.0 - pq))), 1e-30))
    return d


def grm_yang(g: GenoMatrix, block: int = 2048, dtype=torch.float32,
             pair_denominator: bool = False) -> torch.Tensor:
    """GCTA-default GRM (Yang et al. 2010), per-SNP standardized:

        G_ij = (1/m) sum_s (z_is - 2p_s)(z_js - 2p_s) / (2 p_s q_s)

    One weighted crossproduct (B9) plus the exact rank-1 centering
    Z W Z^T - u 1^T - 1 u^T + (2f)^T W (2f), u = Z W (2f) (one f32-tier
    dgemm); near-monomorphic SNPs (2pq ~ 0) get weight 0.
    ``pair_denominator=True`` divides each pair by its own co-called SNP
    count (needs a panel that tracks missing info).  On a panel that records
    missing entries, sparse add-back terms make each missing entry
    contribute exactly 0 (GCTA's sum over called SNPs): (D W) Zc^T, its
    transpose and a host (D W) D^T.  ``block`` is kept for the reference's
    signature."""
    g = on_compute(g)
    n = g.indiv
    f = _host(g.freq)
    pq2 = 2.0 * f * (1.0 - f)
    use = pq2 > 1e-12
    if pair_denominator and g.miss_rows_n is None:
        raise ValueError("pair_denominator requires a panel built with "
                         "keep_missing_info=True")
    denom = 1.0 if pair_denominator else float(max(int(use.sum()), 1))
    w = np.divide(1.0, pq2 * denom, out=np.zeros_like(pq2), where=use)
    num = packed_crossprod_weighted(g.zq_n, w)[:n, :n]
    u = dgemm(g, torch.as_tensor(w * 2.0 * f, dtype=torch.float32)[:, None],
              trans="n", center=False, precision="f32")[:n, 0]
    c = np.float32(np.sum(w * (2.0 * f) ** 2))
    # in place, in the reference's order (one GB per temporary at 16K)
    num = num.sub_(u[None, :]).sub_(u[:, None]).add_(float(c)).to(dtype)
    if g.miss_rows_n is not None and g.miss_rows_n.shape[0]:
        ia, ja, _, _, (mi, ms) = _missing_d_csr(g)
        vals = 2.0 * f[ms] * w[ms]           # (D W) entries, CSR row order
        a = sparse_times_geno(g, ia, ja, vals, n, trans_geno="t",
                              precision="f32").to(dtype)      # (D W) Z^T
        d2w = np.zeros(n)
        np.add.at(d2w, mi, vals * 2.0 * f[ms])   # (D W)(2f) per individual
        a.sub_(torch.as_tensor(d2w, dtype=dtype, device=a.device)[:, None])
        _add_sym(num, a, _ddt_dense(mi, ms, vals, n, g.snps, w2=2.0 * f[ms],
                                    dtype=_np(dtype)))
        del a
    if pair_denominator:
        counts = pairwise_nonmissing(g, use=use)
        num = torch.where(counts > 0,
                          num / torch.clamp(counts, min=1).to(dtype),
                          torch.zeros((), dtype=dtype, device=num.device))
    out = num + num.T
    return out.mul_(0.5)   # symmetrize the f32 rounding exactly
