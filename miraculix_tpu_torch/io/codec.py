"""Host-side genotype codecs: PLINK .bed bytes <-> dense genotypes <-> planar16.

Twin of ``miraculix_tpu.io.codec`` (which cannot be imported here: every
``miraculix_tpu`` import pulls in jax).  Each public function runs the
port's native codec (``io/native``) where it is available and otherwise its
numpy version, kept under the name ``<function>_numpy``: the oracle, to
which the native output is bit-equal.  The words produced are bit for bit
those of the reference, so packed panels move between the two packages
unchanged.

planar16: for a genotype matrix ``G[rows, cols]`` (entries 0/1/2, missing
zeroed at pack time) let ``Kw = ceil(cols/16)`` rounded up to ``LANE``.
Word ``W[r, c]`` packs the 16 genotypes ``G[r, c + m*Kw]`` for ``m = 0..15``
at bit offsets ``2*m``, so decoded column ``m*Kw + c`` is word ``c``, plane
``m`` (plane-major order).

PLINK .bed semantics: 2-bit code 0b00 -> 0, 0b01 -> missing, 0b10 -> 1,
0b11 -> 2.  Bytes pack 4 individuals, low bits first; each SNP occupies
``ceil(indiv/4)`` bytes (SNP-major).  Missing genotypes decode to 3.
"""
from __future__ import annotations

import numpy as np

from . import native

MISSING = 3  # dense marker of a missing genotype (PLINK code 0b01)

LANE = 128     # packed word axis padded to this (kept for bit-equal words)
SUBLANE = 8    # default row padding granularity


def _build_plink_decode_table() -> np.ndarray:
    """256 x 4 table: byte -> the 4 genotype values it packs (missing -> 3)."""
    tbl = np.zeros((256, 4), dtype=np.uint8)
    for byte in range(256):
        for i in range(4):
            code = (byte >> (2 * i)) & 0x3
            tbl[byte, i] = MISSING if code == 0b01 else max(code - 1, 0)
    return tbl


_PLINK_DECODE = _build_plink_decode_table()
_GENO_ENCODE = np.array([0b00, 0b10, 0b11, 0b01], dtype=np.uint8)


def plink_to_dense(plink: np.ndarray, n_within: int) -> np.ndarray:
    """Unpack PLINK bytes uint8 [ceil(n_within/4), n_major] to genotype values
    uint8 [n_within, n_major] (0/1/2, 3 = missing)."""
    out = native.plink_to_dense(plink, n_within)
    return plink_to_dense_numpy(plink, n_within) if out is None else out


def plink_to_dense_numpy(plink: np.ndarray, n_within: int) -> np.ndarray:
    plink = np.asarray(plink, dtype=np.uint8)
    nbytes, nmajor = plink.shape
    vals = _PLINK_DECODE[plink]  # [nbytes, nmajor, 4]
    return vals.transpose(0, 2, 1).reshape(nbytes * 4, nmajor)[:n_within]


def payload_to_dense(payload: np.ndarray, n_within: int) -> np.ndarray:
    """Decode the raw SNP-major payload uint8 [n_major, ceil(n_within/4)] to
    uint8 [n_major, n_within] -- the transposed orientation of
    :func:`plink_to_dense`, reached without any transpose."""
    out = native.payload_to_dense(payload, n_within)
    return payload_to_dense_numpy(payload, n_within) if out is None else out


def payload_to_dense_numpy(payload: np.ndarray, n_within: int) -> np.ndarray:
    payload = np.asarray(payload, dtype=np.uint8)
    nmajor, nbytes = payload.shape
    return _PLINK_DECODE[payload].reshape(nmajor, nbytes * 4)[:, :n_within]


def dense_to_plink(geno: np.ndarray) -> np.ndarray:
    """Pack genotype values [n_within, n_major] (0/1/2, 3 = missing) into PLINK
    bytes uint8 [ceil(n_within/4), n_major]."""
    out = native.dense_to_plink(geno)
    return dense_to_plink_numpy(geno) if out is None else out


def dense_to_plink_numpy(geno: np.ndarray) -> np.ndarray:
    geno = np.asarray(geno, dtype=np.uint8)
    n_within, nmajor = geno.shape
    nbytes = (n_within + 3) // 4
    padded = np.zeros((nbytes * 4, nmajor), dtype=np.uint8)
    padded[:n_within] = geno
    codes = _GENO_ENCODE[padded].reshape(nbytes, 4, nmajor)
    out = codes[:, 0, :].copy()
    for i in range(1, 4):
        out |= codes[:, i, :] << np.uint8(2 * i)
    return out


def transpose_u8(a: np.ndarray) -> np.ndarray:
    """C-contiguous transpose of a uint8 matrix (blocked, native)."""
    out = native.transpose_u8(a)
    return np.ascontiguousarray(np.asarray(a, np.uint8).T) if out is None \
        else out


def plink_transpose_packed(plink: np.ndarray, n_within: int,
                           n_major: int) -> np.ndarray:
    """Transpose a packed PLINK matrix [ceil(n_within/4), n_major] ->
    [ceil(n_major/4), n_within] (decode, transpose, re-encode; the
    reference's compressed_operations.jl:45-66)."""
    return dense_to_plink(transpose_u8(plink_to_dense(plink, n_within)))


def allele_freq(geno: np.ndarray, axis: int = 0) -> np.ndarray:
    """Allele frequency f = sum(genotypes) / (2 * n_called) along ``axis``;
    missing entries (3) count in neither sum (float64)."""
    g = np.asarray(geno)
    if g.dtype == np.uint8 and g.ndim == 2 and axis in (0, 1, -1, -2):
        out = native.allele_freq(g if axis in (0, -2) else transpose_u8(g))
        if out is not None:
            return out
    return allele_freq_numpy(g, axis)


def allele_freq_numpy(geno: np.ndarray, axis: int = 0) -> np.ndarray:
    g = np.asarray(geno)
    n_miss = np.count_nonzero(g == MISSING, axis=axis)
    # integer-exact: the raw sum counts every missing entry as 3
    total = g.sum(axis=axis, dtype=np.int64) - MISSING * n_miss
    called = np.maximum(g.shape[axis] - n_miss, 1)
    return total / (2.0 * called)


def missing_positions(geno: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) int32 index arrays of the missing entries (value 3)."""
    rows, cols = np.nonzero(np.asarray(geno) == MISSING)
    return rows.astype(np.int32), cols.astype(np.int32)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def planar16_dims(rows: int, cols: int, lane: int = LANE,
                  row_mult: int = SUBLANE) -> tuple[int, int]:
    """Padded (rows, words) of the planar16 buffer of a rows x cols matrix."""
    kw = round_up(max((cols + 15) // 16, 1), lane)
    return round_up(rows, row_mult), kw


def pack_planar16(geno: np.ndarray, lane: int = LANE, row_mult: int = SUBLANE,
                  zero_missing: bool = True) -> np.ndarray:
    """Pack genotypes [rows, cols] (0/1/2, 3 = missing) into uint32 planar16
    words [rows_pad, Kw].  Missing entries are zeroed unless
    ``zero_missing=False``.  A transposed view packs as it stands (the
    native pack reads it by its strides; no host copy)."""
    g = np.asarray(geno)
    if zero_missing:
        out = native.pack_planar16(g, *planar16_dims(*g.shape, lane,
                                                     row_mult))
        if out is not None:
            return out
    return pack_planar16_numpy(g, lane, row_mult, zero_missing)


def pack_planar16_numpy(geno: np.ndarray, lane: int = LANE,
                        row_mult: int = SUBLANE,
                        zero_missing: bool = True) -> np.ndarray:
    g = np.asarray(geno, dtype=np.uint8)
    rows, cols = g.shape
    rp, kw = planar16_dims(rows, cols, lane, row_mult)
    words = np.zeros((rp, kw), dtype=np.uint32)
    for m in range(16):
        c0, c1 = m * kw, min((m + 1) * kw, cols)
        if c0 >= cols:
            break
        plane = g[:, c0:c1].astype(np.uint32)
        if zero_missing:
            plane[plane == MISSING] = 0
        words[:rows, : c1 - c0] |= plane << np.uint32(2 * m)
    return words


def unpack_planar16(words: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Inverse of :func:`pack_planar16` -> uint8 [rows, cols]."""
    w = np.asarray(words).view(np.uint32)
    rp, kw = w.shape
    planes = np.empty((rp, 16, kw), dtype=np.uint8)
    for m in range(16):
        planes[:, m, :] = (w >> np.uint32(2 * m)) & np.uint32(3)
    return planes.reshape(rp, 16 * kw)[:rows, :cols]


def unpack_planar16_cols(words: np.ndarray, rows: int,
                         col_idx: np.ndarray) -> np.ndarray:
    """Decode the selected columns of planar16 words without the whole dense
    panel: column c lives in word c % Kw at bits 2*(c // Kw).  Returns uint8
    [rows, len(col_idx)] (missing entries were zeroed at pack time)."""
    w = np.asarray(words).view(np.uint32)
    c = np.asarray(col_idx, np.int64)
    kw = w.shape[1]
    shift = (np.uint32(2) * (c // kw).astype(np.uint32))[None, :]
    return ((w[:rows][:, c % kw] >> shift) & np.uint32(3)).astype(np.uint8)
