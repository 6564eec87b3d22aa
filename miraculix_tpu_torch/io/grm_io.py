"""GCTA-format GRM file I/O — the interchange format of the pipelines the
reference benchmarks against (GCTA 1.94 / PLINK --make-grm-bin,
utils/benchmark/benchmark_suite.jl:230-273): downstream REML/association
tools consume these files directly.

A GCTA GRM fileset is three files sharing a prefix:

- ``<p>.grm.bin``    float32 little-endian, the LOWER triangle including
                     the diagonal, row by row: (0,0), (1,0), (1,1), ...
- ``<p>.grm.N.bin``  float32, same layout: the number of SNPs used per
                     pair (a constant when no genotypes are missing).
- ``<p>.grm.id``     text, one ``FID\\tIID`` line per individual.

The triangles are written and read a row at a time (no [n (n + 1) / 2]
index arrays); the bytes are those of the JAX package's writer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _write_tril(path: str, m: np.ndarray) -> None:
    """The float32-LE lower triangle of ``m``, row by row."""
    with open(path, "wb") as fh:
        for i in range(m.shape[0]):
            fh.write(np.asarray(m[i, : i + 1], np.float64).astype(
                "<f4").tobytes())


def _symmetric(tri: np.ndarray, n: int) -> np.ndarray:
    """The float64 symmetric [n, n] matrix of a flat lower triangle."""
    low = np.zeros((n, n))
    for i in range(n):   # row i is (i, 0..i) at i (i + 1) / 2
        a = i * (i + 1) // 2
        low[i, : i + 1] = tri[a:a + i + 1]
    b = 256   # the mirror in square blocks that stay in cache
    for r0 in range(0, n, b):
        r1 = min(r0 + b, n)
        for c0 in range(r1, n, b):
            low[r0:r1, c0:c0 + b] = low[c0:c0 + b, r0:r1].T
        blk = low[r0:r1, r0:r1]
        np.copyto(blk, blk.T.copy(), where=~np.tri(r1 - r0, dtype=bool))
    return low


def write_gcta_grm(
    prefix: str,
    grm: np.ndarray,
    n_snps,
    ids: Optional[Sequence] = None,
) -> None:
    """Write ``<prefix>.grm.bin/.grm.N.bin/.grm.id``.

    ``grm``: [n, n] relationship matrix (e.g. ``mt.grm(gm, scale=True)``
    as numpy).  ``n_snps``: scalar, or [n, n] per-pair SNP counts
    (missing-aware).  ``ids``: per-individual labels — strings
    ``"FID IID"``/``"IID"`` or (fid, iid) pairs; defaults to ``I1..In``
    with FID = IID.
    """
    g = np.asarray(grm)
    n = g.shape[0]
    if g.shape != (n, n):
        raise ValueError(f"grm must be square, got {g.shape}")
    _write_tril(prefix + ".grm.bin", g)
    cnt = np.asarray(n_snps, np.float64)
    if cnt.ndim == 0:
        np.full(n * (n + 1) // 2, float(cnt), "<f4").tofile(
            prefix + ".grm.N.bin")
    else:
        _write_tril(prefix + ".grm.N.bin", cnt)
    with open(prefix + ".grm.id", "w") as fh:
        for i in range(n):
            if ids is None:
                fh.write(f"I{i + 1}\tI{i + 1}\n")
            else:
                e = ids[i]
                if isinstance(e, (tuple, list)):
                    fh.write(f"{e[0]}\t{e[1]}\n")
                else:
                    parts = str(e).split()
                    fid, iid = (parts[0], parts[1]) if len(parts) > 1 \
                        else (parts[0], parts[0])
                    fh.write(f"{fid}\t{iid}\n")


def read_gcta_grm(prefix: str):
    """Read a GCTA GRM fileset -> ``(grm [n, n] float64 symmetric,
    n_snps [n, n] float64, ids list of (fid, iid))``."""
    with open(prefix + ".grm.id") as fh:
        ids = [tuple(ln.split()[:2]) for ln in fh if ln.strip()]
    n = len(ids)
    npairs = n * (n + 1) // 2
    tri = np.fromfile(prefix + ".grm.bin", dtype="<f4")
    if len(tri) != npairs:
        raise ValueError(f"{prefix}.grm.bin has {len(tri)} entries, "
                         f"expected {npairs} for {n} ids")
    cnt = np.fromfile(prefix + ".grm.N.bin", dtype="<f4")
    g = _symmetric(tri, n)
    if len(cnt) == npairs:
        c = _symmetric(cnt, n)
    elif len(cnt) == 1:  # some tools write a single constant
        c = np.full((n, n), float(cnt[0]))
    else:
        raise ValueError(f"{prefix}.grm.N.bin has {len(cnt)} entries")
    return g, c, ids
