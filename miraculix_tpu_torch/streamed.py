"""Out-of-core genotype panels: SNP chunks in pinned host memory, streamed
through the compute device's kernels.

Torch twin of ``miraculix_tpu.streamed``.  A panel too large for the card (a
1M-SNP x 100K-animal panel is ~25 GB packed per orientation) splits its SNP
axis into chunks; each chunk is a host-resident :class:`GenoMatrix` with
both packings, and every product runs chunk by chunk on the compute device:

- ``dgemm(trans='t')``: each chunk writes its own block of SNP rows;
- ``dgemm(trans='n')``: the chunks' partial products add up;
- ``grm_matvec``: G x = sum_k Zc_k (Zc_k^T x), one pass over the chunks
  (the columns of Zc split the product exactly, and centering a chunk by
  its own frequencies is the global centering restricted to it);
- ``cg_solve``: the reference's host float64 PCG on that operator.

All four centering modes stream exactly: a per-SNP mode restricts to the
chunk's columns, and ``colmeans`` works because :meth:`StreamedGeno.from_bed`
gives every chunk the whole panel's pseudo-frequencies, combined from the
chunks' additive per-animal genotype sums and called counts (the chunks'
own ratios would not combine where missing counts differ per animal).

:meth:`StreamedGeno.cache_to_device` keeps the leading chunks on the device;
every other chunk is copied, pass after pass, into one of two staging
buffers of the largest chunk's size, allocated once per container.  On the
card the copy of the next streamed chunk runs on a side stream while the
kernels of the current one run, ordered by CUDA events; on a CPU compute
device the same code runs as plain copies.  :data:`STREAM` counts the
passes, the chunk products they launch, the chunks' row statistics and the
copies, and :func:`copy_seconds` the copies' time.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .geno import (ROW_MULT, GenoMatrix, _container, _device, _from_both,
                   _moved, _words)
from .io import bed, codec, native
from .ops.dgemm import _dgemm
from .solve.cg import grm_diag as _grm_diag
from .solve.cg import host_pcg

# since the last reset_stream_counts(): passes over a container's chunks,
# the chunk products those passes launch (one packed kernel each), the
# chunks' row statistics they compute (packed_row_sq_stats, one kernel
# each on the card; no product), and the streamed chunks' copies into the
# staging buffers with their bytes (host to device on the card)
STREAM = {"passes": 0, "products": 0, "row_stats": 0, "h2d_copies": 0,
          "h2d_bytes": 0}
_timers: list = []    # CUDA (start, end) events of copies not yet read
_copied = 0.0         # seconds of the copies read so far


def reset_stream_counts() -> None:
    global _copied
    for k in STREAM:
        STREAM[k] = 0
    _timers.clear()
    _copied = 0.0


def copy_seconds() -> float:
    """Seconds the chunk copies took since the last reset_stream_counts():
    on the card, CUDA events around each copy on the side stream (this
    waits for them); on the CPU, the host clock around each copy."""
    global _copied
    for start, end in _timers:
        end.synchronize()
        _copied += start.elapsed_time(end) / 1e3
    _timers.clear()
    return _copied


class StreamedGeno:
    """SNP-chunked packed panel: each chunk a host-resident GenoMatrix (a
    device-resident one once cached) whose compute device is ``device``,
    the CUDA card unless named.  ``freq`` [snps] and ``pseudo_freq``
    [indiv] are numpy float32, as in the reference."""

    def __init__(self, chunks: List[GenoMatrix], bounds: List[tuple],
                 snps: int, indiv: int, freq: np.ndarray,
                 pseudo_freq: Optional[np.ndarray] = None, device=None):
        self.chunks = chunks
        self.bounds = bounds          # [(s0, s1)] per chunk
        self.snps = snps
        self.indiv = indiv
        self.freq = np.asarray(freq, np.float32)
        self.pseudo_freq = (np.asarray(pseudo_freq, np.float32)
                            if pseudo_freq is not None else None)
        self.device = _device(device)
        self._budget = None           # the budget cache_to_device used
        # each chunk's frequency caches on the device, for its staged views
        self._vecs = [tuple(None if v is None else v.to(self.device)
                            for v in (c.freq, c.pseudo_freq)) for c in chunks]
        self._slots = None            # two (zq_n, zq_t) staging buffers
        self._side = None             # the copies' stream on the card
        self._free = [None, None]     # events: the kernels on a slot ended

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    @property
    def sigma2(self) -> float:
        """2 sum p (1 - p), the VanRaden scale (a float, as in the
        reference)."""
        f = self.freq.astype(np.float64)
        return float(2.0 * np.sum(f * (1.0 - f)))

    def cache_to_device(self, budget_bytes: Optional[int] = None) -> int:
        """Keep the leading chunks' packings on the compute device until
        ``budget_bytes`` is spent; the rest keep streaming, so a mid-size
        panel pays the host link only for its overflow.  Returns the number
        of chunks cached.  Idempotent: cached chunks count against the
        budget and are not copied again.  The default budget is the last
        one this container used: the caller's, else, from the first call
        on, half of the card's free memory (``torch.cuda.mem_get_info``)
        or, on a CPU compute device, the whole panel.  It is read once,
        since the chunks it caches lower the free memory."""
        if budget_bytes is not None:
            self._budget = int(budget_bytes)
        if self._budget is None:
            self._budget = (torch.cuda.mem_get_info(self.device)[0] // 2
                            if self.device.type == "cuda" else self.nbytes())
        budget = self._budget
        spent = cached = 0
        for i, c in enumerate(self.chunks):
            if spent + c.nbytes > budget:
                break
            if c.host_resident:
                self.chunks[i] = _moved(c, self.device, copy=True)
            spent += c.nbytes
            cached += 1
        return cached

    # -- construction ------------------------------------------------------
    @classmethod
    def from_bed(cls, path: str, chunk_snps: int = 65536,
                 verbose: bool = False, device=None) -> "StreamedGeno":
        """Ingest a .bed fileset chunk by chunk: each SNP range is one
        contiguous read, packed in both orientations by the fused native
        codec with no dense matrix, its per-animal sums and called counts
        added up for the whole panel's pseudo-frequencies.  The chunks live
        in host memory (pinned where CUDA is available) and compute on
        ``device``."""
        device = _device(device)
        n_snps, n_indiv, _ = bed._fileset_dims(path)
        chunks, bounds = [], []
        gsum = np.zeros(n_indiv, np.int64)
        gcalled = np.zeros(n_indiv, np.int64)
        for s0 in range(0, n_snps, chunk_snps):
            s1 = min(s0 + chunk_snps, n_snps)
            g, csum, ccalled = _ingest_slice(path, s0, s1, n_indiv, device)
            chunks.append(g)
            bounds.append((s0, s1))
            gsum += csum
            gcalled += ccalled
            if verbose:
                print(f"  ingested snps [{s0}, {s1}) of {n_snps}",
                      flush=True)
        pf = (gsum / (2.0 * np.maximum(gcalled, 1))).astype(np.float32)
        pft = torch.from_numpy(pf)
        if torch.cuda.is_available():
            pft = pft.pin_memory()
        for c in chunks:
            c.pseudo_freq = pft
        freq = np.concatenate([c.freq.numpy() for c in chunks])
        return cls(chunks, bounds, n_snps, n_indiv, freq, pseudo_freq=pf,
                   device=device)

    # -- the passes ----------------------------------------------------------
    def _staging(self) -> list:
        """The two staging buffers, allocated at the first streamed pass
        at the largest streamed chunk's size."""
        if self._slots is None:
            streamed = [c for c in self.chunks if c.host_resident]
            self._slots = [tuple(
                torch.empty(max(getattr(c, k).numel() for c in streamed),
                            dtype=torch.int32, device=self.device)
                for k in ("zq_n", "zq_t")) for _ in range(2)]
            if self.device.type == "cuda":
                self._side = torch.cuda.Stream(self.device)
                for slot in self._slots:
                    for buf in slot:      # freed only after the side stream
                        buf.record_stream(self._side)
        return self._slots

    def each_chunk(self, products: int = 1, row_stats: int = 0):
        """Each chunk in order as a panel whose words live on the compute
        device: a cached chunk as it is, a streamed one as views of a
        staging buffer, valid until the next chunk is asked for.  The copy
        of the next streamed chunk is issued before the current chunk is
        handed over: on the card on a side stream, so that it overlaps the
        kernels the caller launches on the current chunk, with events that
        keep a buffer from being overwritten before those kernels end.
        ``products`` and ``row_stats``: the packed products and the row
        statistics the caller computes on each chunk (counted in
        :data:`STREAM`)."""
        STREAM["passes"] += 1
        STREAM["products"] += products * len(self.chunks)
        STREAM["row_stats"] += row_stats * len(self.chunks)
        order = [i for i, c in enumerate(self.chunks) if c.host_resident]
        if not order:                 # every chunk cached: no buffers
            self._slots, self._side, self._free = None, None, [None, None]
            yield from self.chunks
            return
        slots = self._staging()
        side = self._side
        main = torch.cuda.current_stream(self.device) if side else None

        def issue(j):                 # streamed chunk j -> slot j % 2
            global _copied
            c, k = self.chunks[order[j]], j % 2
            zn = slots[k][0][:c.zq_n.numel()].view(c.zq_n.shape)
            zt = slots[k][1][:c.zq_t.numel()].view(c.zq_t.shape)
            STREAM["h2d_copies"] += 1
            STREAM["h2d_bytes"] += c.nbytes
            if side is None:
                t0 = time.perf_counter()
                zn.copy_(c.zq_n)
                zt.copy_(c.zq_t)
                _copied += time.perf_counter() - t0
                return zn, zt, None
            if self._free[k] is not None:
                side.wait_event(self._free[k])
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(side):
                start.record()
                zn.copy_(c.zq_n, non_blocking=True)
                zt.copy_(c.zq_t, non_blocking=True)
                done.record()
            _timers.append((start, done))
            return zn, zt, done

        nxt = issue(0)
        j = 0
        for i, c in enumerate(self.chunks):
            if not c.host_resident:
                yield c
                continue
            zn, zt, done = nxt
            nxt = issue(j + 1) if j + 1 < len(order) else None
            if done is not None:
                main.wait_event(done)
            freq, pfreq = self._vecs[i]
            try:
                yield GenoMatrix(snps=c.snps, indiv=c.indiv, zq_n=zn,
                                 zq_t=zt, freq=freq, pseudo_freq=pfreq)
            finally:
                if main is not None:
                    self._free[j % 2] = main.record_event()
            j += 1

    # -- products ----------------------------------------------------------
    def dgemm(self, b, trans: str = "n", center=True,
              precision: str = "fast") -> np.ndarray:
        """Streamed ``dgemm`` over all chunks, with the semantics of
        ``ops.dgemm.dgemm`` for every centering mode (see the module
        docstring).  The chunk results gather on the compute device, in
        float64 at ``precision="f64"`` (so the exact tier's grade survives
        the chunks); returns numpy."""
        dtype = torch.float64 if precision == "f64" else torch.float32
        b = torch.as_tensor(b, dtype=dtype, device=self.device)
        if b.dim() == 1:
            b = b[:, None]
        trans = trans.lower()
        parts = zip(self.each_chunk(), self.bounds)
        if trans == "t":
            if b.shape[0] != self.indiv:
                raise ValueError("B rows must equal indiv for trans='t'")
            out = torch.empty((self.snps, b.shape[1]), dtype=dtype,
                              device=self.device)
            for g, (s0, s1) in parts:
                out[s0:s1] = _dgemm(g, b, "t", _slice_center(
                    center, self.snps, s0, s1), precision=precision)
            return out.cpu().numpy()
        if b.shape[0] != self.snps:
            raise ValueError("B rows must equal snps for trans='n'")
        out = torch.zeros((self.indiv, b.shape[1]), dtype=dtype,
                          device=self.device)
        for g, (s0, s1) in parts:
            out += _dgemm(g, b[s0:s1], trans, _slice_center(
                center, self.snps, s0, s1), precision=precision)
        return out.cpu().numpy()

    def grm_matvec(self, x, center=True):
        """(Zc Zc^T) x in one pass: each chunk's 't' product feeds its 'n'
        product before the next chunk.  A numpy ``x`` gives numpy (the
        reference's contract), a tensor gives a tensor on the compute
        device."""
        v = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        squeeze = v.dim() == 1
        if squeeze:
            v = v[:, None]
        acc = torch.zeros((self.indiv, v.shape[1]), dtype=torch.float32,
                          device=self.device)
        for g, (s0, s1) in zip(self.each_chunk(2), self.bounds):
            ck = _slice_center(center, self.snps, s0, s1)
            acc += _dgemm(g, _dgemm(g, v, "t", ck), "n", ck)
        acc = acc[:, 0] if squeeze else acc
        return acc if torch.is_tensor(x) else acc.cpu().numpy()

    def grm_diag(self, center: bool = True) -> np.ndarray:
        """diag(Zc Zc^T), exact per chunk and summed over them in float64
        (numpy)."""
        d = torch.zeros(self.indiv, dtype=torch.float64, device=self.device)
        for g in self.each_chunk(int(bool(center)), row_stats=1):
            d += _grm_diag(g, center=center).double()
        return d.cpu().numpy()

    def cg_solve(self, y: np.ndarray, lam: float = 0.0, center=True,
                 scale: bool = True, tol: float = 1e-4,
                 maxiter: int = 200, verbose: bool = False,
                 precondition: bool = False):
        """Host-driven float64 CG (:func:`solve.cg.host_pcg`) on
        (G + lam I) x = y with G = Zc Zc^T (/ sigma2 if ``scale``), each
        matvec one pass over the chunks: the streamed counterpart of
        ``solve.cg.grm_cg_solve``, with the reference's relative stop test
        (|r| / |y| <= ``tol`` per column).
        ``precondition``: Jacobi from the streamed exact diagonal (one more
        pass at set-up).  x starts at 0 exactly, so no pass multiplies a
        zero vector.  Returns ``(x, iterations, relative residuals)``."""
        y = np.asarray(y, np.float64)
        squeeze = y.ndim == 1
        if squeeze:
            y = y[:, None]
        s2 = self.sigma2 if scale else 1.0

        def op(v):
            # each column scaled to unit max for its f32 product: a column
            # that converged early keeps shrinking, and in the subnormal
            # range the centering's cancellation would cost G its
            # positivity (the reference's XLA flushes subnormals to zero)
            m = np.abs(v).max(axis=0)
            m = np.where(m > 0, m, 1.0)
            gv = self.grm_matvec((v / m).astype(np.float32), center=center)
            return gv.astype(np.float64) * (m / s2) + lam * v

        minv = None
        if precondition:
            d = self.grm_diag(center=bool(center)) / s2 + lam
            minv = np.where(d > 0, 1.0 / d, 1.0)

        # each column at unit norm: the absolute stop test of host_pcg is
        # then the reference's relative one
        bnorm = np.sqrt((y * y).sum(axis=0))
        safe = np.where(bnorm > 0, bnorm, 1.0)
        x, it, rel = host_pcg(op, y / safe, tol, maxiter, minv=minv)
        x = x * safe
        if verbose:
            print(f"  cg: {it} iterations, rel resid {float(rel.max()):.3e}",
                  flush=True)
        return (x[:, 0] if squeeze else x), it, rel

    def __repr__(self) -> str:
        cached = sum(not c.host_resident for c in self.chunks)
        return (f"StreamedGeno(snps={self.snps}, indiv={self.indiv}, "
                f"chunks={self.n_chunks} ({cached} cached), "
                f"packed={self.nbytes() / 1e6:.1f} MB, device={self.device})")


def _slice_center(center, snps: int, s0: int, s1: int):
    """A per-SNP user centering vector restricted to one chunk's SNPs;
    every other centering spec (bool, mode string) passes unchanged."""
    if hasattr(center, "shape") and len(center.shape) == 1 \
            and center.shape[0] == snps:
        return center[s0:s1]
    return center


def _ingest_slice(path: str, s0: int, s1: int, n_indiv: int, device):
    """SNPs [s0, s1) of a .bed fileset as a host-resident GenoMatrix, with
    the chunk's per-animal (genotype sum, called count): the additive parts
    of the whole panel's pseudo-frequencies.  The numpy decode and pack
    runs only where the native codec is unavailable."""
    payload, _, _ = bed.read_bed_slice_payload(path, s0, s1)
    width = s1 - s0
    ipad, kws = codec.planar16_dims(n_indiv, width, row_mult=ROW_MULT)
    spad, kwi = codec.planar16_dims(width, n_indiv, row_mult=ROW_MULT)
    out = native.bed_ingest(payload, width, n_indiv, spad, kwi, ipad, kws,
                            want_pfreq=False)
    stats = native.bed_colstats(payload, width, n_indiv)
    if out is not None and stats is not None:
        zqt, zqn, freq, _ = out
        g = _container(width, n_indiv, _words(zqn), _words(zqt), freq,
                       device=device, device_put=False)
        return g, stats[0], stats[1]
    geno_t = codec.payload_to_dense(payload, n_indiv)    # [snps, indiv]
    miss = geno_t == 3
    csum = np.where(miss, 0, geno_t).astype(np.int64).sum(axis=0)
    ccalled = (~miss).sum(axis=0).astype(np.int64)
    g = _from_both(codec.transpose_u8(geno_t), geno_t, None, False, ROW_MULT,
                   device, device_put=False)
    return g, csum, ccalled
