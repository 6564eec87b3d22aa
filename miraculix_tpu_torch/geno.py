"""GenoMatrix: the device-resident compressed genotype container.

Torch twin of ``miraculix_tpu.geno``: both planar16 orientations live on one
device as int32 words (the reference holds the same bits as uint32), plus the
per-SNP and per-individual allele frequencies and, optionally, the missing
coordinates.  ``save``/``load`` use the reference's ``.npz`` layout, and
:func:`from_reference_state` takes the reference container's fields as numpy
arrays, so a panel packed by either package is used by the other unchanged.
The constructors put the panel on the CUDA card unless ``device`` names
another device.

A host-resident panel (``device_put=False``) keeps its words and frequency
caches in host memory (pinned where CUDA is available) and records its
compute device apart from them: every entry point that takes a panel starts
with :func:`on_compute`, which gives it a device copy for the call, so its
products run the compute device's kernels wherever the words live.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .io import bed, codec, native

ROW_MULT = 256  # packed rows pad to this, as in the reference


def _words(a) -> torch.Tensor:
    """planar16 words (uint32 or int32 numpy) -> int32 tensor, same bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


@dataclasses.dataclass
class GenoMatrix:
    """Compressed genotype matrix Z with shape (indiv, snps), values {0,1,2}.

    - ``zq_n``: int32 [indiv_pad, kw_snps], planar16 over the SNP axis
      ('n' products Z @ B read its twin ``zq_t``; the GRM reads this one).
    - ``zq_t``: int32 [snps_pad, kw_indiv], planar16 over individuals.
    - ``freq``: f32 [snps]; ``pseudo_freq``: f32 [indiv] or None.
    - ``miss_rows_n``/``miss_cols_n``: int64 missing coordinates in
      (indiv, snps) orientation, or None when not tracked.
    """

    snps: int
    indiv: int
    zq_n: torch.Tensor
    zq_t: torch.Tensor
    freq: torch.Tensor
    pseudo_freq: Optional[torch.Tensor] = None
    miss_rows_n: Optional[torch.Tensor] = None
    miss_cols_n: Optional[torch.Tensor] = None
    # set on a host-resident panel: the device its products run on
    compute_device: Optional[torch.device] = None

    @property
    def device(self) -> torch.device:
        """The device the panel computes on (and its results live on)."""
        return self.zq_n.device if self.compute_device is None \
            else self.compute_device

    @property
    def host_resident(self) -> bool:
        return self.compute_device is not None

    @property
    def nbytes(self) -> int:
        return (self.zq_n.numel() + self.zq_t.numel()) * 4

    @property
    def sigma2(self) -> torch.Tensor:
        """2 * sum_s p_s (1 - p_s), the VanRaden scale (f32 scalar)."""
        return 2.0 * torch.sum(self.freq * (1.0 - self.freq))

    @property
    def pseudo_sigma2(self) -> torch.Tensor:
        """2 * sum_i pf_i (1 - pf_i) over per-individual frequencies."""
        if self.pseudo_freq is None:
            raise ValueError("GenoMatrix was built without pseudo_freq "
                             "(rebuild with from_dense/from_plink/from_bed)")
        pf = self.pseudo_freq
        return 2.0 * torch.sum(pf * (1.0 - pf))

    # -- frequency-cache family: each one skinny packed product ----------
    def _ones(self, n: int) -> torch.Tensor:
        return torch.ones((n, 1), dtype=torch.float32, device=self.device)

    def snp_sums(self) -> torch.Tensor:
        """Per-SNP allele sums."""
        from .ops.dgemm import dgemm
        return dgemm(self, self._ones(self.indiv), trans="t", center=False)[:, 0]

    def indiv_sums(self) -> torch.Tensor:
        """Per-individual allele sums."""
        from .ops.dgemm import dgemm
        return dgemm(self, self._ones(self.snps), trans="n", center=False)[:, 0]

    def freq_sxi(self) -> torch.Tensor:
        """freqSxI[i] = sum_s freq[s] * Z[i, s]."""
        from .ops.dgemm import dgemm
        return dgemm(self, self.freq[:, None], trans="n", center=False)[:, 0]

    def pseudo_freq_sxi(self) -> torch.Tensor:
        """pseudoFreqSxI[s] = sum_i pf[i] * Z[i, s]."""
        from .ops.dgemm import dgemm
        if self.pseudo_freq is None:
            raise ValueError("pseudo_freq unavailable")
        return dgemm(self, self.pseudo_freq[:, None], trans="t",
                     center=False)[:, 0]

    def total_sum(self) -> torch.Tensor:
        """Sum of all genotype values."""
        return torch.sum(self.snp_sums())

    def __repr__(self) -> str:
        where = " (host-resident)" if self.host_resident else ""
        return (f"GenoMatrix(snps={self.snps}, indiv={self.indiv}, "
                f"packed={self.nbytes / 1e6:.1f} MB, "
                f"device={self.device}{where})")


def _device(device) -> torch.device:
    """``device``, or the CUDA card when it is None (never the CPU unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the panel goes to the card unless "
                           "a device is given (device='cpu' for the CPU)")
    return torch.device("cuda")


def resolve_device(name: str) -> torch.device:
    """``--device``: the card unless another device is named; no silent
    fallback to the CPU."""
    try:
        dev = torch.device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name!r}: {e}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the panels go to the card unless "
                         "--device names another; pass --device cpu to run "
                         "on the CPU")
    return dev


def _container(snps, indiv, zq_n, zq_t, freq, pseudo_freq=None,
               miss=None, device=None, device_put: bool = True
               ) -> GenoMatrix:
    """GenoMatrix from word tensors and numpy statistics, on ``device``, or
    with ``device_put=False`` host-resident with ``device`` its compute
    device (the host tensors pinned where CUDA is available)."""
    device = _device(device)
    home = device if device_put else torch.device("cpu")
    pin = not device_put and torch.cuda.is_available()

    def put(t):
        t = t.to(home)
        return t.pin_memory() if pin else t

    def vec(a, dtype):
        return None if a is None else put(torch.tensor(np.asarray(a, dtype)))

    mr, mc = (None, None) if miss is None else miss
    return GenoMatrix(
        snps=int(snps), indiv=int(indiv), zq_n=put(zq_n), zq_t=put(zq_t),
        freq=vec(freq, np.float32), pseudo_freq=vec(pseudo_freq, np.float32),
        miss_rows_n=vec(mr, np.int64), miss_cols_n=vec(mc, np.int64),
        compute_device=None if device_put else device)


def _moved(g: GenoMatrix, device, copy: bool = False,
           non_blocking: bool = False) -> GenoMatrix:
    """``g``'s fields on ``device`` as a device-resident panel (``copy``:
    new tensors even where they already live there)."""
    def move(t):
        return None if t is None else t.to(device, copy=copy,
                                           non_blocking=non_blocking)

    return GenoMatrix(snps=g.snps, indiv=g.indiv, zq_n=move(g.zq_n),
                      zq_t=move(g.zq_t), freq=move(g.freq),
                      pseudo_freq=move(g.pseudo_freq),
                      miss_rows_n=move(g.miss_rows_n),
                      miss_cols_n=move(g.miss_cols_n))


def on_compute(g: GenoMatrix) -> GenoMatrix:
    """``g`` with its words on its compute device: the panel itself where
    they already live there, else a copy for this call (from pinned host
    memory, asynchronous on the current stream), as the reference's
    ``jnp.asarray`` moves a host-resident panel's numpy words.  A
    host-resident panel whose compute device is the card so runs the card's
    kernels, never the plain versions."""
    if not g.host_resident or g.zq_n.device.type == g.compute_device.type:
        return g
    return _moved(g, g.compute_device, non_blocking=True)


def from_reference_state(d: dict, device=None) -> GenoMatrix:
    """Build from the reference GenoMatrix's fields given as numpy arrays
    (keys ``snps``, ``indiv``, ``zq_n``, ``zq_t``, ``freq`` and optionally
    ``pseudo_freq``, ``miss_rows_n``, ``miss_cols_n``; None means absent)."""
    miss = None
    if d.get("miss_rows_n") is not None:
        miss = (d["miss_rows_n"], d["miss_cols_n"])
    return _container(d["snps"], d["indiv"], _words(d["zq_n"]),
                      _words(d["zq_t"]), d["freq"], d.get("pseudo_freq"),
                      miss, device)


def _from_both(geno: np.ndarray, geno_t: np.ndarray, freq, keep_missing_info,
               row_mult: int, device, device_put: bool = True) -> GenoMatrix:
    """GenoMatrix from genotypes [indiv, snps] and their C-contiguous
    transpose: each orientation packs from contiguous rows, and each
    frequency cache is a column pass."""
    miss = codec.missing_positions(geno) if keep_missing_info else None
    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    zq_n = _words(codec.pack_planar16(geno, row_mult=row_mult))
    zq_t = _words(codec.pack_planar16(geno_t, row_mult=row_mult))
    n_indiv, n_snps = geno.shape
    return _container(n_snps, n_indiv, zq_n, zq_t, freq,
                      codec.allele_freq(geno_t, axis=0), miss, device,
                      device_put)


def from_dense(geno: np.ndarray, freq: Optional[np.ndarray] = None,
               row_mult: int = ROW_MULT, keep_missing_info: bool = False,
               device_put: bool = True, device=None) -> GenoMatrix:
    """Pack a dense genotype matrix [indiv, snps] (0/1/2, 3 = missing).
    ``row_mult`` pads the packed rows of both orientations.
    ``device_put=False`` keeps the panel host-resident, with ``device`` its
    compute device."""
    device = _device(device)
    geno = np.ascontiguousarray(geno, dtype=np.uint8)
    return _from_both(geno, codec.transpose_u8(geno), freq,
                      keep_missing_info, row_mult, device, device_put)


def from_plink(plink: np.ndarray, snps: int, indiv: int,
               freq: Optional[np.ndarray] = None, **kw) -> GenoMatrix:
    """Build from raw PLINK bytes [ceil(indiv/4), snps]; ``kw`` as
    :func:`from_dense`."""
    if plink.shape[1] != snps:
        raise ValueError(f"plink bytes cover {plink.shape[1]} SNPs, not {snps}")
    return from_dense(codec.plink_to_dense(plink, indiv), freq=freq, **kw)


def from_bed(path: str, freq: Optional[np.ndarray] = None,
             row_mult: int = ROW_MULT, keep_missing_info: bool = False,
             device_put: bool = True, device=None) -> GenoMatrix:
    """Build from a PLINK .bed fileset.

    With no missing coordinates asked for and the default ``row_mult``, the
    native fused ingestion goes straight from the SNP-major payload to both
    packings and both frequency caches, with no dense matrix (as the
    reference does).  Otherwise, or where the native codec is unavailable,
    the payload decodes to the [snps, indiv] orientation, is transposed once
    and both orientations are packed; the words and frequencies are the
    same on both paths.  ``device_put=False`` keeps the panel host-resident,
    with ``device`` its compute device."""
    device = _device(device)
    payload, n_snps, n_indiv = bed.read_bed_payload(path)
    if not keep_missing_info and row_mult == ROW_MULT:
        ipad, kws = codec.planar16_dims(n_indiv, n_snps, row_mult=ROW_MULT)
        spad, kwi = codec.planar16_dims(n_snps, n_indiv, row_mult=ROW_MULT)
        out = native.bed_ingest(payload, n_snps, n_indiv, spad, kwi, ipad, kws)
        if out is not None:
            zqt, zqn, freq_c, pfreq = out
            return _container(n_snps, n_indiv, _words(zqn), _words(zqt),
                              freq_c if freq is None else freq, pfreq,
                              None, device, device_put)
    geno_t = codec.payload_to_dense(payload, n_indiv)    # [snps, indiv]
    return _from_both(codec.transpose_u8(geno_t), geno_t, freq,
                      keep_missing_info, row_mult, device, device_put)


def subset_snps(g: GenoMatrix, idx, freq: Optional[np.ndarray] = None
                ) -> GenoMatrix:
    """SNP-subset GenoMatrix built on the panel's device from the packed
    words, with no dense intermediate; the words equal the reference's bit
    for bit.

    - ``zq_t``: rows are SNPs, so the subset's packing is one row gather,
      with the padding rows zeroed.
    - ``zq_n``: SNP s lives in word column s % kw at bits 2*(s // kw), so
      each subset SNP's 2-bit field is one column gather and shift; the 16
      planes of the fresh planar16 layout are OR-ed together (an int32 sum
      would overflow at plane 15).

    ``freq`` defaults to the parent panel's frequencies at ``idx``;
    pseudo-frequencies depend on the subset and are dropped.  Missing
    coordinates are restricted to ``idx`` and remapped (a repeated index
    keeps only its last occurrence's coordinates).
    """
    g = on_compute(g)
    idx = np.asarray(idx, np.int64)
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or
                                       idx.max() >= g.snps)):
        raise ValueError("idx must be 1-D SNP indices within the panel")
    m = int(idx.size)
    if m == 0:
        raise ValueError("empty SNP subset")
    dev = g.device
    ipad, kw = g.zq_n.shape

    spd_new = codec.round_up(m, ROW_MULT)
    idx_pad = np.zeros(spd_new, np.int64)
    idx_pad[:m] = idx
    zq_t = g.zq_t[torch.from_numpy(idx_pad).to(dev)]
    zq_t[m:] = 0

    kw2 = codec.round_up(-(-m // 16), codec.LANE)
    sidx = np.zeros(16 * kw2, np.int64)
    sidx[:m] = idx
    src_col = torch.from_numpy(sidx % kw).to(dev)
    src_shift = torch.from_numpy((2 * (sidx // kw)).astype(np.int32)).to(dev)
    fields = (g.zq_n[:, src_col] >> src_shift) & 3
    fields[:, m:] = 0
    fields = fields.reshape(ipad, 16, kw2)
    zq_n = fields[:, 0].clone()
    for p in range(1, 16):
        zq_n |= fields[:, p] << (2 * p)

    fsub = (g.freq[torch.from_numpy(idx).to(dev)] if freq is None
            else torch.as_tensor(np.asarray(freq, np.float32), device=dev))
    mr = mc = None
    if g.miss_rows_n is not None:
        mrows = g.miss_rows_n.cpu().numpy()
        mcols = g.miss_cols_n.cpu().numpy()
        newpos = np.full(g.snps, -1, np.int64)
        newpos[idx] = np.arange(m)
        sel = newpos[mcols] >= 0
        mr = torch.from_numpy(mrows[sel]).to(dev)
        mc = torch.from_numpy(newpos[mcols[sel]]).to(dev)
    return GenoMatrix(snps=m, indiv=g.indiv, zq_n=zq_n, zq_t=zq_t, freq=fsub,
                      miss_rows_n=mr, miss_cols_n=mc)


def save(path: str, g: GenoMatrix) -> None:
    """Checkpoint in the reference's ``.npz`` layout, stored uncompressed
    (as :func:`parallel.save_sharded`): 2-bit words deflate by only ~30%,
    at a few MB/s of zlib on a host core."""
    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    tracked = g.miss_rows_n is not None
    np.savez(
        path, snps=g.snps, indiv=g.indiv, miss_tracked=tracked,
        zq_n=host(g.zq_n, np.int32).view(np.uint32),
        zq_t=host(g.zq_t, np.int32).view(np.uint32),
        freq=host(g.freq, np.float32),
        pseudo_freq=(host(g.pseudo_freq, np.float32)
                     if g.pseudo_freq is not None else np.zeros(0, np.float32)),
        miss_rows=(host(g.miss_rows_n, np.int32) if tracked
                   else np.zeros(0, np.int32)),
        miss_cols=(host(g.miss_cols_n, np.int32) if tracked
                   else np.zeros(0, np.int32)))


def load(path: str, device=None) -> GenoMatrix:
    """Inverse of :func:`save`; also reads the reference's checkpoints."""
    with np.load(path) as z:
        has_miss = (bool(z["miss_tracked"]) if "miss_tracked" in z.files
                    else z["miss_rows"].size > 0)
        has_pf = "pseudo_freq" in z.files and z["pseudo_freq"].size > 0
        return from_reference_state(dict(
            snps=z["snps"], indiv=z["indiv"], zq_n=z["zq_n"], zq_t=z["zq_t"],
            freq=z["freq"],
            pseudo_freq=z["pseudo_freq"] if has_pf else None,
            miss_rows_n=z["miss_rows"] if has_miss else None,
            miss_cols_n=z["miss_cols"] if has_miss else None), device)
