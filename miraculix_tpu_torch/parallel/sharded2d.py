"""2D-sharded genotype linear algebra: individuals x SNPs over a 2D mesh.

Torch twin of ``miraculix_tpu.parallel.sharded2d``, for panels where
neither axis fits one card.  Global shard d sits at (a, b) of the
("i", "k") mesh (row-major) and holds the planar16 packings of its genotype
block Z[a-th individual range, b-th SNP range] (``ipd`` x ``spd``, each
padded to a multiple of 2048) in both orientations:

- dgemm 'n' (C = Z B): B row-sharded over "k", a local product a shard,
  psum over "k": C row-sharded over "i".  No gathers.
- dgemm 't' (C = Z^T B): B row-sharded over "i", psum over "i": C
  row-sharded over "k".
- The GBLUP CG operator chains 't' into 'n' with two psums an iteration;
  its vectors stay row-sharded (this process keeps its own "i" rows).
- GRM: all_gather of the row blocks along "i", one rectangular integer
  crossproduct a shard (``packed_crossprod_rect``), psum over "k": G
  row-sharded over "i".

Every input and output is padded to di * ipd (dk * spd) rows and
row-sharded (a :class:`RowSharded`): build inputs with
:func:`pad_indiv_vec` / :func:`pad_snp_vec`, fetch with ``host_global`` and
cut to ``[:indiv]`` / ``[:snps]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..io import bed as bedio
from ..io import codec, native
from ..ops.common import packed_row_sq_stats
from ..ops.grm import packed_crossprod_rect
from ..solve.cg import CGResult, cg, jacobi_minv
from . import _collectives as col
from ._collectives import Mesh
from .sharded import (SHARD_MULT, RowSharded, _check_int32, _finish,
                      _local_mm, _mesh_of, _per_line, _round_up, _words)
from .sharded import from_reference_state as _from_reference_state_1d


def make_mesh_2d(n_devices: Optional[int] = None, di: Optional[int] = None,
                 axes: Tuple[str, str] = ("i", "k"), *, devices=None,
                 group=None) -> Mesh:
    """2D mesh: "i" over individuals, "k" over SNPs, spanning every process
    of ``group`` (default: the initialised process group, if any).  ``di``
    defaults to the largest power of two <= sqrt(n) that divides n.
    ``devices`` / ``n_devices`` as :func:`sharded.make_mesh`.  A process's
    shards must cover whole "k" lines or an equal part of one."""
    grp = group if group is not None else col.world_group()
    world = 1 if grp is None else dist.get_world_size(grp)
    if devices is None:
        if n_devices is not None and n_devices % world:
            raise ValueError(f"{n_devices} shards do not divide over "
                             f"{world} processes")
        devices = col.default_devices(
            None if n_devices is None else n_devices // world)
    n = len(devices) * world
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices} but {len(devices)} local "
                         f"devices x {world} processes given")
    if di is None:
        di = 1
        while (2 * di) ** 2 <= n and n % (2 * di) == 0:
            di *= 2
    if n % di:
        raise ValueError(f"di={di} does not divide {n} shards")
    dk = n // di
    if len(devices) % dk and dk % len(devices):
        raise ValueError(f"{len(devices)} local shards neither cover whole "
                         f"'k' lines of {dk} nor an equal part of one")
    return Mesh(axes, (di, dk), devices, grp)


@dataclasses.dataclass(eq=False)
class ShardedGeno2D:
    """Genotype matrix block-sharded over a 2D mesh (see the module
    docstring); ``zq_n``, ``zq_t`` and ``freq`` hold this process's
    shards.

    - ``zq_n[j]``: [ipd, spd / 16] int32, the planar16 packing (SNP axis
      packed) of shard j's block;
    - ``zq_t[j]``: [spd, ipd / 16] int32, the packed transpose;
    - ``freq[j]``: [spd] f32, the shard's SNP range, zero past the real
      SNPs.
    """

    snps: int
    indiv: int
    ipd: int                  # padded individuals per "i" slice
    spd: int                  # padded snps per "k" slice
    axes: Tuple[str, str]
    zq_n: list
    zq_t: list
    freq: list
    mesh: Mesh

    def __post_init__(self):
        ak = self.axes[1]
        part = [torch.sum(f * (1.0 - f))[None] for f in self.freq]
        self._sigma2 = 2.0 * col.psum(self.mesh, ak, part)[0][0]

    @property
    def sigma2(self) -> torch.Tensor:
        return self._sigma2

    @property
    def device(self) -> torch.device:
        return self.mesh.local_devices[0]

    def ab(self, j: int) -> tuple:
        """(a, b): local shard j's "i" and "k" coordinates."""
        c = self.mesh.coords(self.mesh.shard_ids[j])
        return c[self.axes[0]], c[self.axes[1]]

    def real(self, j: int) -> tuple:
        """(individuals, SNPs) of local shard j's block that are real."""
        a, b = self.ab(j)
        return (max(0, min(self.ipd, self.indiv - a * self.ipd)),
                max(0, min(self.spd, self.snps - b * self.spd)))

    def __repr__(self) -> str:
        return (f"ShardedGeno2D(snps={self.snps}, indiv={self.indiv}, "
                f"ipd={self.ipd}, spd={self.spd}, {self.mesh})")


def _container(mesh, snps, indiv, ipd, spd, blocks) -> ShardedGeno2D:
    devs = mesh.local_devices
    return ShardedGeno2D(
        snps=int(snps), indiv=int(indiv), ipd=int(ipd), spd=int(spd),
        axes=tuple(mesh.axis_names),
        zq_n=[_words(b[0]).to(d) for b, d in zip(blocks, devs)],
        zq_t=[_words(b[1]).to(d) for b, d in zip(blocks, devs)],
        freq=[torch.tensor(np.asarray(b[2], np.float32), device=d)
              for b, d in zip(blocks, devs)],
        mesh=mesh)


def _dims(mesh: Mesh, n_indiv: int, n_snps: int) -> tuple:
    ai, ak = mesh.axis_names
    di, dk = mesh.shape[ai], mesh.shape[ak]
    return (di, dk, _round_up(-(-n_indiv // di), SHARD_MULT),
            _round_up(-(-n_snps // dk), SHARD_MULT))


def shard_genotypes_2d(geno: np.ndarray, mesh: Mesh,
                       freq: Optional[np.ndarray] = None) -> ShardedGeno2D:
    """Pack a dense genotype matrix [indiv, snps] into 2D blocks, each
    process packing only its own shards."""
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    di, dk, ipd, spd = _dims(mesh, n_indiv, n_snps)
    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    freq_pad = np.zeros(dk * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)
    blocks = []
    for d in mesh.shard_ids:
        c = mesh.coords(d)
        a, b = c[mesh.axis_names[0]], c[mesh.axis_names[1]]
        blk = geno[a * ipd:(a + 1) * ipd, b * spd:(b + 1) * spd]
        pad = np.zeros((ipd, spd), dtype=np.uint8)
        pad[:blk.shape[0], :blk.shape[1]] = np.where(blk == 3, 0, blk)
        blocks.append((codec.pack_planar16(pad, row_mult=8),
                       codec.pack_planar16(codec.transpose_u8(pad),
                                           row_mult=8),
                       freq_pad[b * spd:(b + 1) * spd]))
    return _container(mesh, n_snps, n_indiv, ipd, spd, blocks)


def shard_genotypes_2d_from_bed(path: str, mesh: Mesh,
                                freq: Optional[np.ndarray] = None
                                ) -> ShardedGeno2D:
    """Each process reads and packs only its shards' (individual range x
    SNP range) blocks: the .bed is SNP-major, so a block is the byte range
    [i0/4, i1/4) of each SNP row of its range, a strided slice of the
    memory-mapped payload.  The frequencies are one native pass over the
    payload unless given."""
    payload, n_snps, n_indiv = bedio.read_bed_payload(path)   # mmap'd
    di, dk, ipd, spd = _dims(mesh, n_indiv, n_snps)
    if freq is None:
        kws = codec.round_up(max((n_snps + 15) // 16, 1), codec.LANE)
        kwi = codec.round_up(max((n_indiv + 15) // 16, 1), codec.LANE)
        nat = native.bed_ingest(payload, n_snps, n_indiv,
                                codec.round_up(n_snps, 256), kwi,
                                ipd * di, kws, want_t=False, want_n=False,
                                want_pfreq=False)
        if nat is not None:
            freq = nat[2]
        else:
            freq = codec.allele_freq(codec.transpose_u8(
                codec.payload_to_dense(payload, n_indiv)), axis=0)
    freq_pad = np.zeros(dk * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)
    blocks = []
    for d in mesh.shard_ids:
        c = mesh.coords(d)
        a, b = c[mesh.axis_names[0]], c[mesh.axis_names[1]]
        s0, s1 = b * spd, min((b + 1) * spd, n_snps)
        i0, i1 = a * ipd, min((a + 1) * ipd, n_indiv)
        fb = freq_pad[b * spd:(b + 1) * spd]
        if s1 > s0 and i1 > i0:
            # i0 is a multiple of 4 (ipd of 2048), so the block's bytes are
            # the .bed payload of its own individuals: the fused native
            # ingestion packs both orientations straight from them
            chunk = np.ascontiguousarray(payload[s0:s1, i0 // 4:(i1 + 3) // 4])
            nat = native.bed_ingest(chunk, s1 - s0, i1 - i0, spd, ipd // 16,
                                    ipd, spd // 16, want_pfreq=False)
            if nat is not None:
                blocks.append((nat[1], nat[0], fb))
                continue
            sub = codec.transpose_u8(codec.payload_to_dense(chunk, i1 - i0))
        else:
            sub = np.zeros((0, 0), np.uint8)
        pad = np.zeros((ipd, spd), dtype=np.uint8)
        pad[:sub.shape[0], :sub.shape[1]] = np.where(sub == 3, 0, sub)
        blocks.append((codec.pack_planar16(pad, row_mult=8),
                       codec.pack_planar16(codec.transpose_u8(pad),
                                           row_mult=8), fb))
    return _container(mesh, n_snps, n_indiv, ipd, spd, blocks)


def from_reference_state(d: dict, mesh: Mesh):
    """Build the port's container from the reference container's fields as
    numpy arrays (the global arrays ``host_global`` gives): a
    ``ShardedGeno2D`` from keys ``snps``, ``indiv``, ``ipd``, ``spd``,
    ``axes``, ``zq_n`` [di ipd, dk spd/16], ``zq_t`` [dk spd, di ipd/16],
    ``freq`` [dk spd]; a 1D ``ShardedGeno`` from a dict without ``ipd``
    (:func:`sharded.from_reference_state`).  Each process keeps its own
    shards."""
    if "ipd" not in d:
        return _from_reference_state_1d(d, mesh)
    ipd, spd = int(d["ipd"]), int(d["spd"])
    ai, ak = mesh.axis_names
    di, dk = mesh.shape[ai], mesh.shape[ak]
    zq_n, zq_t = np.asarray(d["zq_n"]), np.asarray(d["zq_t"])
    if zq_n.shape != (di * ipd, dk * spd // 16) or \
            zq_t.shape != (dk * spd, di * ipd // 16):
        raise ValueError(f"words {zq_n.shape} / {zq_t.shape} do not fit a "
                         f"{di} x {dk} mesh")
    freq = np.asarray(d["freq"])
    kk, ki = spd // 16, ipd // 16
    blocks = []
    for s in mesh.shard_ids:
        c = mesh.coords(s)
        a, b = c[ai], c[ak]
        blocks.append((zq_n[a * ipd:(a + 1) * ipd, b * kk:(b + 1) * kk],
                       zq_t[b * spd:(b + 1) * spd, a * ki:(a + 1) * ki],
                       freq[b * spd:(b + 1) * spd]))
    return _container(mesh, d["snps"], d["indiv"], ipd, spd, blocks)


def _pad_vec(sg, v, axis: str, step: int) -> RowSharded:
    """``v`` [rows(, k)] padded to (mesh size along ``axis``) x ``step``
    rows and cut into this process's blocks along ``axis``."""
    m = sg.mesh
    v = torch.as_tensor(v, dtype=torch.float32)
    if v.dim() == 1:
        v = v[:, None]
    total = m.shape[axis] * step
    full = torch.zeros((total, v.shape[1]), dtype=torch.float32,
                       device=v.device)
    full[: v.shape[0]] = v
    cache = {}
    blocks = []
    for j, d in enumerate(m.shard_ids):
        c = m.coord(d, axis)
        key = (c, str(m.local_devices[j]))
        if key not in cache:
            cache[key] = full[c * step:(c + 1) * step].to(m.local_devices[j])
        blocks.append(cache[key])
    return RowSharded(blocks, axis, total, m)


def pad_indiv_vec(sg: ShardedGeno2D, v, mesh: Optional[Mesh] = None
                  ) -> RowSharded:
    """Pad an [indiv(, k)] array to di * ipd rows and shard it by "i"."""
    _mesh_of(sg, mesh)
    return _pad_vec(sg, v, sg.axes[0], sg.ipd)


def pad_snp_vec(sg: ShardedGeno2D, v, mesh: Optional[Mesh] = None
                ) -> RowSharded:
    """Pad a [snps(, k)] array to dk * spd rows and shard it by "k"."""
    _mesh_of(sg, mesh)
    return _pad_vec(sg, v, sg.axes[1], sg.spd)


def _as_sharded(sg, x, axis: str, step: int) -> RowSharded:
    if isinstance(x, RowSharded):
        if x.axis != axis:
            raise ValueError(f"input is not row-sharded over {axis!r}")
        return x
    return _pad_vec(sg, x, axis, step)


def sharded_dgemm_2d(sg: ShardedGeno2D, b, trans: str = "n",
                     center: bool = True, mesh: Optional[Mesh] = None
                     ) -> RowSharded:
    """dgemm over the 2D mesh; inputs and outputs row-sharded and padded:

    'n': B [dk spd, n] sharded by "k" -> C [di ipd, n] sharded by "i";
    't': B [di ipd, n] sharded by "i" -> C [dk spd, n] sharded by "k".
    ``b`` may also be a plain array, padded and cut here."""
    m = _mesh_of(sg, mesh)
    ai, ak = sg.axes
    trans = trans.lower()
    if trans == "n":
        bs = _as_sharded(sg, b, ak, sg.spd)
        parts = []
        for j, bl in enumerate(bs.blocks):
            c = _local_mm(sg.zq_n[j], sg.zq_t[j], bl, real=sg.real(j)[1])
            if center:
                c = c - 2.0 * (sg.freq[j] @ bl)[None, :]
            parts.append(c)
        return RowSharded(col.psum(m, ak, parts), ai, m.shape[ai] * sg.ipd,
                          m)
    if trans != "t":
        raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
    bs = _as_sharded(sg, b, ai, sg.ipd)
    parts = []
    for j, bl in enumerate(bs.blocks):
        c = _local_mm(sg.zq_t[j], sg.zq_n[j], bl, real=sg.real(j)[0])
        # the column sums ride in the same psum as one more row
        parts.append(torch.cat([c, bl.sum(dim=0)[None, :]]))
    summed = col.psum(m, ai, parts)

    def finish(j, s):
        c, colsum = s[:-1], s[-1]
        if center:
            c = c - 2.0 * sg.freq[j][:, None] * colsum[None, :]
        return c

    return RowSharded(_per_line(summed, finish), ak, m.shape[ak] * sg.spd,
                      m)


def sharded_crossprod_2d(sg: ShardedGeno2D, mesh: Optional[Mesh] = None
                         ) -> RowSharded:
    """The raw integer crossproduct Z Z^T, int32 and exact, row-sharded by
    "i" [di ipd, di ipd]: the row blocks gathered along "i", one
    rectangular crossproduct a shard, psum over "k"."""
    m = _mesh_of(sg, mesh)
    ai, ak = sg.axes
    _check_int32(sg.snps)
    z_all = col.all_gather(m, ai, sg.zq_n)
    parts = []
    for j in range(m.n_local):
        # the block's rows past its real individuals are zero words: its
        # product runs on the real rows (padded to the kernels' 256)
        rows = _round_up(sg.real(j)[0], 256)
        part = torch.zeros((sg.ipd, z_all[j].shape[0]), dtype=torch.int32,
                           device=z_all[j].device)
        if rows:
            part[:rows] = packed_crossprod_rect(sg.zq_n[j][:rows], z_all[j])
        parts.append(part)
    return RowSharded(col.psum(m, ak, parts), ai, m.shape[ai] * sg.ipd, m)


def sharded_grm_2d(sg: ShardedGeno2D, scale: bool = True,
                   mesh: Optional[Mesh] = None) -> RowSharded:
    """GRM over the 2D mesh (:func:`sharded_crossprod_2d`, finished in f32):
    row-sharded by "i", [di ipd, di ipd], zero past indiv."""
    m = _mesh_of(sg, mesh)
    raw = sharded_crossprod_2d(sg, mesh=m)
    return _finish(raw, sg.ipd, sg.indiv, sg.sigma2, scale, sg.axes[0])


def sharded_grm_diag_2d(sg: ShardedGeno2D, center: bool = True,
                        mesh: Optional[Mesh] = None) -> RowSharded:
    """diag(Z_c Z_c^T) over the 2D mesh, exactly, row-sharded by "i" like
    every CG vector [di ipd]: sum z^2 from the packed words (psum over
    "k"), sum f z one 'n' product by the frequency column, sum f^2 a psum
    over "k"."""
    m = _mesh_of(sg, mesh)
    ai, ak = sg.axes
    zsq = col.psum(m, ak, [packed_row_sq_stats(z) for z in sg.zq_n])
    if not center:
        return RowSharded(zsq, ai, m.shape[ai] * sg.ipd, m)
    fcol = RowSharded([f[:, None] for f in sg.freq], ak,
                      m.shape[ak] * sg.spd, m)
    fz = sharded_dgemm_2d(sg, fcol, trans="n", center=False, mesh=m)
    ff = col.psum(m, ak, [torch.sum(f * f)[None] for f in sg.freq])
    out = _per_line(zsq, lambda j, z: z - 4.0 * fz.blocks[j][:, 0]
                    + 4.0 * ff[j][0])
    return RowSharded(out, ai, m.shape[ai] * sg.ipd, m)


def _mask_rows(x: RowSharded, step: int, limit: int) -> RowSharded:
    """``x`` with its rows at global index >= ``limit`` set to zero."""
    index = x.index

    def mask(j, blk):
        r0 = index[x.mesh.shard_ids[j]] * step
        keep = (torch.arange(blk.shape[0], device=blk.device) + r0) < limit
        return blk * keep.to(blk.dtype).reshape((-1,) + (1,) * (
            blk.dim() - 1))
    return RowSharded(_per_line(x.blocks, mask), x.axis, x.rows, x.mesh)


def _local_rows(x: RowSharded, device) -> torch.Tensor:
    """The blocks this process holds, in block order, as one tensor."""
    return torch.cat([blk.to(device) for blk in x.held().values()])


def _from_local_rows(like: RowSharded, v: torch.Tensor) -> RowSharded:
    """Cut this process's rows ``v`` back into ``like``'s blocks."""
    held = like.held()
    step = next(iter(held.values())).shape[0]
    pieces = {b: v[k * step:(k + 1) * step] for k, b in enumerate(held)}
    m, index = like.mesh, like.index
    blocks = [pieces[index[d]].to(m.local_devices[j])
              for j, d in enumerate(m.shard_ids)]
    return RowSharded(blocks, like.axis, like.rows, m)


def gather_rows(x: RowSharded) -> torch.Tensor:
    """A row-sharded array whole on the mesh's first local device, on every
    process: an all_gather along the axis its blocks run over."""
    return col.all_gather(x.mesh, x.axis, x.blocks)[0][: x.rows]


def grm_matvec_2d(sg: ShardedGeno2D, v) -> torch.Tensor:
    """G v = Z_c Z_c^T v for a replicated v [indiv(, k)]: pad and shard
    it by "i", 't' (centered), the padded SNP rows masked, 'n' (centered),
    gathered back whole: [indiv, k] on the first local device."""
    zv = sharded_dgemm_2d(sg, pad_indiv_vec(sg, v), trans="t")
    zv = _mask_rows(zv, sg.spd, sg.snps)
    return gather_rows(sharded_dgemm_2d(sg, zv, trans="n"))[: sg.indiv]


def sharded_cg_solve_2d(sg: ShardedGeno2D, b, lam: float = 0.0,
                        center: bool = True, tol: float = 1e-2,
                        maxiter: int = 1000, mesh: Optional[Mesh] = None,
                        precondition: bool = False) -> CGResult:
    """(G + lam I) x = b over the 2D mesh, G = Z_c Z_c^T.  The CG runs on
    this process's own "i" rows (all rows in one process), its inner
    products summed over the processes of an "i" line; an iteration is one
    't' pass (psum over "i") and one 'n' pass (psum over "k").

    ``b``: [indiv] or [indiv, k].  ``x`` is row-sharded and padded (a
    :class:`RowSharded`, 1-D blocks for a 1-D ``b``); cut ``[:indiv]``."""
    m = _mesh_of(sg, mesh)
    ai = sg.axes[0]
    squeeze = torch.as_tensor(b).dim() == 1
    bp = pad_indiv_vec(sg, b, m)
    dev = sg.device
    b_loc = _local_rows(bp, dev)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    rows = torch.cat([torch.arange(blk.shape[0], device=dev) + a * sg.ipd
                      for a, blk in bp.held().items()])
    rowmask = (rows < sg.indiv).to(torch.float32)[:, None]
    grp = m.line_group(m.line_of(0, ai))

    def dot(u, v):
        return col.all_reduce_sum(m, torch.sum(u * v, dim=0), grp)

    def op(v):
        vs = _from_local_rows(bp, v)
        zv = sharded_dgemm_2d(sg, vs, trans="t", center=center, mesh=m)
        # centering subtracts a row constant from every output row, the
        # padding included: mask the padded SNP rows, and the padded
        # individuals below, so CG state stays exactly zero there
        zv = _mask_rows(zv, sg.spd, sg.snps)
        gv = _local_rows(sharded_dgemm_2d(sg, zv, trans="n", center=center,
                                          mesh=m), dev)
        return gv * rowmask + lam_t * v * rowmask

    minv = None
    if precondition:
        dg = _local_rows(sharded_grm_diag_2d(sg, center=center, mesh=m), dev)
        minv = jacobi_minv(dg + lam_t)
    res = cg(op, b_loc, tol=tol, maxiter=maxiter, minv=minv, dot=dot)
    x = _from_local_rows(bp, res.x)
    if squeeze:
        x = RowSharded([blk[:, 0] for blk in x.blocks], x.axis, x.rows, m)
    return CGResult(x, res.iterations, res.residual_norm)
