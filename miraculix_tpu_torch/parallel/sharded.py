"""SNP-sharded genotype linear algebra over a mesh of shards.

Torch twin of ``miraculix_tpu.parallel.sharded``.  The SNP axis is cut into
D shards of ``spd`` SNPs (padded to a multiple of 2048), and every shard
packs its own range in both planar16 orientations:

- ``zq_n[j]``: [indiv_pad, spd / 16], the planar16 packing of local shard
  j's SNP range (the global panel is the concatenation of the shards'
  packings, not a split of one global packing: planar16 is plane-local);
- ``zq_t[j]``: [spd, kw_indiv], rows are SNPs, so 't' products need no
  collective;
- ``freq[j]``: [spd], zero past the real SNPs.

The words equal the reference's bit for bit (:func:`from_reference_state`
and :func:`host_global` carry them across).  The per-shard products run the
port's kernels (``_local_mm``: the split-mode tall kernel up to 64 columns,
the wide kernel wider; ``packed_crossprod`` for the GRM) on each shard's
device; the centering epilogues are plain torch, and the partial products
merge through :mod:`._collectives`:

- dgemm 'n' (contract SNPs): local products + one psum, replicated result;
- dgemm 't' (contract individuals): row-parallel, a :class:`RowSharded`
  result;
- GRM: local integer crossproducts + psum (or psum_scatter: row-sharded);
- CG: the 't' output (sharded by SNPs) is exactly the 'n' input, so the
  GBLUP operator chains with one psum an iteration.

A replicated result is one tensor on the mesh's first local device; a
row-sharded one is a :class:`RowSharded`; :func:`host_global` turns either
into numpy on every process.  Each process packs and reads only its own
shards (:func:`shard_genotypes_from_bed` reads only their SNP ranges of the
``.bed``).
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..geno import _words
from ..io import bed as bedio
from ..io import codec, native
from ..ops.common import packed_indicator2, packed_row_sq_stats
from ..ops.dgemm import packed_matmul, packed_matmul_tall
from ..ops.grm import packed_crossprod
from ..solve.cg import CGResult, cg, jacobi_minv
from . import _collectives as col
from ._collectives import Mesh

SHARD_MULT = 2048   # spd and ipd pad to this: the kernels' 256 rows, 128 words


def _local_mm(zq_direct, zq_other, b, split: bool = True,
              real: Optional[int] = None):
    """One shard's packed product decode(zq_direct) @ b: the tall kernel on
    the other orientation for a skinny RHS (<= 64 columns, the CG case),
    the wide kernel otherwise.  ``real``: the contraction rows that can be
    nonzero (past them ``b`` and the words are padding): the product
    contracts only those, and a shard with none gives zeros."""
    tall = split and b.shape[1] <= 64 and b.shape[0] <= zq_other.shape[0]
    if real is not None and real < b.shape[0]:
        if real <= 0:
            rows = 16 * zq_other.shape[1] if tall else zq_direct.shape[0]
            return torch.zeros((rows, b.shape[1]), dtype=torch.float32,
                               device=b.device)
        b = b[:real]
    if tall:
        return packed_matmul_tall(zq_other, b)
    return packed_matmul(zq_direct, b, split=split)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_mesh(n_devices: Optional[int] = None, axis: str = "k", *,
              devices=None, group=None) -> Mesh:
    """1D mesh over the SNP (contraction) axis, spanning every process of
    ``group`` (default: the initialised process group, if any).

    ``devices``: this process's shards (repeats allowed: four shards on
    ``cuda:0``).  Otherwise ``n_devices`` shards in all (an equal part on
    each process) round-robin over the visible CUDA cards, or one shard per
    card; with no CUDA device and no ``devices`` it raises."""
    grp = group if group is not None else col.world_group()
    world = 1 if grp is None else dist.get_world_size(grp)
    if devices is None:
        if n_devices is not None and n_devices % world:
            raise ValueError(f"{n_devices} shards do not divide over "
                             f"{world} processes")
        devices = col.default_devices(
            None if n_devices is None else n_devices // world)
    elif n_devices is not None and n_devices != len(devices) * world:
        raise ValueError(f"n_devices={n_devices} but {len(devices)} local "
                         f"devices x {world} processes given")
    return Mesh((axis,), (len(devices) * world,), devices, grp)


def mesh_on(n: int, device: torch.device):
    """A 1D mesh of n shards: on the cards (round-robin over the visible
    ones), or n CPU shards when ``device`` is the CPU."""
    if device.type == "cpu":
        return make_mesh(devices=["cpu"] * n)
    return make_mesh(n)


@dataclasses.dataclass(eq=False)
class RowSharded:
    """A result row-sharded along a mesh axis: ``blocks[j]`` is local shard
    j's row block, the block of its coordinate along ``axis`` (local
    shards holding the same block share one tensor), and ``rows`` the row
    count of the global array (the blocks in block order, cut to
    ``rows``)."""

    blocks: list
    axis: str
    rows: int
    mesh: Mesh

    @property
    def index(self) -> tuple:
        """The block number of every global shard."""
        return tuple(self.mesh.coord(d, self.axis)
                     for d in range(self.mesh.size))

    def held(self) -> dict:
        """Block number -> tensor, for the blocks this process holds."""
        out, index = {}, self.index
        for j, d in enumerate(self.mesh.shard_ids):
            out.setdefault(index[d], self.blocks[j])
        return dict(sorted(out.items()))


def host_global(x) -> np.ndarray:
    """Any result as numpy on every process: a replicated tensor as it is,
    a :class:`RowSharded` gathered from every process (one all_gather over
    the mesh's group)."""
    if isinstance(x, RowSharded):
        parts = col.gather_shards(x.mesh, x.blocks)
        first = {}
        for d, b in enumerate(x.index):
            first.setdefault(b, parts[d])
        return torch.cat([first[b] for b in sorted(first)]
                         ).numpy()[: x.rows]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass(eq=False)
class ShardedGeno:
    """SNP-sharded genotype matrix (see the module docstring): ``zq_n``,
    ``zq_t`` and ``freq`` hold this process's shards, one tensor each on
    ``mesh.local_devices[j]``."""

    snps: int
    indiv: int
    spd: int                 # padded snps per shard (multiple of 2048)
    axis: str
    zq_n: list               # [indiv_pad, spd / 16] int32 a shard
    zq_t: list               # [spd, kw_indiv] int32 a shard
    freq: list               # [spd] f32 a shard, zero-padded
    mesh: Mesh

    def __post_init__(self):
        for z in self.zq_n + self.zq_t:
            if z.shape[0] % 256 or z.shape[1] % 128:
                raise ValueError(f"shard words {tuple(z.shape)}: rows must "
                                 "pad to 256 and words to 128")
        # 2 sum p (1 - p): psum of the shards' partial sums (every process
        # makes the container, so every process enters the collective)
        part = [torch.sum(f * (1.0 - f))[None] for f in self.freq]
        self._sigma2 = 2.0 * col.psum(self.mesh, self.axis, part)[0][0]

    @property
    def kw_local(self) -> int:
        return self.spd // 16

    @property
    def padded_snps(self) -> int:
        return self.mesh.size * self.spd

    @property
    def device(self) -> torch.device:
        """The mesh's first local device: replicated results live there."""
        return self.mesh.local_devices[0]

    @property
    def sigma2(self) -> torch.Tensor:
        return self._sigma2

    def real(self, j: int) -> int:
        """The real (unpadded) SNPs of local shard j."""
        return max(0, min(self.spd, self.snps - self.mesh.shard_ids[j]
                          * self.spd))

    def global_freq(self) -> np.ndarray:
        """The frequencies of every shard [D * spd], on every process."""
        return host_global(RowSharded(self.freq, self.axis,
                                      self.padded_snps, self.mesh))

    def __repr__(self) -> str:
        return (f"ShardedGeno(snps={self.snps}, indiv={self.indiv}, "
                f"spd={self.spd}, {self.mesh})")


def _dev(sg, j: int) -> torch.device:
    return sg.mesh.local_devices[j]


def _container(mesh: Mesh, snps, indiv, spd, axis, blocks) -> ShardedGeno:
    """ShardedGeno from per-local-shard numpy (zq_n, zq_t, freq)."""
    devs = mesh.local_devices
    return ShardedGeno(
        snps=int(snps), indiv=int(indiv), spd=int(spd), axis=axis,
        zq_n=[_words(b[0]).to(d) for b, d in zip(blocks, devs)],
        zq_t=[_words(b[1]).to(d) for b, d in zip(blocks, devs)],
        freq=[torch.tensor(np.asarray(b[2], np.float32), device=d)
              for b, d in zip(blocks, devs)],
        mesh=mesh)


def shard_genotypes(geno: np.ndarray, mesh: Mesh,
                    freq: Optional[np.ndarray] = None, axis: str = "k",
                    row_mult: int = 256) -> ShardedGeno:
    """Pack a dense genotype matrix [indiv, snps] into SNP shards: each
    process packs only its own shards, each an independent planar16
    packing of its range."""
    geno = np.asarray(geno, dtype=np.uint8)
    n_indiv, n_snps = geno.shape
    d = mesh.shape[axis]
    spd = _round_up(-(-n_snps // d), SHARD_MULT)
    if freq is None:
        freq = codec.allele_freq(geno, axis=0)
    freq_pad = np.zeros(d * spd, dtype=np.float32)
    freq_pad[:n_snps] = np.asarray(freq, dtype=np.float32)
    blocks = []
    for s in mesh.shard_ids:
        sl = geno[:, s * spd:(s + 1) * spd]
        pad = np.zeros((n_indiv, spd), dtype=np.uint8)
        pad[:, :sl.shape[1]] = np.where(sl == 3, 0, sl)
        blocks.append((codec.pack_planar16(pad, row_mult=row_mult),
                       codec.pack_planar16(codec.transpose_u8(pad),
                                           row_mult=8),
                       freq_pad[s * spd:(s + 1) * spd]))
    return _container(mesh, n_snps, n_indiv, spd, axis, blocks)


def shard_genotypes_from_bed(path: str, mesh: Mesh,
                             freq: Optional[np.ndarray] = None,
                             axis: str = "k",
                             row_mult: int = 256) -> ShardedGeno:
    """Each process reads and packs only the SNP ranges of its own shards
    (``io.bed.read_bed_slice_payload``, one read a shard) through the fused
    native ingestion where available; no process touches the whole
    panel."""
    d = mesh.shape[axis]
    n_indiv = bedio._count_lines(path[:-4] + ".fam")
    n_snps = bedio._count_lines(path[:-4] + ".bim")
    spd = _round_up(-(-n_snps // d), SHARD_MULT)
    kw_local = spd // 16
    ipad = codec.round_up(n_indiv, row_mult)
    kw_indiv = codec.round_up(max((n_indiv + 15) // 16, 1), codec.LANE)
    fglob = None
    if freq is not None:
        fglob = np.zeros(d * spd, np.float32)
        fglob[:n_snps] = np.asarray(freq, np.float32)

    blocks = []
    for s in mesh.shard_ids:
        s0 = s * spd
        payload, _, _ = bedio.read_bed_slice_payload(path, s0, s0 + spd)
        width = payload.shape[0]
        nat = None
        if width:
            nat = native.bed_ingest(payload, width, n_indiv, spd, kw_indiv,
                                    ipad, kw_local, want_pfreq=False)
        fpad = np.zeros(spd, dtype=np.float32)
        if nat is not None:
            zqt, zqn, fr, _ = nat
            fpad[:width] = fr
        else:
            sl = (codec.payload_to_dense(payload, n_indiv).T if width
                  else np.zeros((n_indiv, 0), np.uint8))
            pad = np.zeros((n_indiv, spd), dtype=np.uint8)
            pad[:, :width] = np.where(sl == 3, 0, sl)
            zqn = codec.pack_planar16(pad, row_mult=row_mult)
            zqt = codec.pack_planar16(codec.transpose_u8(pad), row_mult=8)
            fpad[:width] = codec.allele_freq(np.ascontiguousarray(sl), axis=0)
        if fglob is not None:
            fpad = fglob[s0:s0 + spd]
        blocks.append((zqn, zqt, fpad))
    return _container(mesh, n_snps, n_indiv, spd, axis, blocks)


def from_reference_state(d: dict, mesh: Mesh) -> ShardedGeno:
    """Build from the reference ShardedGeno's fields as numpy arrays: keys
    ``snps``, ``indiv``, ``spd``, ``axis`` and the global ``zq_n`` [ipad,
    D * kw_local], ``zq_t`` [D * spd, kw_indiv] and ``freq`` [D * spd], as
    ``host_global`` gives them.  Each process keeps its own shards."""
    axis = str(d["axis"])
    spd = int(d["spd"])
    kwl = spd // 16
    zq_n, zq_t, freq = (np.asarray(d["zq_n"]), np.asarray(d["zq_t"]),
                        np.asarray(d["freq"]))
    n_sh = mesh.shape[axis]
    if zq_t.shape[0] != n_sh * spd or zq_n.shape[1] != n_sh * kwl:
        raise ValueError(
            f"panel was sharded over {zq_t.shape[0] // spd} devices; it can "
            f"only be reloaded onto a {zq_t.shape[0] // spd}-device mesh "
            f"(got {n_sh}) — re-shard from source to change device counts")
    blocks = [(zq_n[:, s * kwl:(s + 1) * kwl], zq_t[s * spd:(s + 1) * spd],
               freq[s * spd:(s + 1) * spd]) for s in mesh.shard_ids]
    return _container(mesh, d["snps"], d["indiv"], spd, axis, blocks)


def _mesh_of(sg, mesh: Optional[Mesh]) -> Mesh:
    if mesh is not None and mesh is not sg.mesh:
        raise ValueError("the panel's shards live on another mesh")
    return sg.mesh


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t[:, None] if t.dim() == 1 else t


def _shard_vec(sg: ShardedGeno, w) -> list:
    """A per-SNP vector sharded like ``freq``: a list of local blocks as it
    is, a global [D * spd] (or [snps]) array cut into this process's
    blocks."""
    if isinstance(w, (list, tuple)):
        return [torch.as_tensor(x, dtype=torch.float32, device=_dev(sg, j))
                for j, x in enumerate(w)]
    w = torch.as_tensor(w, dtype=torch.float32).reshape(-1)
    full = torch.zeros(sg.padded_snps, dtype=torch.float32, device=w.device)
    full[: w.shape[0]] = w
    return [full[s * sg.spd:(s + 1) * sg.spd].to(_dev(sg, j))
            for j, s in enumerate(sg.mesh.shard_ids)]


def _snp_blocks(sg: ShardedGeno, b) -> list:
    """A [<= D * spd, n] SNP-row array cut into this process's [spd, n]
    blocks (zero past its rows)."""
    b = _tensor(b, sg.device)
    full = torch.zeros((sg.padded_snps, b.shape[1]), dtype=torch.float32,
                       device=b.device)
    full[: b.shape[0]] = b
    return [full[s * sg.spd:(s + 1) * sg.spd].to(_dev(sg, j))
            for j, s in enumerate(sg.mesh.shard_ids)]


def _replicas(sg, b) -> list:
    """``b`` on every local shard's device (one copy a device)."""
    b = _tensor(b, sg.device)
    cache = {}
    return [cache.setdefault(str(d), b.to(d)) for d in sg.mesh.local_devices]


def _row_sharded(sg: ShardedGeno, blocks: list, rows: int) -> RowSharded:
    return RowSharded(blocks, sg.axis, rows, sg.mesh)


# ---------------------------------------------------------------------------
# Sharded ops: each shard's product on its device, merged by a collective
# ---------------------------------------------------------------------------

def sharded_dgemm(sg: ShardedGeno, b, trans: str = "n", center: bool = True,
                  mesh: Optional[Mesh] = None, split: bool = True):
    """dgemm over the mesh.

    'n': B [snps, n] (the same on every process), C [indiv, n] replicated
    (one psum).  't': B [indiv, n], C [snps, n] row-sharded by SNPs (no
    collective), a :class:`RowSharded`."""
    m = _mesh_of(sg, mesh)
    trans = trans.lower()
    if trans == "n":
        parts = []
        for j, bl in enumerate(_snp_blocks(sg, b)):
            c = _local_mm(sg.zq_n[j], sg.zq_t[j], bl, split=split,
                          real=sg.real(j))
            if center:
                c = c - 2.0 * (sg.freq[j] @ bl)[None, :]
            parts.append(c)
        return col.psum(m, sg.axis, parts)[0][: sg.indiv]
    if trans != "t":
        raise ValueError(f"trans must be 'n' or 't', got {trans!r}")
    blocks = []
    for j, br in enumerate(_replicas(sg, b)):
        c = _local_mm(sg.zq_t[j], sg.zq_n[j], br, split=split)
        if center:
            c = c - 2.0 * sg.freq[j][:, None] * br.sum(dim=0)[None, :]
        blocks.append(c)
    return _row_sharded(sg, blocks, sg.snps)


def _check_int32(snps: int) -> None:
    if 4 * snps >= 2 ** 31:
        # each shard's kernel passes its own exactness check, but the int32
        # sum across shards can still wrap: the single-panel limit holds
        raise ValueError(
            f"{snps} total SNPs could overflow the exact int32 GRM "
            "accumulator across the psum (limit ~536M); chunk the SNP "
            "axis and sum f64 partials")


def sharded_crossprod(sg: ShardedGeno, scatter: bool = False,
                      mesh: Optional[Mesh] = None):
    """The raw integer crossproduct Z Z^T [ipad, ipad], int32 and exact:
    each shard's ``packed_crossprod`` summed over the mesh (replicated), or
    with ``scatter`` its rows scattered over the shards (a
    :class:`RowSharded`)."""
    m = _mesh_of(sg, mesh)
    _check_int32(sg.snps)
    parts = [packed_crossprod(z) for z in sg.zq_n]
    if scatter:
        return _row_sharded(sg, col.psum_scatter(m, sg.axis, parts),
                            parts[0].shape[0])
    return col.psum(m, sg.axis, parts)[0]


def _per_line(parts: list, fn) -> list:
    """``fn(j, part)`` once for each distinct tensor of a per-shard list
    (the local shards of one line share a collective's result)."""
    done, out = {}, []
    for j, p in enumerate(parts):
        if id(p) not in done:
            done[id(p)] = fn(j, p)
        out.append(done[id(p)])
    return out


def _real(length: int, start: int, n: int, device) -> torch.Tensor:
    """f32 0/1 mask of the global indices start .. start + length - 1 that
    are below n."""
    return ((torch.arange(length, device=device) + start) < n).to(
        torch.float32)


def _finish_block(raw, r0: int, n: int, total_vec, sigma2, scale: bool):
    """The VanRaden / Schlather finish of a raw crossproduct row block
    starting at global row r0 (padded rows and columns are exactly zero):
    m - colsum_j / n - rowsum_i / n + total / n^2 over the real rows and
    columns, / sigma2, the padding masked to zero."""
    m = raw.to(torch.float32)
    mask = _real(m.shape[1], 0, n, m.device)
    tv = total_vec.to(m.device)
    rowsum = m @ mask
    total = torch.sum(tv * mask)
    m = m - tv[None, :] / n - rowsum[:, None] / n + total / (n * n)
    if scale:
        m = m / sigma2.to(m.device)
    return m * _real(m.shape[0], r0, n, m.device)[:, None] * mask[None, :]


def _finish(raw: RowSharded, step: int, n: int, sigma2, scale: bool,
            axis: str) -> RowSharded:
    """:func:`_finish_block` on every block of a row-sharded raw
    crossproduct (blocks of ``step`` rows), its column sums summed over the
    blocks by a psum along ``axis``."""
    mesh = raw.mesh
    index = raw.index

    def r0(j):
        return index[mesh.shard_ids[j]] * step

    parts = _per_line(raw.blocks, lambda j, blk: _real(
        blk.shape[0], r0(j), n, blk.device) @ blk.to(torch.float32))
    tv = col.psum(mesh, axis, parts)
    out = _per_line(raw.blocks, lambda j, blk: _finish_block(
        blk, r0(j), n, tv[j], sigma2, scale))
    return RowSharded(out, raw.axis, raw.rows, mesh)


def sharded_grm(sg: ShardedGeno, scale: bool = True, scatter: bool = False,
                mesh: Optional[Mesh] = None):
    """GRM over the mesh: each shard's integer crossproduct, psum-merged
    (exact int32), finished in f32.  Replicated [indiv, indiv], or with
    ``scatter=True`` row-sharded [ipad, ipad] (the rows and columns past
    indiv are zero), the layout a distributed solver wants."""
    m = _mesh_of(sg, mesh)
    raw = sharded_crossprod(sg, scatter=scatter, mesh=m)
    n = sg.indiv
    if scatter:
        return _finish(raw, raw.blocks[0].shape[0], n, sg.sigma2, scale,
                       sg.axis)
    tv = _real(raw.shape[0], 0, n, raw.device) @ raw.to(torch.float32)
    return _finish_block(raw, 0, n, tv, sg.sigma2, scale)[:n, :n]


def sharded_grm_matvec(sg: ShardedGeno, v, center: bool = True,
                       mesh: Optional[Mesh] = None, snp_weights=None):
    """G v in one pass: each shard's 't' product chains into its 'n'
    product, one psum (the sharded GBLUP operator).  ``v`` [indiv(, k)],
    the same on every process; returns [indiv, k] replicated.

    ``snp_weights`` ([D * spd] or per-shard blocks, zero on padding):
    per-SNP weights w applied between the passes, giving
    sum_s w_s (z_s - 2 f_s)(z_s - 2 f_s)^T v; a 0/1 off-chromosome mask
    makes it the exact LOCO operator with no repacking."""
    m = _mesh_of(sg, mesh)
    ws = None if snp_weights is None else _shard_vec(sg, snp_weights)
    parts = []
    for j, vr in enumerate(_replicas(sg, v)):
        zv = _local_mm(sg.zq_t[j], sg.zq_n[j], vr)
        f = sg.freq[j]
        if center:
            zv = zv - 2.0 * f[:, None] * vr.sum(dim=0)[None, :]
        if ws is not None:
            zv = zv * ws[j][:, None]
        gv = _local_mm(sg.zq_n[j], sg.zq_t[j], zv, real=sg.real(j))
        if center:
            gv = gv - 2.0 * (f @ zv)[None, :]
        parts.append(gv)
    return col.psum(m, sg.axis, parts)[0][: sg.indiv]


def sharded_snp_sq_stats(sg: ShardedGeno, mesh: Optional[Mesh] = None):
    """Per-SNP sum_i z_is^2 = diag(Z^T Z), exactly: rows of ``zq_t`` are
    SNPs, so no collective.  A :class:`RowSharded` of [snps]."""
    _mesh_of(sg, mesh)
    return _row_sharded(sg, [packed_row_sq_stats(z) for z in sg.zq_t],
                        sg.snps)


def sharded_indicator2_dgemm_t(sg: ShardedGeno, b,
                               mesh: Optional[Mesh] = None):
    """I2^T b, I2 the packed genotype == 2 indicator panel: row-parallel
    like the 't' pass, no collective ([snps, n] row-sharded).  Feeds
    sum_i w_i z_is^2 = (Z^T w)_s + 2 (I2^T w)_s."""
    _mesh_of(sg, mesh)
    blocks = [_local_mm(packed_indicator2(sg.zq_t[j]),
                        packed_indicator2(sg.zq_n[j]), br)
              for j, br in enumerate(_replicas(sg, b))]
    return _row_sharded(sg, blocks, sg.snps)


def sharded_weighted_grm_diag(sg: ShardedGeno, snp_weights,
                              mesh: Optional[Mesh] = None):
    """diag of the SNP-weighted centered operator, exactly:

        d_i = sum_s w_s (z_is - 2 f_s)^2
            = sum w z^2 - 4 sum w f z + 4 sum w f^2,
        sum_s w_s z_is^2 = (Z w)_i + 2 (I2 w)_i

    three skinny 'n' products a shard and one psum: the Jacobi
    preconditioner of the sharded LOCO solve.  [indiv] replicated."""
    m = _mesh_of(sg, mesh)
    parts = []
    for j, w in enumerate(_shard_vec(sg, snp_weights)):
        f = sg.freq[j]
        rows = sg.zq_n[j].shape[0]
        zw = _local_mm(sg.zq_n[j], sg.zq_t[j], torch.stack([w, w * f], dim=1),
                       real=sg.real(j))[:rows]
        iw = _local_mm(packed_indicator2(sg.zq_n[j]),
                       packed_indicator2(sg.zq_t[j]), w[:, None],
                       real=sg.real(j))[:rows]
        const = torch.sum(w * f * f)
        parts.append(zw[:, 0] + 2.0 * iw[:, 0] - 4.0 * zw[:, 1]
                     + 4.0 * const)
    return col.psum(m, sg.axis, parts)[0][: sg.indiv]


def sharded_grm_diag(sg: ShardedGeno, center: bool = True,
                     mesh: Optional[Mesh] = None):
    """diag(Z_c Z_c^T) across the mesh, exactly: sum z^2 and sum f z are
    additive over the SNP shards, merged with one psum.  [indiv]
    replicated; feeds the sharded Jacobi PCG."""
    m = _mesh_of(sg, mesh)
    parts = []
    for j in range(m.n_local):
        d = packed_row_sq_stats(sg.zq_n[j])
        if center:
            f = sg.freq[j]
            # the tall output pads to 16 kw_indiv rows: cut to zq_n's rows
            fz = _local_mm(sg.zq_n[j], sg.zq_t[j], f[:, None],
                           real=sg.real(j))[: sg.zq_n[j].shape[0], 0]
            d = d - 4.0 * fz + 4.0 * torch.sum(f * f)
        parts.append(d)
    return col.psum(m, sg.axis, parts)[0][: sg.indiv]


def sharded_cg_solve(sg: ShardedGeno, b, lam: float = 0.0,
                     center: bool = True, tol: float = 1e-2,
                     maxiter: int = 1000, mesh: Optional[Mesh] = None,
                     precondition: bool = False,
                     scale: bool = False) -> CGResult:
    """(G + lam I) x = b across the mesh, one psum an iteration
    (``precondition=True`` adds the sharded exact diagonal once and a
    Jacobi multiply an iteration).  ``scale=True`` divides G by
    sigma2 = 2 sum p (1 - p).  Every vector is replicated; the stop test
    reads bits that are equal on every process."""
    m = _mesh_of(sg, mesh)
    s2 = sg.sigma2 if scale else torch.ones((), device=sg.device)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=sg.device)
    b = torch.as_tensor(b, dtype=torch.float32, device=sg.device)

    def op(v):
        gv = sharded_grm_matvec(sg, v, center=center, mesh=m)
        return gv / s2 + lam_t * v

    minv = None
    if precondition:
        minv = jacobi_minv(sharded_grm_diag(sg, center=center, mesh=m) / s2
                           + lam_t)
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


def sharded_loco_cg_solve(sg: ShardedGeno, snp_weights, b, s2_loco, lam, *,
                          tol: float, maxiter: int,
                          mesh: Optional[Mesh] = None) -> CGResult:
    """The LOCO solve (G_w / s2_loco + lam I) x = b, G_w the operator with
    the 0/1 off-chromosome mask ``snp_weights`` between its passes
    (:func:`sharded_grm_matvec`), preconditioned by the matching weighted
    diagonal.  The mask is an argument: every chromosome runs the same
    shards."""
    m = _mesh_of(sg, mesh)
    ws = _shard_vec(sg, snp_weights)
    s2 = torch.as_tensor(s2_loco, dtype=torch.float32, device=sg.device)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=sg.device)
    b = torch.as_tensor(b, dtype=torch.float32, device=sg.device)

    def op(v):
        gv = sharded_grm_matvec(sg, v, center=True, mesh=m, snp_weights=ws)
        return gv / s2 + lam_t * v

    minv = jacobi_minv(sharded_weighted_grm_diag(sg, ws, mesh=m) / s2
                       + lam_t)
    return cg(op, b, tol=tol, maxiter=maxiter, minv=minv)


# ---------------------------------------------------------------------------
# checkpoints and the multi-process bootstrap
# ---------------------------------------------------------------------------

def _global_words(sg: ShardedGeno) -> tuple:
    """(zq_n, zq_t, freq) as the reference's global numpy arrays."""
    n_parts = col.gather_shards(sg.mesh, sg.zq_n)
    t_parts = col.gather_shards(sg.mesh, sg.zq_t)
    f_parts = col.gather_shards(sg.mesh, sg.freq)
    return (torch.cat(n_parts, dim=1).numpy().view(np.uint32),
            torch.cat(t_parts).numpy().view(np.uint32),
            torch.cat(f_parts).numpy())


def save_sharded(path: str, sg: ShardedGeno) -> None:
    """Checkpoint a sharded panel in the reference's ``.npz`` keys and
    global layout (a checkpoint of either package loads in the other),
    stored uncompressed: 2-bit words deflate by only ~30%, at ~8 MB/s
    of zlib on a host core.  The gather is a collective every process enters;
    rank 0 writes, and a barrier holds the others until the file is
    complete."""
    zq_n, zq_t, freq = _global_words(sg)
    if sg.mesh.rank == 0:
        np.savez(path, snps=sg.snps, indiv=sg.indiv, spd=sg.spd,
                 axis=sg.axis, zq_n=zq_n, zq_t=zq_t, freq=freq)
    col.barrier(sg.mesh)


def load_sharded(path: str, mesh: Mesh) -> ShardedGeno:
    """Inverse of :func:`save_sharded`, onto a mesh with the shard count
    the panel was saved with (``zq_n`` concatenates per-shard packings;
    another split would scramble the plane-to-SNP mapping); ValueError
    otherwise.  Re-shard from the source to change the count."""
    with np.load(path) as z:
        d = {k: z[k] for k in ("snps", "indiv", "spd", "axis", "zq_n",
                               "zq_t", "freq")}
    return from_reference_state(d, mesh)


def init_distributed(coordinator_address: str = None,
                     num_processes: int = None, process_id: int = None, *,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout_s: Optional[float] = None,
                     device_id=None) -> int:
    """Start the process group and return this process's rank.

    ``coordinator_address`` ("host:port") becomes a ``tcp://`` rendezvous;
    ``init_method`` (e.g. ``file://<path>``, a FileStore) is taken as it
    is; with neither, torchrun's environment (``env://``).  ``backend``:
    "nccl" where CUDA is available, else "gloo"; ``timeout_s`` bounds every
    collective, so a dead peer ends the survivors with an error instead of
    a hang; ``device_id`` binds an NCCL group to its card."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None:
        init_method = ("env://" if coordinator_address is None
                       else f"tcp://{coordinator_address}")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if device_id is not None:
        kwargs["device_id"] = torch.device(device_id)
    dist.init_process_group(backend=backend, init_method=init_method,
                            **kwargs)
    return dist.get_rank()
