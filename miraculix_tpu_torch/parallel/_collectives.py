"""The mesh and its collectives, over ``torch.distributed``.

The reference gets its collectives from ``jax.shard_map``; here a
:class:`Mesh` is plain Python.  Its shards are numbered process-major, as
JAX orders ``jax.devices()``: global shard ``rank * n_local + j`` is this
process's local shard ``j``, on ``local_devices[j]`` (devices may repeat:
four shards on ``cuda:0`` is a legal mesh).  A multi-axis mesh lays the
global shards out row-major over its axes.

A *line* along an axis is the set of shards whose other coordinates agree.
Every collective works line by line, in one global order of the lines:

1. the parts of this process's shards on one line are summed (gathered) in
   shard order onto the line's first local device;
2. where the line spans more than one process, one ``torch.distributed``
   call over the group of that line's processes finishes it.  The groups
   are made once, when the mesh is made, in the same order on every
   process (``dist.new_group`` must be entered by every process, members
   or not).

The backend follows the shards' device type: NCCL for CUDA shards, gloo
for CPU shards; a mesh whose process group has the other backend is
refused when it is made.  :data:`COLLECTIVES` counts every collective
(calls and the bytes of the parts that entered it), and every
``torch.distributed`` call apart under ``"dist.<name>"``.
"""
from __future__ import annotations

import collections
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# op -> {"calls": n, "bytes": b} since the last reset_collective_counts()
COLLECTIVES: collections.defaultdict = collections.defaultdict(
    lambda: {"calls": 0, "bytes": 0})


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _count(op: str, tensors) -> None:
    c = COLLECTIVES[op]
    c["calls"] += 1
    c["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def _dist_call(name: str, fn, tensor, *args, **kwargs):
    _count(f"dist.{name}", [tensor])
    fn(*args, **kwargs)


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` that an in-place collective may write
    without touching the caller's tensor.  NCCL refuses strided tensors (a
    kernel's transposed output is one), so a collective's read-only input
    is passed ``.contiguous()`` for every backend."""
    return t.clone(memory_format=torch.contiguous_format)


class Mesh:
    """A mesh of shards over the processes of a ``torch.distributed``
    group (or one process with no group).

    - ``axis_names``: the axes, e.g. ``("k",)`` or ``("i", "k")``;
    - ``shape``: axis -> its size (as ``jax.sharding.Mesh.shape``);
    - ``local_devices``: one ``torch.device`` per local shard;
    - ``group``: the process group (None: one process, no group);
    - ``rank``, ``world``: this process's rank and the group's size.
    """

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 local_devices: Sequence, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.local_devices = [torch.device(d) for d in local_devices]
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        self.n_local = len(self.local_devices)
        self.size = 1
        for s in self.shape.values():
            self.size *= s
        if self.n_local < 1 or self.size != self.n_local * self.world:
            raise ValueError(
                f"a mesh of shape {self.shape} needs {self.size} shards; "
                f"{self.world} processes x {self.n_local} local shards given")
        types = {d.type for d in self.local_devices}
        if len(types) != 1:
            raise ValueError(f"mixed device types in one mesh: {types}")
        self.device_type = types.pop()
        if group is not None:
            want = "nccl" if self.device_type == "cuda" else "gloo"
            have = str(dist.get_backend(group))
            if want not in have:
                raise ValueError(
                    f"{self.device_type} shards need the {want} backend; the "
                    f"process group runs {have}")
        self.shard_ids = [self.rank * self.n_local + j
                          for j in range(self.n_local)]
        self._lines = {ax: self._make_lines(ax) for ax in self.axis_names}
        self._groups = {}
        for ax in self.axis_names:           # every process, in one order
            for line in self._lines[ax]:
                ranks = self.line_ranks(line)
                if len(ranks) > 1 and ranks not in self._groups:
                    self._groups[ranks] = (
                        group if len(ranks) == self.world
                        else dist.new_group(list(ranks)))

    # -- geometry -------------------------------------------------------
    def coords(self, d: int) -> dict:
        """Axis -> coordinate of global shard ``d`` (row-major)."""
        out = {}
        for ax in reversed(self.axis_names):
            out[ax] = d % self.shape[ax]
            d //= self.shape[ax]
        return out

    def coord(self, d: int, axis: str) -> int:
        return self.coords(d)[axis]

    def _make_lines(self, axis: str) -> list:
        lines = collections.OrderedDict()
        for d in range(self.size):
            key = tuple(v for ax, v in self.coords(d).items() if ax != axis)
            lines.setdefault(key, []).append(d)
        return [tuple(v) for v in lines.values()]

    def lines(self, axis: str) -> list:
        """The lines along ``axis``, each a tuple of global shards in
        order, in one global order."""
        return self._lines[axis]

    def line_ranks(self, line) -> tuple:
        return tuple(sorted({d // self.n_local for d in line}))

    def line_group(self, line):
        """The process group of a line spanning several processes, else
        None."""
        return self._groups.get(self.line_ranks(line))

    def local_on(self, line) -> list:
        """Local shard indices j on ``line``, in shard order."""
        return [j for j, d in enumerate(self.shard_ids) if d in line]

    def line_of(self, j: int, axis: str):
        """The line along ``axis`` through local shard ``j``."""
        d = self.shard_ids[j]
        return next(ln for ln in self._lines[axis] if d in ln)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}/{self.world}, "
                f"local {[str(d) for d in self.local_devices]})")


def _local_lines(mesh: Mesh, axis: str):
    """(line, local shard indices on it, its group) for every line this
    process holds a shard of, in the global order."""
    for line in mesh.lines(axis):
        js = mesh.local_on(line)
        if js:
            yield line, js, mesh.line_group(line)


def _check_blocks(mesh: Mesh, line, js) -> int:
    """Rows of the line's blocks that each process owns must be contiguous
    and equal in count (the process-major layout gives this)."""
    pos = [line.index(mesh.shard_ids[j]) for j in js]
    if pos != list(range(pos[0], pos[0] + len(pos))):
        raise ValueError("a process's shards on a line are not contiguous")
    if len(line) % len(js):
        raise ValueError("processes hold unequal parts of a line")
    return pos[0]


def psum(mesh: Mesh, axis: str, parts: Sequence[torch.Tensor]) -> list:
    """Sum over ``axis``: ``parts`` holds one tensor per local shard (equal
    shapes); returns, per local shard, the sum over its line, one tensor
    shared by the local shards of a line, on the line's first local
    device.  Identical bits on every process of a line."""
    _count("psum", parts)
    out = [None] * mesh.n_local
    for line, js, grp in _local_lines(mesh, axis):
        dev = mesh.local_devices[js[0]]
        acc = parts[js[0]].to(dev)
        for j in js[1:]:
            acc = acc + parts[j].to(dev)
        if grp is not None:
            # one local shard: acc is still the caller's part
            acc = _own(acc) if len(js) == 1 else acc.contiguous()
            _dist_call("all_reduce", dist.all_reduce, acc, acc, group=grp)
        for j in js:
            out[j] = acc
    return out


def psum_scatter(mesh: Mesh, axis: str, parts: Sequence[torch.Tensor]
                 ) -> list:
    """Sum over ``axis`` and scatter the rows (``tiled=True`` along dim 0):
    the shard at position p of a line of L shards gets rows
    [p R / L, (p + 1) R / L) of the line's sum [R, ...]."""
    _count("psum_scatter", parts)
    out = [None] * mesh.n_local
    for line, js, grp in _local_lines(mesh, axis):
        rows = parts[js[0]].shape[0]
        if rows % len(line):
            raise ValueError(f"{rows} rows do not scatter over {len(line)} "
                             "shards")
        step = rows // len(line)
        dev = mesh.local_devices[js[0]]
        acc = parts[js[0]].to(dev)
        for j in js[1:]:
            acc = acc + parts[j].to(dev)
        p0 = _check_blocks(mesh, line, js)
        if grp is not None:
            mine = torch.empty((step * len(js),) + tuple(acc.shape[1:]),
                               dtype=acc.dtype, device=dev)
            _dist_call("reduce_scatter_tensor", dist.reduce_scatter_tensor,
                       acc, mine, acc.contiguous(), group=grp)
            p0 = 0
        else:
            mine = acc
        for k, j in enumerate(js):
            out[j] = mine[(p0 + k) * step:(p0 + k + 1) * step].to(
                mesh.local_devices[j])
    return out


def all_gather(mesh: Mesh, axis: str, parts: Sequence[torch.Tensor]) -> list:
    """Concatenate the parts of each line along dim 0 in line order
    (``tiled=True``): per local shard, its line's gathered tensor, shared
    by the local shards of a line, on the line's first local device."""
    _count("all_gather", parts)
    out = [None] * mesh.n_local
    for line, js, grp in _local_lines(mesh, axis):
        dev = mesh.local_devices[js[0]]
        mine = torch.cat([parts[j].to(dev) for j in js])
        _check_blocks(mesh, line, js)
        if grp is not None:
            full = torch.empty((mine.shape[0] * len(line) // len(js),)
                               + tuple(mine.shape[1:]), dtype=mine.dtype,
                               device=dev)
            _dist_call("all_gather_into_tensor", dist.all_gather_into_tensor,
                       mine, full, mine, group=grp)
            mine = full
        for j in js:
            out[j] = mine
    return out


def gather_shards(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list:
    """Every shard's part, in global order, as CPU tensors on every process
    (one ``all_gather_into_tensor`` over the mesh's group where there is
    one).  The parts must have one shape."""
    _count("gather_shards", parts)
    dev = mesh.local_devices[0]
    mine = torch.stack([p.to(dev) for p in parts])
    if mesh.group is not None:
        full = torch.empty((mesh.size,) + tuple(mine.shape[1:]),
                           dtype=mine.dtype, device=dev)
        _dist_call("all_gather_into_tensor", dist.all_gather_into_tensor,
                   mine, full, mine, group=mesh.group)
        mine = full
    return list(mine.cpu().unbind(0))


def all_reduce_sum(mesh: Mesh, t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s processes (``t`` itself with no
    group).  The sum may be written into ``t``: pass a tensor of the
    caller's own making."""
    if group is None:
        return t
    t = t.contiguous()
    _dist_call("all_reduce", dist.all_reduce, t, t, group=group)
    return t


def barrier(mesh: Mesh) -> None:
    if mesh.group is not None:
        _count("dist.barrier", [])
        dist.barrier(group=mesh.group)


def world_group():
    """The default process group, or None where none is initialised."""
    return dist.group.WORLD if (dist.is_available()
                                and dist.is_initialized()) else None


def default_devices(n_local: Optional[int]) -> list:
    """This process's shards on the CUDA cards, never on the CPU unasked:
    ``n_local`` shards round-robin over the visible cards, or with None one
    shard per visible card (in a multi-process group, one process per card:
    the card of its local rank)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh places its shards on the card unless "
            "devices are given (devices=['cpu'] * n for n CPU shards)")
    count = torch.cuda.device_count()
    if n_local is None:
        if world_group() is not None and dist.get_world_size() > 1:
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            return [torch.device("cuda", local % count)]
        n_local = count
    return [torch.device("cuda", j % count) for j in range(n_local)]
