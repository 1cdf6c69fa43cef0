"""Serving meshes over ``torch.distributed`` ranks.

The JAX package serves from one controller over a device mesh: a
``jax.make_mesh`` of ``("data", "index")`` (or ``("data", "model")``) axes,
with ``shard_map`` bodies calling ``lax.psum`` / ``pmax`` / ``all_gather``
over an axis. The port is multi-controller SPMD: every rank runs the same
front-door call on the same batch, and a ``ServingMesh`` tells it where it
sits. The ranks are laid out as the reference lays out its devices, row
major over ``(data, second axis)``: rank ``r`` has data coordinate
``r // n_second`` and second-axis coordinate ``r % n_second``. Each axis is
a ``MeshAxis`` with one process group per line of ranks along it (the
reference's collectives over that axis name), and its collectives:

====================  ==========================================
reference             port (``MeshAxis``)
====================  ==========================================
``lax.psum``          ``psum``: ``all_reduce(SUM)``
``lax.pmax``          ``pmax``: ``all_reduce(MAX)``
``lax.all_gather``    ``all_gather``: ``all_gather_into_tensor``
(``tiled=True``)      ``all_gather_dim``: the blocks joined along
                      one dimension
====================  ==========================================

``make_production_mesh`` (the TPU pod shapes) has no counterpart; its
role in the dry run, a mesh of placeholder devices that allocates nothing,
is ``make_abstract_mesh``: named axes with sizes and this rank's
coordinates but no process group, whose collectives return ``meta``
tensors of the right shapes.

Autograd passes through ``psum``, ``pvary`` and ``all_gather`` with the
transposes JAX gives them in the reference's ``shard_map(...,
check_vma=False)``, where an output's cotangent is divided by the axes its
``out_specs`` leave out and an input's cotangent summed over the axes its
``in_specs`` leave out:

=====================  ===========================  =========================
collective             forward                      backward
=====================  ===========================  =========================
``psum``               all-reduce                   the cotangent as it is
                                                    (it is the same on every
                                                    rank of the axis)
``pvary``              the tensor as it is (one     all-reduce: a value
                       replicated over the axis     replicated over the axis
                       enters a per-rank region)    sums its ranks' cotangents
``all_gather``         all-gather                   ``psum_scatter``
                                                    (reduce-scatter): each
                                                    rank keeps the sum of its
                                                    own block
``all_gather_dim``     all-gather, joined along     reduce-scatter along the
                       ``dim``                      same dimension
``all_gather_``        the same                     this rank's block of the
``invariant``                                       cotangent, moving nothing
                                                    (every rank computed the
                                                    same whole one)
=====================  ===========================  =========================

Every collective of a ``MeshAxis``, real or abstract, forward or
backward, adds its result bytes per device to the ``CollectiveCensus``
that ``collective_census()`` opens, by axis and by operation
(``all-reduce`` for ``psum`` / ``pmax``, ``all-gather`` for
``all_gather``, ``reduce-scatter`` for ``psum_scatter``: the names and the
byte count of the reference dry run's ``parse_collective_bytes``). A real
run and a dry run of the same program therefore count the same integers.
The census is one per process, not per thread: the backward of CUDA
tensors (and a ``remat`` recompute inside it) runs on autograd's device
thread.

The caller starts the process group (``init_process_group`` with its
address, world size and rank); a mesh of one rank needs none. NCCL takes
one card per rank. Gloo also runs these collectives on CUDA tensors, which
is how ranks that share one card serve (NCCL refuses two ranks on one
GPU); no collective is copied through the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import resolve_device


class CollectiveCensus:
    """Result bytes per device and calls of every collective made while it
    is open, by axis and by operation: ``bytes[axis][op]`` and
    ``counts[axis][op]``."""

    def __init__(self) -> None:
        self.bytes: Dict[str, Dict[str, int]] = {}
        self.counts: Dict[str, Dict[str, int]] = {}

    def add(self, axis: str, op: str, nbytes: int) -> None:
        by_op = self.bytes.setdefault(axis, {})
        by_op[op] = by_op.get(op, 0) + int(nbytes)
        calls = self.counts.setdefault(axis, {})
        calls[op] = calls.get(op, 0) + 1

    def by_op(self) -> Dict[str, int]:
        """Bytes by operation, summed over the axes."""
        out: Dict[str, int] = {}
        for by_op in self.bytes.values():
            for op, n in by_op.items():
                out[op] = out.get(op, 0) + n
        return out

    def total(self) -> int:
        return sum(self.by_op().values())


_CENSUS: list = [None]  # the open census of this process (any thread)


@contextlib.contextmanager
def collective_census() -> Iterator[CollectiveCensus]:
    """A fresh ``CollectiveCensus`` that every ``MeshAxis`` collective adds
    to until the block ends (the census open before it is restored)."""
    census = CollectiveCensus()
    before, _CENSUS[0] = _CENSUS[0], census
    try:
        yield census
    finally:
        _CENSUS[0] = before


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class MeshAxis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    coordinate ``index`` on it, and the process group of the ranks that
    share every other coordinate (None when the axis has one rank, so its
    collectives are the identity). An ``abstract`` axis has no group at
    any size: its collectives take ``meta`` tensors and return ``meta``
    tensors of the result's shape."""

    name: str
    size: int
    index: int
    group: Optional[object]
    abstract: bool = False

    def _active(self, t: torch.Tensor) -> bool:
        """Whether a collective on ``t`` moves data (and is counted)."""
        if self.abstract:
            if t.device.type != "meta":
                raise ValueError(f"an abstract axis takes meta tensors, got {t.device}")
            return self.size > 1
        return self.group is not None

    def _count(self, op: str, nbytes: int) -> None:
        census = _CENSUS[0]
        if census is not None:
            census.add(self.name, op, nbytes)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        self._count("all-reduce", _nbytes(t))
        out = t.clone()
        if not self.abstract:
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
        self._count("all-gather", _nbytes(out))
        if not self.abstract:
            x = t.reshape((1,) + tuple(t.shape)).contiguous()
            dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def _scatter(self, t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        self._count("reduce-scatter", _nbytes(out))
        if not self.abstract:
            dist.reduce_scatter_tensor(out.view(-1), t.contiguous().view(-1),
                                       op=dist.ReduceOp.SUM, group=self.group)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the axis (``lax.psum``); its backward passes
        the cotangent through (see the module's table)."""
        if not self._active(t):
            return t
        return _Psum.apply(t, self)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise maximum over the axis (``lax.pmax``; no gradient)."""
        if not self._active(t):
            return t
        return self._reduce(t, dist.ReduceOp.MAX)

    def pvary(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, replicated over the axis, as each rank's own: the identity,
        whose backward sums the ranks' cotangents (``lax.psum``)."""
        if not self._active(t):
            return t
        return _Pvary.apply(t, self)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` stacked in axis order
        (``lax.all_gather``); its backward is ``psum_scatter``."""
        if not self._active(t):
            return t[None]
        return _AllGather.apply(t, self)

    def all_gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's block ``t`` joined along dimension ``dim`` in axis
        order (``lax.all_gather(..., axis=dim, tiled=True)``): the whole
        tensor of which ``t`` is this rank's block along ``dim``. Its
        backward reduce-scatters along ``dim``: each rank keeps the sum
        over the axis of its own block's cotangent. The census counts an
        ``all-gather`` of the whole tensor's bytes, and a
        ``reduce-scatter`` of the block's in the backward."""
        if not self._active(t):
            return t
        return _AllGatherDim.apply(t, self, dim % t.dim())

    def all_gather_invariant(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """``all_gather_dim``'s join (``lax.all_gather_invariant``) of a
        block whose whole every rank of the axis then uses alike (a weight
        gathered once so that a recurrence runs the same on every rank).
        Every rank then holds the same whole cotangent, so the backward
        keeps this rank's block of it and moves nothing, where
        ``all_gather_dim``'s reduce-scatter would sum ``size`` equal
        copies. The census counts the forward's ``all-gather``."""
        if not self._active(t):
            return t
        return _AllGatherInvariant.apply(t, self, dim % t.dim())

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *rest) -> rest: the sum over the axis of every rank's
        ``t``, of which this rank keeps block ``index`` of the leading
        dimension (``lax.psum_scatter``; no gradient)."""
        if not self._active(t):
            return t[0]
        if t.shape[0] != self.size:
            raise ValueError(f"psum_scatter over {self.size} ranks of a leading {t.shape[0]}")
        return self._scatter(t)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis._reduce(t, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._reduce(g, dist.ReduceOp.SUM), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return axis._gather(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum_scatter(g), None


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        g = axis._gather(t)  # (size, *t.shape)
        if dim == 0:
            return g.reshape((-1,) + tuple(t.shape[1:]))
        return g.movedim(0, dim).reshape(t.shape[:dim] + (-1,) + t.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        blocks = g.unflatten(dim, (axis.size, -1)).movedim(dim, 0)
        return axis.psum_scatter(blocks), None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        return _AllGatherDim.forward(ctx, t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.index * n, n), None, None


@dataclasses.dataclass(frozen=True, eq=False)
class ServingMesh:
    """This rank's place in a mesh: its global ``rank``, its ``device``,
    the named axes (``axis_names``, row major: the last varies fastest; a
    process group's meshes are 2D, ``data`` first) and ``everyone`` (every
    rank of the mesh, for agreement checks and broadcasts). Hashable by
    identity, so memos can key on it."""

    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    axes: Dict[str, MeshAxis]
    everyone: MeshAxis

    @property
    def shape(self) -> Dict[str, int]:
        return {n: self.axes[n].size for n in self.axis_names}

    @property
    def size(self) -> int:
        return self.everyone.size

    def axis(self, name: str) -> MeshAxis:
        return self.axes[name]

    def group_axis(self, names: Sequence[str]) -> Optional[MeshAxis]:
        """One axis over the axes ``names`` together (row major, as a
        collective over several mesh axes of the reference): the axis itself
        for one name, None for none. Several axes combine only on an
        abstract mesh (a process group's meshes are 2D)."""
        names = tuple(names)
        if not names:
            return None
        if len(names) == 1:
            return self.axis(names[0])
        axes = [self.axis(n) for n in names]
        if not all(a.abstract for a in axes):
            raise NotImplementedError(f"a collective over the axes {names} of a process group")
        index = 0
        for a in axes:
            index = index * a.size + a.index
        return MeshAxis(",".join(names), math.prod(a.size for a in axes), index, None, True)

    def over(self, names) -> Optional[MeshAxis]:
        """One axis over the mesh axes ``names`` (any order): None for none,
        ``everyone`` for all of them, else ``group_axis`` in the mesh's
        order."""
        names = set(names)
        if not names:
            return None
        if names >= set(self.axis_names):
            return self.everyone
        return self.group_axis([n for n in self.axis_names if n in names])

    def broadcast_object(self, obj, src: int = 0):
        """``obj`` from mesh rank ``src`` on every rank (pickled; only
        objects this program made)."""
        if self.everyone.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.everyone.group)
        return box[0]

    def agree(self, value: int, what: str) -> int:
        """``value``, checked equal on every rank of the mesh: raises when
        the ranks disagree (host state that must be replicated drifted)."""
        mine = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        got = self.everyone.all_gather(mine)
        if bool((got != got[0]).any()):
            raise RuntimeError(f"the ranks disagree on {what}: {got.flatten().tolist()}")
        return int(value)


def _default_device(rank: int) -> torch.device:
    """``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` as torchrun sets
    it, else the global rank); raises where CUDA is absent."""
    n = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    return resolve_device(f"cuda:{local % n}" if n else "cuda")


def _make_mesh(axis_names: Tuple[str, str], n0: int, n1: int, device,
               first: bool = False) -> Optional[ServingMesh]:
    """The mesh over the ranks of the process group; with ``first``, over
    its first ``n0 * n1`` ranks (None on the others)."""
    if n0 < 1 or n1 < 1:
        raise ValueError(f"mesh axes must have at least one rank, got {n0} x {n1}")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    n = n0 * n1
    if n != world and not (first and n < world):
        raise ValueError(
            f"a {n0} x {n1} mesh needs {n} ranks; the process group has {world}"
            + ("" if initialized else " (call torch.distributed.init_process_group first)")
        )
    rank = dist.get_rank() if initialized else 0
    # every rank creates every group, in the same order (new_group is collective)
    lines = {
        axis_names[0]: [[c0 * n1 + c1 for c0 in range(n0)] for c1 in range(n1)],
        axis_names[1]: [[c0 * n1 + c1 for c1 in range(n1)] for c0 in range(n0)],
    }
    groups = {}
    for name, size in ((axis_names[0], n0), (axis_names[1], n1)):
        for ranks in lines[name] if size > 1 else ():
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    whole = None
    if n > 1:
        whole = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    dev = _default_device(rank) if device is None else resolve_device(device)
    coord = {axis_names[0]: rank // n1, axis_names[1]: rank % n1}
    axes = {name: MeshAxis(name, size, coord[name], groups.get(name))
            for name, size in ((axis_names[0], n0), (axis_names[1], n1))}
    everyone = MeshAxis("everyone", n, rank, whole)
    return ServingMesh(axis_names, rank, dev, axes, everyone)


def make_abstract_mesh(rank: int = 0, **sizes: int) -> ServingMesh:
    """A mesh of ``sizes`` (axis name to size, in order: e.g. ``pod=2,
    data=32, model=8``) with no process group, as the reference's dry run
    lays out placeholder devices: mesh rank ``rank``'s coordinates, device
    ``meta``, every axis abstract (its collectives count and return meta
    tensors). Nothing is allocated."""
    if not sizes or any(int(n) < 1 for n in sizes.values()):
        raise ValueError(f"mesh axes must have at least one rank, got {sizes}")
    names = tuple(sizes)
    world = math.prod(int(n) for n in sizes.values())
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is outside a mesh of {world}")
    coords, rest = {}, rank
    for name in reversed(names):
        coords[name] = rest % int(sizes[name])
        rest //= int(sizes[name])
    axes = {n: MeshAxis(n, int(sizes[n]), coords[n], None, True) for n in names}
    everyone = MeshAxis("everyone", world, rank, None, True)
    return ServingMesh(names, rank, torch.device("meta"), axes, everyone)


def make_serving_mesh(query: int = 1, index: int = 1, device=None) -> ServingMesh:
    """The 2D serving mesh: ``query`` query-parallel replicas x ``index``
    index shards, axes ``("data", "index")``, over the ``query * index``
    ranks of the started process group (one rank needs none). The "data"
    axis carries the query batch; the "index" axis the
    ``PartitionedSnapshot``'s per-shard slabs (sharding/rules.py routes the
    ``leaf`` logical axis to it). ``device`` defaults to
    ``cuda:{local_rank % device_count}``; ``"cpu"`` runs the plain versions.
    """
    return _make_mesh(("data", "index"), int(query), int(index), device)


def make_host_mesh(data: int = 1, model: int = 1, device=None,
                   first: bool = False) -> Optional[ServingMesh]:
    """A ``("data", "model")`` mesh over the ranks, as the reference's host
    mesh: ``data`` and ``model`` clamped to the ranks there are. With
    ``first``, the mesh takes the first ``data * model`` ranks of a larger
    group and the others get None (ranks an elastic plan dropped); every
    rank of the group calls it."""
    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    data = min(int(data), n)
    model = min(int(model), max(n // data, 1))
    return _make_mesh(("data", "model"), data, model, device, first)
