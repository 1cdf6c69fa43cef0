"""Logical-axis sharding rules (MaxText-style), mapped onto a ``ServingMesh``:
the port of the JAX package's ``sharding/rules.py``.

Every parameter / activation dimension carries a logical name; a rules table
maps logical names to mesh axes. Weights use FSDP-flavoured names
(``wembed``: storage split over the data axes while activations stay whole
on the same dimension); ``heads``, ``mlp``, ``vocab``, ``experts`` and
``inner`` split over ``model``; decode caches split their sequence over
``model`` (``kv_seq``) or, for long-context decode, over every axis
(``kv_seq_all``). The WISK rows:

* ``query`` -- the query batch, split over the data axes (replicated
  index: each query shard serves its rows against the whole snapshot);
* ``leaf`` -- the ``PartitionedSnapshot``'s stacked per-shard rows (subtree
  nodes, leaves, object blocks, a routed delta's buffers): the ``index``
  axis on a serving mesh, ``model`` on a host mesh (the flat fallback's
  leaf rows);
* ``word`` and ``obj_slot`` -- bitmap words and per-leaf object slots,
  never split.

``named_sharding`` gives a ``Sharding``: the mesh axes of each dimension
and ``shard_shape``, the per-device block shape of a global shape (JAX's
``NamedSharding.shard_shape``). ``shard_tensor`` takes this rank's block of
a host array or tensor on every split dimension, which is what placing it
with the reference's ``NamedSharding`` leaves on each device; ``shard_rows``
is its one-dimension case. There is no ``constrain``: each rank runs its
own program, so nothing pins an activation's layout. A ``Layout`` is what
the tensor-parallel layers of ``models/`` ask of the rules: the axis a
logical name splits over, and the collectives over it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from ..launch.mesh import MeshAxis, ServingMesh

Axis = Union[None, str, Tuple[str, ...]]


def dp_axes(mesh: ServingMesh) -> Tuple[str, ...]:
    """The mesh's data axes, ``("pod", "data")`` where present (the
    reference's ``dp_axes``)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_mesh_axes(mesh: ServingMesh) -> list:
    """``dp_axes``' ``MeshAxis`` objects, for their collectives."""
    return [mesh.axis(a) for a in dp_axes(mesh)]


def default_rules(mesh: ServingMesh) -> Dict[str, Axis]:
    dp = dp_axes(mesh)
    return {
        # activations
        "batch": dp,
        "seq": None,
        "embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
        "act_experts": "model",
        "kv_seq": "model",  # decode caches: sequence over model (flash-decoding)
        "kv_seq_all": dp + ("model",),  # long-context decode: sequence over everything
        # weights
        "wembed": dp,  # FSDP storage axis
        "heads": "model",
        "kv_heads": None,  # GQA kv heads are often fewer than the model ranks: replicated
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "layers": None,
        "lora": None,
        "state": None,
        "inner": "model",  # mamba d_inner / xlstm inner: channel TP
        "conv": None,
        "repeat": None,
        # WISK serving: replicated (queries over the data axes), index-sharded
        # ("leaf" over "index") and the flat fallback (leaf rows over "model")
        "query": dp,
        "leaf": "index" if "index" in mesh.axis_names else "model",
        "word": None,  # keyword bitmap words stay unsharded
        "obj_slot": None,  # per-leaf object blocks ride their leaf's shard
    }


def spec_for(names: Sequence[Optional[str]], rules: Dict[str, Axis]) -> Tuple[Axis, ...]:
    """Per dimension, the mesh axes its logical name splits over (None:
    not split): empty tuples normalised to None and one-axis tuples to the
    axis, as ``PartitionSpec`` normalises them."""
    parts = []
    for n in names:
        ax = None if n is None else rules.get(n)
        if not (ax is None or isinstance(ax, (str, tuple))):
            ax = None
        if isinstance(ax, tuple) and len(ax) < 2:
            ax = ax[0] if ax else None
        parts.append(ax)
    return tuple(parts)


def _axes_of(part: Axis) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout on ``mesh``: ``spec``, the mesh axes of each dimension."""

    mesh: ServingMesh
    spec: Tuple[Axis, ...]

    def __post_init__(self):
        seen = set()
        for part in self.spec:
            for a in _axes_of(part):
                if a not in self.mesh.axis_names:
                    raise ValueError(f"axis {a!r} of {self.spec} is not in the mesh "
                                     f"{self.mesh.axis_names}")
                if a in seen:
                    raise ValueError(f"{self.spec} maps the mesh axis {a!r} to two dimensions")
                seen.add(a)

    def tiles(self, ndim: int) -> Tuple[int, ...]:
        """How many blocks each of ``ndim`` dimensions splits into."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more dimensions than a rank-{ndim} array")
        spec = self.spec + (None,) * (ndim - len(self.spec))
        return tuple(math.prod(self.mesh.axis(a).size for a in _axes_of(p)) for p in spec)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device block shape of an array of ``global_shape``;
        raises where a dimension does not split evenly."""
        shape = tuple(int(n) for n in global_shape)
        out = []
        for i, (n, k) in enumerate(zip(shape, self.tiles(len(shape)))):
            if n % k:
                raise ValueError(f"dimension {i} of {shape} does not split into {k} blocks "
                                 f"({self.spec})")
            out.append(n // k)
        return tuple(out)

    def index(self, global_shape: Sequence[int],
              coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
        """The slices of this rank's block (of the rank at mesh coordinates
        ``coords`` where given): on each split dimension, the block at the
        rank's coordinates on its axes, row major."""
        block = self.shard_shape(global_shape)
        spec = self.spec + (None,) * (len(block) - len(self.spec))
        out = []
        for part, n in zip(spec, block):
            at = 0
            for a in _axes_of(part):
                ax = self.mesh.axis(a)
                at = at * ax.size + (ax.index if coords is None else coords[a])
            out.append(slice(at * n, (at + 1) * n))
        return tuple(out)

    @property
    def split(self) -> bool:
        """Whether any dimension is split (else every rank holds it whole)."""
        return any(p is not None for p in self.spec)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes the dimensions split over, in the mesh's order."""
        used = {a for p in self.spec for a in _axes_of(p)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def global_shape(self, block_shape: Sequence[int]) -> Tuple[int, ...]:
        """The whole array's shape, of which ``block_shape`` is a block."""
        return tuple(int(n) * k for n, k in zip(block_shape, self.tiles(len(block_shape))))

    def holders(self) -> int:
        """How many ranks hold each block (the ranks of the axes no
        dimension is split over)."""
        return self.mesh.size // math.prod(self.tiles(len(self.spec)))

    def psum(self, t, dims: Sequence[int], ndim: int):
        """``t`` summed over the ranks that hold the other blocks along
        ``dims`` of a rank-``ndim`` array (the axes those dimensions split
        over): a partial sum along ``dims`` becomes the whole array's."""
        spec = self.spec + (None,) * (ndim - len(self.spec))
        axis = self.mesh.over({a for d in dims for a in _axes_of(spec[d])})
        return t if axis is None else axis.psum(t)


def named_sharding(mesh: ServingMesh, names: Sequence[Optional[str]],
                   rules: Optional[Dict[str, Axis]] = None) -> Sharding:
    rules = rules or default_rules(mesh)
    return Sharding(mesh, spec_for(names, rules))


def _is_names(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(x, (str, type(None))) for x in t)


def tree_shardings(mesh: ServingMesh, tree_names: Any, rules: Optional[Dict[str, Axis]] = None):
    """Map a tree (dicts, lists and named tuples) of logical-name tuples to
    ``Sharding``s; a leaf is a tuple of names (the reference's test)."""
    rules = rules or default_rules(mesh)

    def walk(t):
        if _is_names(t):
            return named_sharding(mesh, t, rules)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        raise TypeError(f"not a spec tree: {t!r}")

    return walk(tree_names)


def shard_tensor(a, names: Sequence[Optional[str]], mesh: ServingMesh,
                 rules: Optional[Dict[str, Axis]] = None):
    """This rank's block of ``a`` (anything indexable with slices that has
    a ``shape``) on every dimension its logical ``names`` split: a view.
    Raises when a dimension does not split evenly."""
    return a[named_sharding(mesh, names, rules).index(a.shape)]


def shard_rows(a, name: Optional[str], mesh: ServingMesh):
    """This rank's block of ``a`` along its first dimension, whose logical
    name is ``name`` (``shard_tensor``'s one-dimension case)."""
    return shard_tensor(a, (name,), mesh)


class Layout:
    """A model's weights and activations on ``mesh`` as ``rules`` place
    them, for the layers that compute on blocks (``models/layers.py``,
    ``mla.py``, ``moe.py``): ``axis(name)`` is the axis a logical name
    splits over (None where it is unsplit or has one rank), and each method
    is a collective over the axis of a name, the identity where there is
    none. ``WHOLE`` (no mesh) is the single-device layout: every method is
    the identity, so the layers compute as on one device.

    * ``whole(w, dim)`` -- ZeRO-3: a weight stored as this rank's block of
      its ``wembed`` dimension ``dim``, gathered whole along it over the
      data axes (``MeshAxis.all_gather_dim``, whose backward reduce-scatters
      the gradient: each rank's block gets the sum over the data ranks);
    * ``enter(name, x)`` -- ``x``, the same on every rank of ``name``'s
      axis, entering a region where each rank computes its own block
      (``pvary``: the cotangents of the ranks are summed in the backward);
    * ``psum`` / ``pmax`` / ``gather`` -- the row-parallel sums, the
      combines and the joins of blocks over ``name``'s axis;
    * ``gather_invariant(name, w, dim)`` -- a weight's blocks over
      ``name``'s axis joined whole for a computation every rank of the
      axis then runs alike (``MeshAxis.all_gather_invariant``: the backward
      keeps the rank's block of the same whole gradient);
    * ``own(name, t, n)`` -- this rank's block of ``n`` entries of the last
      dimension of ``t``, whole on every rank of the axis (a plain slice);
    * ``start(name, n)`` -- where this rank's block of ``n`` entries starts
      on a dimension ``name`` splits.
    """

    def __init__(self, mesh: Optional[ServingMesh] = None,
                 rules: Optional[Dict[str, Axis]] = None) -> None:
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None else default_rules(mesh)
        self._axes: Dict[str, Optional[MeshAxis]] = {}

    def axis(self, name: str) -> Optional[MeshAxis]:
        if self.mesh is None:
            return None
        if name not in self._axes:
            ax = self.mesh.over(_axes_of(spec_for((name,), self.rules)[0]))
            self._axes[name] = ax if ax is not None and ax.size > 1 else None
        return self._axes[name]

    def place(self, spec: Sequence[Optional[str]]) -> Sharding:
        """The ``Sharding`` of a tensor of logical ``spec``."""
        return named_sharding(self.mesh, spec, self.rules)

    def cut(self, t, spec: Sequence[Optional[str]]):
        """This rank's block of the whole ``t`` of logical ``spec`` (a copy
        of its own, so that the whole can go)."""
        if self.mesh is None:
            return t
        return t[self.place(spec).index(t.shape)].clone()

    def size(self, name: str) -> int:
        """How many blocks a dimension ``name`` splits into."""
        ax = self.axis(name)
        return 1 if ax is None else ax.size

    def start(self, name: str, n: int) -> int:
        ax = self.axis(name)
        return 0 if ax is None else ax.index * int(n)

    def gather(self, name: str, t, dim: int):
        ax = self.axis(name)
        return t if ax is None else ax.all_gather_dim(t, dim)

    def whole(self, w, dim: int):
        return self.gather("wembed", w, dim)

    def gather_invariant(self, name: str, w, dim: int):
        ax = self.axis(name)
        return w if ax is None else ax.all_gather_invariant(w, dim)

    def own(self, name: str, t, n: int):
        lo = self.start(name, n)
        return t if self.axis(name) is None else t[..., lo:lo + n]

    def enter(self, name: str, x):
        ax = self.axis(name)
        return x if ax is None else ax.pvary(x)

    def psum(self, name: str, y):
        ax = self.axis(name)
        return y if ax is None else ax.psum(y)

    def pmax(self, name: str, y):
        ax = self.axis(name)
        return y if ax is None else ax.pmax(y)


WHOLE = Layout()
