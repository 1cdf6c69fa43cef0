"""Logical-axis rules of WISK serving, mapped onto a ``ServingMesh``.

The port of the JAX package's ``sharding/rules.py`` rows for WISK serving
(the LM rows come with the LM substrate). A tensor dimension carries a
logical name; the rules map it to mesh axes:

* ``query`` -- the query batch, split over the data axes (replicated
  index: each query shard serves its rows against the whole snapshot);
* ``leaf`` -- the ``PartitionedSnapshot``'s stacked per-shard rows (subtree
  nodes, leaves, object blocks, a routed delta's buffers): the ``index``
  axis on a serving mesh, ``model`` on a host mesh (the flat fallback's
  leaf rows);
* ``word`` and ``obj_slot`` -- bitmap words and per-leaf object slots,
  never split.

``shard_rows`` takes this rank's block of a host array along its first
dimension, which is what placing an array with the reference's
``NamedSharding`` leaves on each device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..launch.mesh import MeshAxis, ServingMesh

Axis = Union[None, str, Tuple[str, ...]]


def dp_axes(mesh: ServingMesh) -> List[MeshAxis]:
    """The mesh's data (query-parallel) axes, as the reference's
    ``dp_axes``: the ``data`` axis of every serving and host mesh."""
    return [mesh.axis(a) for a in ("data",) if a in mesh.axis_names]


def default_rules(mesh: ServingMesh) -> Dict[str, Axis]:
    dp = tuple(a.name for a in dp_axes(mesh))
    return {
        "query": dp,
        "leaf": "index" if "index" in mesh.axis_names else "model",
        "word": None,
        "obj_slot": None,
    }


def spec_for(names: Sequence[Optional[str]], rules: Dict[str, Axis]) -> Tuple[Axis, ...]:
    """Per dimension, the mesh axes its logical name splits over (None:
    not split), empty tuples normalised to None."""
    parts = []
    for n in names:
        ax = None if n is None else rules.get(n)
        parts.append(None if isinstance(ax, tuple) and not ax else ax)
    return tuple(parts)


def shard_rows(a, name: Optional[str], mesh: ServingMesh):
    """This rank's block of ``a`` (anything sliceable with a ``shape``)
    along its first dimension, whose logical name is ``name``: the blocks
    follow the rank's coordinates on the axes the name maps to, row major.
    Raises when the dimension does not split evenly."""
    (axes,) = spec_for((name,), default_rules(mesh))
    if axes is None:
        return a
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = [mesh.axis(n).size for n in axes]
    n = math.prod(sizes)
    block = 0
    for ax, size in zip(axes, sizes):
        block = block * size + mesh.axis(ax).index
    rows = int(a.shape[0])
    if rows % n:
        raise ValueError(f"{rows} rows of {name!r} do not split over {n} shards")
    per = rows // n
    return a[block * per:(block + 1) * per]
