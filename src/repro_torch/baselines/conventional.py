"""Conventional (data-driven) index layouts: uniform grid + inverted files
(SFC-Quad analogue) and an STR-packed R-tree + inverted files (R*-IF / SFI
analogue).

Both reuse the ``WiskIndex`` container, so the serving path runs on them
unchanged: only the *layout* differs from the learned WISK index. The
STR R-tree is the numpy-only hierarchical layout the port serves until the
learned construction is ported (ROADMAP A.11).
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.index import HierarchyResult, assemble_index, flat_index
from ..core.types import ClusterSet, GeoTextDataset, WiskIndex


def build_grid_index(dataset: GeoTextDataset, cells_per_dim: int = 8) -> WiskIndex:
    """Uniform grid + per-cell inverted file (data-agnostic; SFC-Quad-like)."""
    g = cells_per_dim
    ij = np.minimum((dataset.locs * g).astype(np.int32), g - 1)
    assign = ij[:, 0] * g + ij[:, 1]
    # compact non-empty cells
    used, assign = np.unique(assign, return_inverse=True)
    clusters = ClusterSet.from_assignment(dataset, assign.astype(np.int32))
    idx = flat_index(dataset, clusters)
    idx.meta["name"] = f"grid{g}"
    return idx


def _str_pack(mbrs: np.ndarray, fanout: int) -> np.ndarray:
    """STR packing of rectangles into groups of ``fanout`` -> parent ids."""
    n = mbrs.shape[0]
    n_groups = max(1, -(-n // fanout))
    s = int(np.ceil(np.sqrt(n_groups)))
    cx = (mbrs[:, 0] + mbrs[:, 2]) / 2
    cy = (mbrs[:, 1] + mbrs[:, 3]) / 2
    parent = np.zeros(n, dtype=np.int32)
    order_x = np.argsort(cx, kind="stable")
    slice_size = -(-n // s)
    gid = 0
    for si in range(s):
        sl = order_x[si * slice_size : (si + 1) * slice_size]
        if sl.size == 0:
            continue
        sl = sl[np.argsort(cy[sl], kind="stable")]
        for off in range(0, sl.size, fanout):
            parent[sl[off : off + fanout]] = gid
            gid += 1
    return parent


def build_str_rtree(
    dataset: GeoTextDataset, leaf_size: int = 128, fanout: int = 8
) -> WiskIndex:
    """STR bulk-loaded R-tree with a per-leaf inverted file (data-driven)."""
    n = dataset.n
    n_leaves = max(1, -(-n // leaf_size))
    s = int(np.ceil(np.sqrt(n_leaves)))
    order_x = np.argsort(dataset.locs[:, 0], kind="stable")
    assign = np.zeros(n, dtype=np.int32)
    slice_size = -(-n // s)
    leaf = 0
    for si in range(s):
        sl = order_x[si * slice_size : (si + 1) * slice_size]
        if sl.size == 0:
            continue
        sl = sl[np.argsort(dataset.locs[sl, 1], kind="stable")]
        for off in range(0, sl.size, leaf_size):
            assign[sl[off : off + leaf_size]] = leaf
            leaf += 1
    clusters = ClusterSet.from_assignment(dataset, assign)
    # pack upper levels with STR until narrow
    parents: List[np.ndarray] = []
    mbrs = clusters.mbrs
    while mbrs.shape[0] > fanout:
        p = _str_pack(mbrs, fanout)
        parents.append(p)
        n_up = int(p.max()) + 1
        up = np.zeros((n_up, 4), dtype=np.float32)
        for u in range(n_up):
            sel = mbrs[p == u]
            up[u] = (sel[:, 0].min(), sel[:, 1].min(), sel[:, 2].max(), sel[:, 3].max())
        mbrs = up
    hier = HierarchyResult(parents=parents)
    return assemble_index(dataset, clusters, hier, meta={"name": "str-rtree"})
