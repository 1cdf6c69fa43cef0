"""Conventional (data-driven) index layouts: uniform grid + inverted files
(SFC-Quad analogue), an STR-packed R-tree + inverted files (R*-IF / SFI
analogue), and CDIR-style agglomerative packing over given bottom clusters
(the Fig. 17 packing ablation).

All reuse the ``WiskIndex`` container, so the serving path runs on them
unchanged: only the *layout* differs from the learned WISK index. Host-only
numpy, copies of the JAX package's ``baselines/conventional.py``.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.index import assemble_index, flat_index
from ..core.packing import HierarchyResult
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


def cdir_pack_hierarchy(
    clusters: ClusterSet, alpha: float = 0.5, fanout: int = 8
) -> HierarchyResult:
    """CDIR-tree-style packing of bottom clusters: greedy grouping by the
    weighted spatio-textual distance alpha*spatial + (1-alpha)*(1-jaccard).
    This is the Fig. 17 comparison target for the RL packing."""
    parents: List[np.ndarray] = []
    mbrs = clusters.mbrs.copy()
    bms = clusters.bitmaps.copy()

    def popcount(a):
        return np.unpackbits(a.view(np.uint8), axis=-1).sum(-1)

    while mbrs.shape[0] > fanout:
        n = mbrs.shape[0]
        cx = (mbrs[:, 0] + mbrs[:, 2]) / 2
        cy = (mbrs[:, 1] + mbrs[:, 3]) / 2
        sp = np.sqrt((cx[:, None] - cx[None, :]) ** 2 + (cy[:, None] - cy[None, :]) ** 2)
        sp = sp / max(sp.max(), 1e-9)
        inter = popcount(bms[:, None, :] & bms[None, :, :]).astype(np.float64)
        union = popcount(bms[:, None, :] | bms[None, :, :]).astype(np.float64)
        jac = inter / np.maximum(union, 1.0)
        dist = alpha * sp + (1 - alpha) * (1.0 - jac)
        np.fill_diagonal(dist, np.inf)
        parent = np.full(n, -1, dtype=np.int32)
        gid = 0
        for i in np.argsort(cx, kind="stable"):
            if parent[i] >= 0:
                continue
            parent[i] = gid
            # take the fanout-1 nearest unassigned
            taken = 1
            for j in np.argsort(dist[i], kind="stable"):
                if taken >= fanout:
                    break
                if parent[j] < 0:
                    parent[j] = gid
                    taken += 1
            gid += 1
        parents.append(parent)
        up_m = np.zeros((gid, 4), dtype=np.float32)
        up_b = np.zeros((gid, bms.shape[1]), dtype=np.uint32)
        for u in range(gid):
            sel = parent == u
            mm = mbrs[sel]
            up_m[u] = (mm[:, 0].min(), mm[:, 1].min(), mm[:, 2].max(), mm[:, 3].max())
            up_b[u] = np.bitwise_or.reduce(bms[sel], axis=0)
        mbrs, bms = up_m, up_b
    return HierarchyResult(parents=parents)


def build_cdir_over_clusters(
    dataset: GeoTextDataset, clusters: ClusterSet, alpha: float = 0.5
) -> WiskIndex:
    """A ``WiskIndex`` over ``clusters`` with ``cdir_pack_hierarchy``'s levels."""
    hier = cdir_pack_hierarchy(clusters, alpha=alpha)
    return assemble_index(dataset, clusters, hier, meta={"name": f"cdir-pack(a={alpha})"})
