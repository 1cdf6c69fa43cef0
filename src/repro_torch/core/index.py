"""WISK index assembly: bottom clusters + a hierarchy -> dense levels.

``levels[0]`` is the top (root) level; ``levels[-1]`` the leaf level whose
nodes are exactly the bottom clusters (leaf ``child`` CSR maps to cluster
ids). Non-leaf nodes carry an MBR and a keyword *bitmap* (paper Fig. 4: the
non-leaf textual summary is a bitmap; leaves use inverted files).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .types import ClusterSet, GeoTextDataset, InvertedFile, Level, WiskIndex


@dataclasses.dataclass
class HierarchyResult:
    """The parent slot of each lower node, per built level (bottom-up).

    Only the layout: the learned packer's other outputs in the JAX package
    come over with index construction (ROADMAP A.11).
    """

    parents: List[np.ndarray]  # per built level: parent slot of each lower node


def _group_level(
    lower_mbrs: np.ndarray, lower_bitmaps: np.ndarray, parent: np.ndarray
) -> Level:
    n_up = int(parent.max()) + 1 if parent.size else 0
    order = np.argsort(parent, kind="stable").astype(np.int32)
    counts = np.bincount(parent, minlength=n_up)
    ptr = np.zeros(n_up + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    mbrs = np.zeros((n_up, 4), dtype=np.float32)
    bitmaps = np.zeros((n_up, lower_bitmaps.shape[1]), dtype=np.uint32)
    for u in range(n_up):
        ch = order[ptr[u] : ptr[u + 1]]
        mb = lower_mbrs[ch]
        mbrs[u] = (mb[:, 0].min(), mb[:, 1].min(), mb[:, 2].max(), mb[:, 3].max())
        bitmaps[u] = np.bitwise_or.reduce(lower_bitmaps[ch], axis=0)
    return Level(mbrs=mbrs, bitmaps=bitmaps, child_ptr=ptr, child=order)


def assemble_index(
    dataset: GeoTextDataset,
    clusters: ClusterSet,
    hierarchy: Optional[HierarchyResult] = None,
    meta: Optional[dict] = None,
) -> WiskIndex:
    inv = InvertedFile.build(dataset, clusters)
    k = clusters.k
    leaf = Level(
        mbrs=clusters.mbrs,
        bitmaps=clusters.bitmaps,
        child_ptr=np.arange(k + 1, dtype=np.int64),
        child=np.arange(k, dtype=np.int32),
    )
    levels: List[Level] = [leaf]
    if hierarchy is not None:
        cur_mbrs, cur_bm = clusters.mbrs, clusters.bitmaps
        for parent in hierarchy.parents:
            lvl = _group_level(cur_mbrs, cur_bm, parent)
            levels.append(lvl)
            cur_mbrs, cur_bm = lvl.mbrs, lvl.bitmaps
    levels.reverse()  # root first
    return WiskIndex(levels=levels, clusters=clusters, inv=inv, meta=meta or {})


def flat_index(dataset: GeoTextDataset, clusters: ClusterSet) -> WiskIndex:
    """A one-level index (no hierarchy) over the given clusters."""
    return assemble_index(dataset, clusters, hierarchy=None, meta={"flat": True})
