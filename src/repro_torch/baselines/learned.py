"""Learned baselines: Flood-T (learned 1-D column layout + inverted files,
the paper's own adaptation of Flood), LSTI (Z-order + learned spline +
postings), and TFI (textual-first: inverted file over a learned per-keyword
1-D spatial index).

Flood-T's column count and boundaries are chosen to minimize the Eq.1 cost
over the training workload -- but it can only split along ONE dimension,
which is exactly the limitation the paper exploits (Figs. 8-11).

Host-only numpy, like the layouts in ``conventional.py``: a copy of the JAX
package's ``baselines/learned.py``; the port keeps its own so it never
imports that package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.cost import DEFAULT_W1, DEFAULT_W2, exact_workload_cost
from ..core.index import flat_index
from ..core.query import QueryStats
from ..core.types import ClusterSet, GeoTextDataset, WiskIndex, Workload, points_in_rect


def build_floodt(
    dataset: GeoTextDataset,
    workload: Workload,
    candidate_counts: Tuple[int, ...] = (4, 8, 16, 32, 64, 128),
    w1: float = DEFAULT_W1,
    w2: float = DEFAULT_W2,
) -> WiskIndex:
    """Learned single-dimension column layout (Flood-T): the dimension and
    column count of least Eq.1 cost on ``workload``, columns at quantiles."""
    best = None
    for dim in (0, 1):
        vals = dataset.locs[:, dim]
        for k in candidate_counts:
            if k > dataset.n:
                continue
            qs = np.quantile(vals, np.linspace(0, 1, k + 1)[1:-1])
            assign = np.searchsorted(qs, vals).astype(np.int32)
            clusters = ClusterSet.from_assignment(dataset, assign)
            cost = exact_workload_cost(dataset, clusters, workload, w1, w2).total
            if best is None or cost < best[0]:
                best = (cost, dim, k, assign)
    _, dim, k, assign = best
    clusters = ClusterSet.from_assignment(dataset, assign)
    idx = flat_index(dataset, clusters)
    idx.meta.update(name=f"flood-t(dim={dim},k={k})", dim=dim, k=k)
    return idx


def _zorder(locs: np.ndarray, bits: int = 16) -> np.ndarray:
    """(n,) int64 Z-order (Morton) codes of unit-square points at ``bits``
    bits per dimension, x in the even bits."""
    xy = np.minimum((locs * (2**bits - 1)).astype(np.int64), 2**bits - 1)
    code = np.zeros(locs.shape[0], dtype=np.int64)
    for b in range(bits):
        code |= ((xy[:, 0] >> b) & 1) << (2 * b)
        code |= ((xy[:, 1] >> b) & 1) << (2 * b + 1)
    return code


def build_lsti(dataset: GeoTextDataset, max_error: int = 256) -> WiskIndex:
    """LSTI analogue: Z-order the objects, cut the order into segments of at
    most ``max_error`` objects (RadixSpline-style greedy), one cluster per
    segment with a per-segment inverted file."""
    order = np.argsort(_zorder(dataset.locs))
    n = dataset.n
    seg_of = np.zeros(n, dtype=np.int32)
    seg = 0
    start = 0
    for i in range(1, n + 1):
        if i == n or (i - start) >= max_error:
            seg_of[order[start:i]] = seg
            seg += 1
            start = i
    clusters = ClusterSet.from_assignment(dataset, seg_of)
    idx = flat_index(dataset, clusters)
    idx.meta.update(name=f"lsti(err={max_error})")
    return idx


@dataclasses.dataclass
class TFIIndex:
    """Textual-first index: per-keyword Z-ordered object arrays. Queries fetch
    per-keyword candidates by the query rect's Z-range, then verify."""

    kw_ptr: np.ndarray  # (V+1,)
    obj: np.ndarray  # object ids grouped by keyword, z-sorted within keyword
    code: np.ndarray  # z-codes aligned with ``obj``
    dataset_n: int

    def nbytes(self) -> int:
        return self.kw_ptr.nbytes + self.obj.nbytes + self.code.nbytes


def build_tfi(dataset: GeoTextDataset) -> TFIIndex:
    """The TFI index of ``dataset``: every (keyword, object) pair, grouped by
    keyword and Z-sorted within it."""
    code_all = _zorder(dataset.locs)
    rows, cols = np.nonzero(dataset.kw_ids >= 0)
    kws = dataset.kw_ids[rows, cols]
    order = np.lexsort((code_all[rows], kws))
    kws_s, rows_s = kws[order], rows[order]
    counts = np.bincount(kws_s, minlength=dataset.vocab_size)
    kw_ptr = np.zeros(dataset.vocab_size + 1, dtype=np.int64)
    np.cumsum(counts, out=kw_ptr[1:])
    return TFIIndex(kw_ptr=kw_ptr, obj=rows_s.astype(np.int32), code=code_all[rows_s],
                    dataset_n=dataset.n)


def tfi_query(
    index: TFIIndex, dataset: GeoTextDataset, workload: Workload,
    w1: float = DEFAULT_W1, w2: float = DEFAULT_W2,
) -> QueryStats:
    """Per query: for each keyword, binary-search the Z-range covering the
    rect, scan candidates, verify spatially. ``nodes_accessed`` counts the
    keyword lists opened, ``verified`` the candidates scanned."""
    m = workload.m
    nodes = np.zeros(m, dtype=np.int64)
    verified = np.zeros(m, dtype=np.int64)
    results: List[np.ndarray] = []
    for qi in range(m):
        rect = workload.rects[qi]
        zlo = _zorder(rect[None, 0:2])[0]
        zhi = _zorder(rect[None, 2:4])[0]
        parts = []
        for k in workload.kw_ids[qi]:
            if k < 0:
                continue
            lo, hi = index.kw_ptr[k], index.kw_ptr[k + 1]
            nodes[qi] += 1
            if lo == hi:
                continue
            a = lo + np.searchsorted(index.code[lo:hi], zlo, side="left")
            b = lo + np.searchsorted(index.code[lo:hi], zhi, side="right")
            cand = index.obj[a:b]
            verified[qi] += cand.size
            if cand.size:
                ok = points_in_rect(dataset.locs[cand], rect)
                parts.append(cand[ok])
        results.append(np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int32))
    cost = w1 * nodes.astype(np.float64) + w2 * verified.astype(np.float64)
    return QueryStats(nodes_accessed=nodes, verified=verified, results=results, cost=cost)
