"""WISK cost model (paper Eq. 1) and exact cost accounting.

``C(q) = w1 * |G| + w2 * sum_{c in G_q} |O_c|``

where ``G`` is the cluster set, ``G_q`` the clusters that intersect ``q.area``
and share a keyword with ``q.keys``, and ``|O_c|`` the number of objects in
``c`` containing >=1 query keyword (the inverted file fetches postings for the
query keywords over the whole cluster, then filters spatially -- so the count
is keyword-conditioned but *not* spatially restricted).

A numpy copy of the JAX package's ``core/cost.py``; the port keeps its own
so it never imports that package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .types import ClusterSet, GeoTextDataset, Workload, points_in_rect, rects_intersect, set_bits

DEFAULT_W1 = 0.1  # stage-1 (filter) weight, paper §7.1
DEFAULT_W2 = 1.0  # stage-2 (verify) weight


@dataclasses.dataclass
class CostBreakdown:
    filter_checks: int  # total (query, cluster) filter tests
    verified_objects: int  # total keyword-matching objects scanned in relevant clusters
    total: float
    per_query: np.ndarray  # (m,) float64


def object_query_match(dataset: GeoTextDataset, workload: Workload) -> np.ndarray:
    """(m, n) bool: object shares >=1 keyword with the query (no spatial test).

    Built from posting lists of the objects' set bits, one list per query
    term, so the work follows the matches and no (m, chunk, W) intermediate
    is made: the same matrix as the JAX package's at a W = 256 vocabulary
    and thousands of queries, where that intermediate would not fit in
    memory."""
    out = np.zeros((workload.m, dataset.n), dtype=bool)
    obj, term = set_bits(dataset.kw_bitmap)
    order = np.argsort(term, kind="stable")
    obj, term = obj[order], term[order]
    start = np.searchsorted(term, np.arange(32 * dataset.kw_bitmap.shape[1] + 1))
    for qi, t in zip(*set_bits(workload.kw_bitmap)):
        out[qi, obj[start[t] : start[t + 1]]] = True
    return out


def exact_workload_cost(
    dataset: GeoTextDataset,
    clusters: ClusterSet,
    workload: Workload,
    w1: float = DEFAULT_W1,
    w2: float = DEFAULT_W2,
    kw_match: Optional[np.ndarray] = None,
) -> CostBreakdown:
    """Exact Eq. 1 cost of running ``workload`` over the flat cluster set."""
    m, k = workload.m, clusters.k
    if kw_match is None:
        kw_match = object_query_match(dataset, workload)
    # (m, k): cluster relevant to query
    inter = rects_intersect(workload.rects[:, None, :], clusters.mbrs[None, :, :])
    kwc = np.any(
        workload.kw_bitmap[:, None, :] & clusters.bitmaps[None, :, :] != 0, axis=-1
    )
    relevant = inter & kwc
    # per-cluster keyword-matching object counts per query: sum kw_match over members
    # membership matrix via assignment
    per_query = np.full(m, w1 * k, dtype=np.float64)
    verified = 0
    # counts[c] for each query: segment-sum kw_match by cluster assignment
    assign = clusters.assign
    for qi in range(m):
        match_counts = np.bincount(assign[kw_match[qi]], minlength=k)
        v = int(match_counts[relevant[qi]].sum())
        verified += v
        per_query[qi] += w2 * v
    return CostBreakdown(
        filter_checks=m * k,
        verified_objects=verified,
        total=float(per_query.sum()),
        per_query=per_query,
    )


def exact_query_results(
    dataset: GeoTextDataset, workload: Workload, kw_match: Optional[np.ndarray] = None
) -> np.ndarray:
    """(m,) int64 ground-truth result counts (for correctness tests)."""
    if kw_match is None:
        kw_match = object_query_match(dataset, workload)
    inr = (
        (dataset.locs[None, :, 0] >= workload.rects[:, None, 0])
        & (dataset.locs[None, :, 0] <= workload.rects[:, None, 2])
        & (dataset.locs[None, :, 1] >= workload.rects[:, None, 1])
        & (dataset.locs[None, :, 1] <= workload.rects[:, None, 3])
    )
    return np.sum(kw_match & inr, axis=1).astype(np.int64)


def exact_query_result_ids(dataset: GeoTextDataset, rect: np.ndarray, kw_bitmap: np.ndarray) -> np.ndarray:
    """Ground truth ids for a single query (host reference)."""
    match = np.any(dataset.kw_bitmap & kw_bitmap[None, :], axis=-1)
    inr = points_in_rect(dataset.locs, rect)
    return np.nonzero(match & inr)[0].astype(np.int32)
