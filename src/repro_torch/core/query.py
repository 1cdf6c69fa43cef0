"""SKR query helpers and the serial host oracle (paper §3 "Query processing").

* ``execute_serial`` -- the paper-faithful traversal: breadth-first descent,
  per-node MBR + bitmap checks, inverted-file verification at leaves. It is
  the ground truth the batched serving path (serve/engine.py) is held
  against, on the host, at any scale.
* ``round_up_bucket`` / ``sharded_bucket`` -- the power-of-two width
  discipline shared by the batch padding and the frontier widths.
* ``padded_child_table`` -- the (n, max_fanout) CSR child table the frontier
  descent gathers from.

A numpy copy of the same functions in the JAX package's ``core/query.py``;
the port keeps its own so it never imports that package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .types import GeoTextDataset, Workload, WiskIndex, points_in_rect

DEFAULT_W1 = 0.1  # stage-1 (filter) weight of the Eq. 1 cost, paper §7.1
DEFAULT_W2 = 1.0  # stage-2 (verify) weight


@dataclasses.dataclass
class QueryStats:
    nodes_accessed: np.ndarray  # (m,) int64 -- nodes whose MBR/bitmap were checked
    verified: np.ndarray  # (m,) int64 -- objects fetched from inverted files
    results: List[np.ndarray]  # per-query object ids
    cost: np.ndarray  # (m,) float64 Eq.1-style cost

    @property
    def total_cost(self) -> float:
        return float(self.cost.sum())


# ------------------------------------------------------- CSR / frontier helpers
def round_up_bucket(n: int, minimum: int = 8) -> int:
    """Next power-of-two >= n (>= minimum): the shared width-bucket discipline.

    Bucketing dynamic widths to powers of two bounds the number of distinct
    shapes a descent ever sees (log2 of the largest width).
    """
    n = max(int(n), 1)
    b = int(minimum)
    while b < n:
        b <<= 1
    return b


def sharded_bucket(m: int, shards: int, minimum: int = 8) -> int:
    """Padded batch size for ``m`` queries split evenly over ``shards``
    devices, each shard a power-of-two bucket. With ``shards=1`` this is
    ``round_up_bucket``."""
    shards = max(int(shards), 1)
    per_shard = -(-max(int(m), 1) // shards)
    return shards * round_up_bucket(per_shard, minimum)


def padded_child_table(level) -> np.ndarray:
    """(n, max_fanout) int32 child table from a level's CSR, padded with -1.

    The hierarchy is a tree (every lower node has exactly one parent), so the
    rows are disjoint: gathering the rows of a query's surviving frontier
    yields the next frontier with no duplicates.
    """
    cached = getattr(level, "_padded_child_table", None)
    if cached is not None:
        return cached
    counts = np.diff(level.child_ptr)
    fanout = int(counts.max()) if counts.size else 0
    table = np.full((level.n, max(fanout, 1)), -1, dtype=np.int32)
    for u in range(level.n):
        ch = level.child[level.child_ptr[u] : level.child_ptr[u + 1]]
        table[u, : ch.size] = ch
    try:  # memoize on the level (a pure function of its static CSR)
        level._padded_child_table = table
    except AttributeError:  # plain classes/namedtuples without __dict__
        pass
    return table


def _node_match(level, rect, qbm) -> np.ndarray:
    mb = level.mbrs
    inter = (mb[:, 0] <= rect[2]) & (rect[0] <= mb[:, 2]) & (mb[:, 1] <= rect[3]) & (rect[1] <= mb[:, 3])
    kw = np.any(level.bitmaps & qbm[None, :], axis=1)
    return inter & kw


def _verify_leaf(
    index: WiskIndex, dataset: GeoTextDataset, leaf_id: int, rect, q_kws
) -> Tuple[np.ndarray, int]:
    """Inverted-file verification: postings for query keywords -> spatial filter."""
    inv = index.inv
    lo, hi = inv.kw_ptr[leaf_id], inv.kw_ptr[leaf_id + 1]
    kws = inv.kw[lo:hi]
    cand: List[np.ndarray] = []
    for k in q_kws:
        j = np.searchsorted(kws, k)
        if j < kws.size and kws[j] == k:
            row = lo + j
            cand.append(inv.obj[inv.obj_ptr[row] : inv.obj_ptr[row + 1]])
    if not cand:
        return np.zeros(0, dtype=np.int32), 0
    ids = np.unique(np.concatenate(cand))
    ok = points_in_rect(dataset.locs[ids], rect)
    return ids[ok].astype(np.int32), int(ids.size)


def execute_serial(
    index: WiskIndex,
    dataset: GeoTextDataset,
    workload: Workload,
    w1: float = DEFAULT_W1,
    w2: float = DEFAULT_W2,
) -> QueryStats:
    m = workload.m
    nodes = np.zeros(m, dtype=np.int64)
    verified = np.zeros(m, dtype=np.int64)
    results: List[np.ndarray] = []
    for qi in range(m):
        rect = workload.rects[qi]
        qbm = workload.kw_bitmap[qi]
        q_kws = [int(k) for k in workload.kw_ids[qi] if k >= 0]
        # root level: check every node
        active = np.arange(index.levels[0].n)
        res_parts: List[np.ndarray] = []
        for li, level in enumerate(index.levels):
            nodes[qi] += active.size
            match = _node_match(level, rect, qbm)
            hit = active[match[active]]
            if li == len(index.levels) - 1:
                for leaf in hit:
                    ids, nv = _verify_leaf(index, dataset, int(leaf), rect, q_kws)
                    verified[qi] += nv
                    if ids.size:
                        res_parts.append(ids)
                break
            # expand children of hits
            if hit.size:
                nxt = np.concatenate(
                    [level.child[level.child_ptr[h] : level.child_ptr[h + 1]] for h in hit]
                )
            else:
                nxt = np.zeros(0, dtype=np.int32)
            active = nxt
            if active.size == 0:
                break
        results.append(
            np.unique(np.concatenate(res_parts)) if res_parts else np.zeros(0, dtype=np.int32)
        )
    cost = w1 * nodes.astype(np.float64) + w2 * verified.astype(np.float64)
    return QueryStats(nodes_accessed=nodes, verified=verified, results=results, cost=cost)
