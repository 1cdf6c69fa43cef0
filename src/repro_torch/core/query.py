"""Query helpers and the serial host oracles (paper §3 "Query processing").

* ``execute_serial`` -- the paper-faithful SKR traversal: breadth-first
  descent, per-node MBR + bitmap checks, inverted-file verification at
  leaves. It is the ground truth the batched serving path
  (serve/engine.py ``retrieve``) is held against, on the host, at any scale.
* ``knn_query`` -- Boolean kNN (paper appendix A): serial best-first search,
  the ground truth of ``serve.engine.retrieve_knn``. Ties at equal distance
  break by smallest object id, so the k-set is independent of traversal
  order. ``knn_level_sync`` is its vectorized host mirror of the device
  descent (keyword-filtered levels, then a bounded leaf sweep).
  Distances are float32, computed op by op (``dx*dx + dy*dy``, never a
  fused multiply-add), which the port's kernels reproduce bit for bit.
* ``match_subscriptions_bruteforce`` / ``SubscriptionOracle`` -- the
  ground truth of standing-subscription matching (serve/subscribe.py): set
  semantics per (object, subscription) pair, no bitmaps, and a replay of a
  subscribe / unsubscribe / arrive / drain schedule.
* ``execute_level_sync`` -- the vectorized host traversal with (M, n_level)
  masks; its counters equal ``execute_serial``'s. The drift baseline
  (``core.drift.index_cost_baseline``) runs it.
* ``round_up_bucket`` / ``sharded_bucket`` -- the power-of-two width
  discipline shared by the batch padding and the frontier widths.
* ``padded_child_table`` -- the (n, max_fanout) CSR child table the frontier
  descent gathers from.

A numpy copy of the same functions in the JAX package's ``core/query.py``;
the port keeps its own so it never imports that package.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np

from .cost import DEFAULT_W1, DEFAULT_W2
from .types import GeoTextDataset, Workload, WiskIndex, points_in_rect


@dataclasses.dataclass
class QueryStats:
    nodes_accessed: np.ndarray  # (m,) int64 -- nodes whose MBR/bitmap were checked
    verified: np.ndarray  # (m,) int64 -- objects fetched from inverted files
    results: List[np.ndarray]  # per-query object ids
    cost: np.ndarray  # (m,) float64 Eq.1-style cost

    @property
    def total_cost(self) -> float:
        return float(self.cost.sum())


# --------------------------------------- continuous-filter matching ground truth
def match_subscriptions_bruteforce(
    obj_locs: np.ndarray,  # (N, 2) f32 arriving object points
    obj_kw_ids: np.ndarray,  # (N, max_kw) i32 keyword id lists, -1 padded
    sub_rects: np.ndarray,  # (S, 4) f32 subscription rects
    sub_kw_ids,  # length-S sequence of keyword id lists (-1s ignored)
) -> np.ndarray:
    """(N, S) bool ground-truth continuous-filter match matrix.

    The brute-force host oracle for the pub-sub subsystem (DESIGN.md §8):
    pure set semantics -- object keywords as python sets, closed-rect
    containment per pair -- with none of the bitmap/packing/signature
    machinery the device path uses, so a shared-representation bug cannot
    hide. Empty keyword sets (either side) match nothing, the same Boolean
    contract as an empty SKR query.
    """
    obj_locs = np.asarray(obj_locs, np.float32).reshape(-1, 2)
    obj_kw_ids = np.asarray(obj_kw_ids, np.int64).reshape(obj_locs.shape[0], -1)
    sub_rects = np.asarray(sub_rects, np.float32).reshape(-1, 4)
    out = np.zeros((obj_locs.shape[0], sub_rects.shape[0]), bool)
    osets = [set(int(t) for t in row if t >= 0) for row in obj_kw_ids]
    for s, rect in enumerate(sub_rects):
        kset = set(int(t) for t in np.atleast_1d(np.asarray(sub_kw_ids[s])) if t >= 0)
        if not kset:
            continue
        for i, (x, y) in enumerate(obj_locs):
            if rect[0] <= x <= rect[2] and rect[1] <= y <= rect[3] and osets[i] & kset:
                out[i, s] = True
    return out


class SubscriptionOracle:
    """Ground-truth replay of a continuous-query event schedule (§8).

    The host twin of ``serve.subscribe.SubscriptionIndex``: the same event
    API (subscribe / unsubscribe / arrivals / drain) driven entirely by
    ``match_subscriptions_bruteforce``, with the same id-assignment scheme
    (dense monotonic subscription ids) so notification streams compare
    verbatim. Stream semantics: a subscription sees exactly the objects
    that arrive while it is live -- no retroactive delivery, no delivery
    after unsubscribe, and deleting an object never retracts an already
    emitted notification. Notifications are (object_id, subscription_id)
    pairs in canonical (object id, subscription id) order per arrival
    batch; ``drain()`` empties the queue (exactly-once)."""

    def __init__(self) -> None:
        self._subs = {}  # sub_id -> (rect, kw_ids)
        self._next_sub = 0
        self._pending: List[Tuple[int, int]] = []
        self.emitted_total = 0
        self.matched_total = 0

    def subscribe(self, rect, kw_ids) -> int:
        sid = self._next_sub
        self._next_sub += 1
        self._subs[sid] = (
            np.asarray(rect, np.float32).reshape(4),
            np.asarray(kw_ids, np.int64).reshape(-1),
        )
        return sid

    def unsubscribe(self, sub_id: int) -> bool:
        return self._subs.pop(int(sub_id), None) is not None

    def arrive(self, ids, locs, kw_ids) -> int:
        """Match one arrival batch against the live subscriptions; queue the
        resulting notifications. Returns how many were queued."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0 or not self._subs:
            return 0
        sids = sorted(self._subs)
        mat = match_subscriptions_bruteforce(
            locs, kw_ids,
            np.stack([self._subs[s][0] for s in sids]),
            [self._subs[s][1] for s in sids],
        )
        order = np.argsort(ids, kind="stable")
        n0 = len(self._pending)
        for i in order:
            for j in np.nonzero(mat[i])[0]:
                self._pending.append((int(ids[i]), int(sids[j])))
        n_new = len(self._pending) - n0
        self.matched_total += n_new
        return n_new

    def drain(self) -> np.ndarray:
        out = np.asarray(self._pending, np.int64).reshape(-1, 2)
        self._pending = []
        self.emitted_total += out.shape[0]
        return out


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


def propagate_hits(hit: np.ndarray, child_table: np.ndarray, n_down: int) -> np.ndarray:
    """(m, n_up) bool hits -> (m, n_down) bool active-children mask: a child
    is active iff its (unique) parent hit."""
    m = hit.shape[0]
    nxt = np.zeros((m, n_down), dtype=bool)
    for f in range(child_table.shape[1]):
        col = child_table[:, f]
        valid = col >= 0
        if valid.any():
            nxt[:, col[valid]] |= hit[:, valid]
    return nxt


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


def execute_level_sync(
    index: WiskIndex,
    dataset: GeoTextDataset,
    workload: Workload,
    w1: float = DEFAULT_W1,
    w2: float = DEFAULT_W2,
) -> QueryStats:
    """Vectorized traversal with (M, n_level) masks (the batched engine's
    execution shape)."""
    m = workload.m
    nodes = np.zeros(m, dtype=np.int64)
    active = np.ones((m, index.levels[0].n), dtype=bool)
    for li, level in enumerate(index.levels):
        mb = level.mbrs
        inter = (
            (mb[None, :, 0] <= workload.rects[:, None, 2])
            & (workload.rects[:, None, 0] <= mb[None, :, 2])
            & (mb[None, :, 1] <= workload.rects[:, None, 3])
            & (workload.rects[:, None, 1] <= mb[None, :, 3])
        )
        kw = np.any(level.bitmaps[None, :, :] & workload.kw_bitmap[:, None, :], axis=2)
        nodes += active.sum(axis=1)
        hit = active & inter & kw
        if li == len(index.levels) - 1:
            leaf_hit = hit
            break
        # propagate to children (CSR frontier expansion, dense-mask form)
        active = propagate_hits(hit, padded_child_table(level), index.levels[li + 1].n)
    # leaf verification (vectorized per leaf)
    verified = np.zeros(m, dtype=np.int64)
    results: List[List[np.ndarray]] = [[] for _ in range(m)]
    clusters = index.clusters
    for leaf in range(index.levels[-1].n):
        qs = np.nonzero(leaf_hit[:, leaf])[0]
        if qs.size == 0:
            continue
        ids = clusters.order[clusters.offsets[leaf] : clusters.offsets[leaf + 1]]
        bm = dataset.kw_bitmap[ids]
        locs = dataset.locs[ids]
        for qi in qs:
            match = np.any(bm & workload.kw_bitmap[qi][None, :], axis=1)
            verified[qi] += int(match.sum())
            sel = ids[match & points_in_rect(locs, workload.rects[qi])]
            if sel.size:
                results[qi].append(sel)
    res = [
        np.unique(np.concatenate(r)) if r else np.zeros(0, dtype=np.int32) for r in results
    ]
    cost = w1 * nodes.astype(np.float64) + w2 * verified.astype(np.float64)
    return QueryStats(nodes_accessed=nodes, verified=verified, results=res, cost=cost)


# ---------------------------------------------------------- Boolean kNN
@dataclasses.dataclass
class KnnResult:
    """One query's Boolean kNN answer plus Eq.1-style cost counters.

    ids/dist2 are sorted ascending by (distance, object id). ``ids`` may
    hold fewer than k entries when fewer objects match the query keywords.
    """

    ids: np.ndarray  # (k',) int32, k' <= k
    dist2: np.ndarray  # (k',) float32 squared distances
    nodes_accessed: int  # nodes popped & examined (MBR dist / bitmap checked)
    verified: int  # keyword-matching objects whose distance was computed


def _mbr_dist2_f32(mbrs: np.ndarray, point: np.ndarray) -> np.ndarray:
    """Squared point-to-MBR min-distance, float32, op by op -- the same
    arithmetic as the kNN kernels, so distance ties resolve identically."""
    mbrs = np.asarray(mbrs, np.float32)
    point = np.asarray(point, np.float32)
    dx = np.maximum(np.maximum(mbrs[..., 0] - point[..., 0], point[..., 0] - mbrs[..., 2]), 0.0)
    dy = np.maximum(np.maximum(mbrs[..., 1] - point[..., 1], point[..., 1] - mbrs[..., 3]), 0.0)
    return (dx * dx + dy * dy).astype(np.float32)


def knn_query(
    index: WiskIndex,
    dataset: GeoTextDataset,
    point: np.ndarray,
    kw_bitmap: np.ndarray,
    k: int,
) -> KnnResult:
    """Boolean kNN (appendix A): best-first search over the hierarchy.

    Equal-distance objects break ties by smallest object id, so the returned
    k-set is a pure function of (dataset, query).
    """
    empty = KnnResult(
        ids=np.zeros(0, np.int32), dist2=np.zeros(0, np.float32), nodes_accessed=0, verified=0
    )
    if k <= 0 or not np.any(kw_bitmap):
        return empty
    point = np.asarray(point, np.float32)
    heap: List[Tuple[float, int, int, int]] = []  # (dist, tie, level, node)
    tie = 0
    root_d = _mbr_dist2_f32(index.levels[0].mbrs, point)
    for u in range(index.levels[0].n):
        heapq.heappush(heap, (float(root_d[u]), tie, 0, u))
        tie += 1
    # selected objects: a max-heap on (-dist, -oid); its root is the entry to
    # evict -- the lexicographically largest (dist, oid)
    out: List[Tuple[float, int]] = []
    nodes = 0
    verified = 0
    clusters = index.clusters
    while heap:
        d, _, li, u = heapq.heappop(heap)
        # strict bound: a node at exactly the k-th distance may still hold an
        # equal-distance object with a smaller id, so only d > bound stops
        if len(out) >= k and d > -out[0][0]:
            break
        nodes += 1
        level = index.levels[li]
        if not np.any(level.bitmaps[u] & kw_bitmap):
            continue
        if li == len(index.levels) - 1:
            ids = clusters.order[clusters.offsets[u] : clusters.offsets[u + 1]]
            match = np.any(dataset.kw_bitmap[ids] & kw_bitmap[None, :], axis=1)
            sel = ids[match]
            verified += int(sel.size)
            dx = dataset.locs[sel, 0] - point[0]
            dy = dataset.locs[sel, 1] - point[1]
            dd_all = (dx * dx + dy * dy).astype(np.float32)
            for oid, dd in zip(sel, dd_all):
                key = (-float(dd), -int(oid))
                if len(out) < k:
                    heapq.heappush(out, key)
                elif key > out[0]:  # (dd, oid) < worst (dist, oid) kept
                    heapq.heapreplace(out, key)
        else:
            ch = level.child[level.child_ptr[u] : level.child_ptr[u + 1]]
            ch_d = _mbr_dist2_f32(index.levels[li + 1].mbrs[ch], point)
            for c, cd in zip(ch, ch_d):
                heapq.heappush(heap, (float(cd), tie, li + 1, int(c)))
                tie += 1
    out.sort(key=lambda t: (-t[0], -t[1]))  # ascending (dist, oid)
    return KnnResult(
        ids=np.array([-oid for _, oid in out], dtype=np.int32),
        dist2=np.array([-dd for dd, _ in out], dtype=np.float32),
        nodes_accessed=nodes,
        verified=verified,
    )


def knn_level_sync(
    index: WiskIndex,
    dataset: GeoTextDataset,
    points: np.ndarray,
    kw_bitmaps: np.ndarray,
    k: int,
) -> dict:
    """Vectorized distance-bounded Boolean kNN -- the host mirror of the
    device descent (``serve.engine.retrieve_knn``).

    Descends the levels with keyword-only masks (kNN has no rectangle), then
    sweeps each query's surviving leaves in ascending squared MBR
    min-distance, keeping the k best (dist, id) pairs and stopping as soon
    as the next leaf's min-distance exceeds the current k-th best. Returns a
    dict shaped like ``retrieve_knn``'s (ids padded with -1).
    """
    m = int(np.asarray(points).shape[0])
    points = np.asarray(points, np.float32)
    kw_bitmaps = np.asarray(kw_bitmaps, np.uint32)
    out = dict(
        ids=np.full((m, max(k, 0)), -1, np.int32),
        dist2=np.full((m, max(k, 0)), np.inf, np.float32),
        nodes_checked=np.zeros(m, np.int64),
        verified=np.zeros(m, np.int64),
        leaves_verified=np.zeros(m, np.int64),
        pruned=np.zeros(m, np.int64),
    )
    if k <= 0:
        return out
    # keyword-filtered level descent (an object's keywords are contained in
    # every ancestor bitmap, so this never prunes a leaf holding a match)
    active = np.ones((m, index.levels[0].n), dtype=bool)
    for li, level in enumerate(index.levels):
        out["nodes_checked"] += active.sum(axis=1)
        kw = np.any(level.bitmaps[None, :, :] & kw_bitmaps[:, None, :], axis=2)
        hit = active & kw
        if li == len(index.levels) - 1:
            leaf_hit = hit
            break
        active = propagate_hits(hit, padded_child_table(level), index.levels[li + 1].n)
    leaves = index.levels[-1]
    d2 = np.where(leaf_hit, _mbr_dist2_f32(leaves.mbrs[None, :, :], points[:, None, :]), np.inf)
    clusters = index.clusters
    id_sentinel = np.int64(np.iinfo(np.int32).max)
    for qi in range(m):
        order = np.argsort(d2[qi], kind="stable")  # ties: smallest leaf id first
        best_d = np.full(k, np.inf, np.float32)
        best_id = np.full(k, id_sentinel, np.int64)
        for pos, leaf in enumerate(order):
            dq = d2[qi, leaf]
            if not np.isfinite(dq):
                break
            if dq > best_d[k - 1]:
                out["pruned"][qi] += int(np.isfinite(d2[qi, order[pos:]]).sum())
                break
            ids = clusters.order[clusters.offsets[leaf] : clusters.offsets[leaf + 1]]
            kwm = np.any(dataset.kw_bitmap[ids] & kw_bitmaps[qi][None, :], axis=1)
            sel = ids[kwm]
            out["leaves_verified"][qi] += 1
            out["verified"][qi] += int(sel.size)
            if sel.size:
                dx = dataset.locs[sel, 0] - points[qi, 0]
                dy = dataset.locs[sel, 1] - points[qi, 1]
                od = (dx * dx + dy * dy).astype(np.float32)
                alld = np.concatenate([best_d, od])
                allid = np.concatenate([best_id, sel.astype(np.int64)])
                keep = np.lexsort((allid, alld))[:k]
                best_d, best_id = alld[keep], allid[keep]
        fin = np.isfinite(best_d)
        out["ids"][qi] = np.where(fin, best_id, -1).astype(np.int32)
        out["dist2"][qi] = best_d
    return out
