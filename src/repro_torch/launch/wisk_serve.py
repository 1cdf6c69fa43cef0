"""Serving front doors of the port: single device and multi-rank.

``serve_batch`` pads a batch to its power-of-two bucket, runs the SKR
engine (serve/engine.py; the frontier descent, or with ``mode="dense"`` the
dense A/B scan) on the snapshot's device and slices the pads off;
``serve_knn_batch`` does the same for Boolean kNN; both take an optional
live ``DeltaBuffer`` (serve/delta.py);
``HotQueryCache`` / ``serve_batch_cached`` serve repeated probes from an
LRU cache; ``MicroBatcher`` coalesces singleton queries into one dispatch.

Two multi-rank regimes run over a ``ServingMesh`` (launch/mesh.py) of
``torch.distributed`` ranks. Every rank makes the same call on the same
batch and gets the whole result dict back; each reference ``shard_map``
body is the code one rank runs, its ``lax`` collectives the mesh axes'.

* **Query-parallel, replicated index** (``serve_sharded`` /
  ``serve_knn_sharded``): the snapshot is replicated on every rank's
  device once per (snapshot, mesh); the batch is padded to per-shard
  power-of-two buckets and split over the data axis; each rank runs the
  frontier SKR descent or the bounded kNN descent on its rows. The ranks
  run at ``PlanCache.seeded_plan`` widths, max the observed per-level
  child counts over the data axis and grow-and-redescend to the fixed
  point (lossless as the overflow retry is). Ids and counters equal the
  single-device engine's.
* **Index-parallel, partitioned hierarchy** (``serve_index_sharded`` /
  ``serve_knn_index_sharded``): a ``PartitionedSnapshot`` cuts the root
  forest into shard-local sub-hierarchies and each rank holds only its
  slab; each descends from its masked local root frontier, and the
  results combine by collectives over the ``index`` axis -- an id union
  and summed Eq. 1 counters for SKR, a global top-k merge with bound
  exchanges for kNN. Composes with query parallelism on the 2D
  ``(data, index)`` mesh. A live delta is routed to the owning shards
  (``delta.partition_delta``).
* **The flat fallback** (launch/flat_legacy.py, ``wisk_serve_step``
  re-exported here): the hierarchy-free leaf-sharded scan.

On top of them sits the incremental-maintenance front door (DESIGN.md §7):
``LiveIndex`` buffers object inserts and deletes in the current
``ServingGeneration``'s ``DeltaLog``, merged into every descent; matches
every insert batch against the standing subscriptions
(serve/subscribe.py); watches the observed Eq. 1 cost with a
``DriftMonitor`` (core/drift.py); and on a trip warm-start rebuilds on the
recently observed traffic (``core.build.warm_start_rebuild``) and swaps the
fresh generation in with one reference store. With ``index_shards > 1`` it
serves through the index-parallel regime.

Host-side orchestration only, with the behaviour of the JAX package's
``launch/wisk_serve.py``.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.build import BuildConfig, build_wisk, warm_start_rebuild
from ..core.drift import DriftMonitor, observed_workload
from ..kernels import ops
from ..serve.delta import DeltaBuffer, DeltaLog, partition_delta
from ..serve.engine import (
    IndexSnapshot,
    _check_delta,
    _descend_frontier,
    _descend_knn,
    _descend_knn_indexed,
    _gather_cat,
    _local_root_frontier,
    _narrow_descent,
    _select_leaves_frontier,
    _select_leaves_indexed,
    _snap_cbank,
    _verify_leaves,
    retrieve,
    retrieve_knn,
    round_up_bucket,
)
from ..serve.plan import (
    ExecutionPlan,
    PlanCache,
    default_plan_cache,
    pad_knn_queries_to_bucket,
    pad_queries_to_bucket,
)
from ..serve.snapshot import PartitionedSnapshot, to_device
from ..serve.subscribe import SubscriptionIndex
from ..sharding.rules import dp_mesh_axes, shard_rows
from .mesh import ServingMesh, make_host_mesh, make_serving_mesh

_PER_QUERY_SKR = ("ids", "counts", "nodes_checked", "nodes_scanned", "verified", "overflow")
_PER_QUERY_KNN = ("ids", "dist2", "nodes_checked", "verified", "leaves_verified", "pruned")


def serve_batch(
    snap: IndexSnapshot,
    q_rects,
    q_bm,
    max_leaves: int = 32,
    mode: str = "frontier",
    minimum_bucket: int = 8,
    plan_cache: Optional[PlanCache] = None,
    delta: Optional[DeltaBuffer] = None,
    fused: Optional[bool] = None,
    compact: Optional[bool] = None,
):
    """Bucketed front door for the batched SKR engine.

    Args:
        snap: the served ``IndexSnapshot``.
        q_rects: (m, 4) f32 query rectangles ``(xlo, ylo, xhi, yhi)``.
        q_bm: (m, W) u32 query keyword bitmaps.
        max_leaves: per-query verification capacity (spill -> ``overflow``).
        mode, fused, compact: as in ``retrieve`` (``mode="dense"`` needs a
            snapshot built with ``dense=True``).
        minimum_bucket: smallest power-of-two batch bucket.
        plan_cache: frontier width state (None: per-snapshot default).
        delta: optional ``DeltaBuffer`` of buffered inserts and deletes,
            merged on the fly.

    Returns ``retrieve``'s dict with the pad queries sliced off.
    """
    rects, bms, m = pad_queries_to_bucket(q_rects, q_bm, minimum_bucket)
    out = retrieve(
        snap, rects, bms, max_leaves, mode=mode, plan_cache=plan_cache,
        delta=delta, fused=fused, compact=compact,
    )
    return {k: (v[:m] if k in _PER_QUERY_SKR else v) for k, v in out.items()}


def serve_knn_batch(
    snap: IndexSnapshot,
    points,
    q_bm,
    k: int,
    minimum_bucket: int = 8,
    plan_cache: Optional[PlanCache] = None,
    delta: Optional[DeltaBuffer] = None,
    knn_dtype: str = "f32",
    compact: Optional[bool] = None,
):
    """Bucketed front door for batched Boolean kNN: pad -> retrieve -> slice.

    Args:
        snap: the served ``IndexSnapshot``.
        points: (m, 2) f32 query points in the unit square.
        q_bm: (m, W) u32 query keyword bitmaps.
        k: neighbours per query.
        minimum_bucket: smallest power-of-two batch bucket.
        plan_cache: frontier width state (None: per-snapshot default).
        delta: optional ``DeltaBuffer`` merged on the fly.
        knn_dtype: ``"f32"`` (exact) or ``"bf16"`` -- reduced-precision
            bounded-sweep pruning with a conservative exact-f32 retry; ids
            are always identical to f32 (see ``retrieve_knn``).
        compact: leaf keyword-test width -- None uses the compact leaf bank
            when available; False forces full width.

    Returns ``retrieve_knn``'s dict: ``ids``/``dist2`` (m, k) ascending by
    (dist^2, id) with ``-1`` fill, plus the counters, pads sliced off.
    """
    pts, bms, m = pad_knn_queries_to_bucket(points, q_bm, minimum_bucket)
    out = retrieve_knn(
        snap, pts, bms, k, plan_cache=plan_cache, delta=delta, knn_dtype=knn_dtype,
        compact=compact,
    )
    return {key: (v[:m] if key in _PER_QUERY_KNN else v) for key, v in out.items()}


class HotQueryCache:
    """LRU result cache for repeated ("hot") SKR queries.

    Keys are ``(rect quantized to a 1/quant grid, bitmap bytes)``, so
    jittered re-issues of one probe fold onto one entry. Quantization only
    affects the KEY -- the value is the engine's exact output for the first
    query that produced it. ``hits``/``misses`` feed capacity tuning;
    ``invalidate()`` drops everything and must be called whenever served
    state changes.
    """

    def __init__(self, maxsize: int = 1024, quant: float = 4096.0) -> None:
        self.maxsize = int(maxsize)
        self.quant = float(quant)
        self._entries: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def key(self, rect, bm) -> bytes:
        q = np.rint(np.asarray(rect, np.float64) * self.quant).astype(np.int64)
        return q.tobytes() + np.asarray(bm, np.uint32).tobytes()

    def get(self, rect, bm):
        """The cached per-query result dict, or None (counts a hit/miss)."""
        k = self.key(rect, bm)
        got = self._entries.get(k)
        if got is None:
            self.misses += 1
            return None
        self._entries.move_to_end(k)
        self.hits += 1
        return got

    def put(self, rect, bm, result) -> None:
        k = self.key(rect, bm)
        self._entries[k] = result
        self._entries.move_to_end(k)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def invalidate(self) -> None:
        """Drop every entry (served state changed)."""
        self._entries.clear()
        self.invalidations += 1

    def __len__(self) -> int:
        return len(self._entries)


def serve_batch_cached(
    snap: IndexSnapshot,
    q_rects,
    q_bm,
    cache: HotQueryCache,
    max_leaves: int = 32,
    **serve_kw,
) -> Dict[str, np.ndarray]:
    """``serve_batch`` behind a ``HotQueryCache``: serve only the misses.

    Runs ONE ``serve_batch`` over the misses, fills the cache with their
    per-query rows, and reassembles the batch in submission order. Adds a
    ``cached`` (m,) bool mask. ``serve_kw`` (``delta`` included) goes to
    ``serve_batch``; the caller invalidates the cache whenever the served
    state changes. ``ids`` rows are padded to the batch's widest
    capacity with ``-1``.
    """
    rects = np.asarray(q_rects, np.float32).reshape(-1, 4)
    bms = np.asarray(q_bm, np.uint32).reshape(len(rects), -1)
    m = len(rects)
    entries = [cache.get(rects[i], bms[i]) for i in range(m)]
    cached = np.array([e is not None for e in entries], bool)
    miss = np.flatnonzero(~cached)
    if miss.size:
        out = serve_batch(snap, rects[miss], bms[miss], max_leaves, **serve_kw)
        for j, i in enumerate(miss):
            entry = {k: np.asarray(out[k])[j] for k in _PER_QUERY_SKR}
            cache.put(rects[i], bms[i], entry)
            entries[i] = entry
    width = max((e["ids"].shape[0] for e in entries), default=0)

    def _row(e, k):
        v = e[k]
        if k == "ids" and v.shape[0] < width:
            v = np.concatenate([v, np.full(width - v.shape[0], -1, v.dtype)])
        return v

    result = {k: np.stack([_row(e, k) for e in entries]) for k in _PER_QUERY_SKR}
    result["cached"] = cached
    return result


class MicroBatcher:
    """Deadline-free micro-batching for the SKR front door.

    ``submit`` enqueues and returns a ticket; the batch runs when the caller
    calls ``flush()`` (or automatically once ``flush_at`` queries are
    pending). ``result(ticket)`` returns (and drops) one query's row dict,
    flushing first if the ticket is still pending. With a ``cache`` the
    flush goes through ``serve_batch_cached`` and rows carry ``cached``.
    ``flushes``/``served`` expose the achieved batching factor.
    """

    def __init__(
        self,
        snap: IndexSnapshot,
        max_leaves: int = 32,
        flush_at: int = 8,
        cache: Optional[HotQueryCache] = None,
        **serve_kw,
    ) -> None:
        if flush_at < 1:
            raise ValueError(f"flush_at must be >= 1, got {flush_at}")
        self.snap = snap
        self.max_leaves = max_leaves
        self.flush_at = int(flush_at)
        self.cache = cache
        self.serve_kw = serve_kw
        self._pending: list = []  # [(ticket, rect, bm)]
        self._done: dict = {}
        self._next = 0
        self.flushes = 0
        self.served = 0

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, rect, bm) -> int:
        """Enqueue one query; returns its ticket. Auto-flushes at
        ``flush_at`` pending queries."""
        t = self._next
        self._next += 1
        self._pending.append(
            (t, np.asarray(rect, np.float32).reshape(4), np.asarray(bm, np.uint32).reshape(-1))
        )
        if len(self._pending) >= self.flush_at:
            self.flush()
        return t

    def flush(self) -> int:
        """Serve every pending query in one dispatch; returns how many."""
        if not self._pending:
            return 0
        tickets = [t for t, _, _ in self._pending]
        rects = np.stack([r for _, r, _ in self._pending])
        bms = np.stack([b for _, _, b in self._pending])
        self._pending = []
        if self.cache is not None:
            out = serve_batch_cached(
                self.snap, rects, bms, self.cache, self.max_leaves, **self.serve_kw
            )
            keys = _PER_QUERY_SKR + ("cached",)
        else:
            out = serve_batch(self.snap, rects, bms, self.max_leaves, **self.serve_kw)
            keys = _PER_QUERY_SKR
        for j, t in enumerate(tickets):
            self._done[t] = {k: np.asarray(out[k])[j] for k in keys}
        self.flushes += 1
        self.served += len(tickets)
        return len(tickets)

    def result(self, ticket: int) -> Dict[str, np.ndarray]:
        """One query's result row (popped); flushes if still pending."""
        if ticket not in self._done:
            self.flush()
        return self._done.pop(ticket)


# ------------------------------------- query-parallel multi-rank serving
def default_serving_mesh() -> ServingMesh:
    """Every rank on the data axis (query-parallel serving)."""
    n = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    return make_host_mesh(data=n, model=1)


def mesh_dp_size(mesh: ServingMesh) -> int:
    """Number of query shards: the product of the mesh's data axes."""
    return math.prod(a.size for a in dp_mesh_axes(mesh))


# Replicated-snapshot memo: putting a production-scale index on a rank's
# device is the expensive part of the query-parallel path, so it happens
# once per (snapshot, mesh), not once per served batch. Weakly keyed like
# plan.default_plan_cache: dropping the snapshot drops its replicas.
_REPLICATED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _replicated(obj, mesh: ServingMesh):
    """``obj`` (a snapshot or a delta) on the mesh rank's device, memoized.
    An ``obj`` already on that device is its own replica and is not stored:
    a value that is its key would keep the key alive for good."""
    got = _REPLICATED.get(obj, {}).get(mesh)
    if got is None:
        got = obj.replicate(mesh)
        if got is not obj:
            _REPLICATED.setdefault(obj, {})[mesh] = got
    return got


def _converge_widths(snap, cache: PlanCache, tag: str, run):
    """Shared grow-and-redescend loop of the query-parallel front doors:
    descend at the cache's seeded widths, max the observed per-level child
    counts across query shards, grow the cache, and repeat until nothing
    overflowed -- lossless for the same reason the overflow retry is (a
    descent that finishes without overflow dropped no children), and
    convergent because widths only grow, in power-of-two steps. ``run``
    returns a tuple whose LAST element is the maxed per-level maxima, equal
    on every rank, so every rank's cache takes the same steps."""
    n_links = snap.n_levels - 1
    while True:
        widths = cache.seeded_plan(tag, n_links).widths
        out = run(widths)
        maxima = out[-1].cpu().numpy()
        cache.observe(tag, maxima)
        if not n_links or not np.any(maxima > np.asarray(widths)):
            return widths, out


def _shard_queries(mesh: ServingMesh, device, q, bms, pack: bool):
    """This rank's query rows on ``device``: ``q`` (rects or points) f32,
    the bitmaps as their int32 view and, with ``pack``, the packed words
    ``(wids, bits)`` -- packed over the whole padded batch first, so every
    rank reads the same word width."""
    words = ops.host_words(bms)
    packed = ops.pack_query_words(words) if pack else None
    mine = lambda a: to_device(shard_rows(a, "query", mesh), device)  # noqa: E731
    return (mine(np.asarray(q, np.float32)), mine(words),
            None if packed is None else (mine(packed[0]), mine(packed[1])))


def _pmax_needs(needs, dp, device):
    """Stack the per-level observed child-count maxima and max them across
    the query shards: the plan cache must learn widths that fit EVERY
    shard."""
    if not needs:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    arr = torch.stack([torch.as_tensor(n, device=device) for n in needs]).to(torch.int32)
    for ax in dp:
        arr = ax.pmax(arr)
    return arr


def _gather_rows(t: torch.Tensor, dp) -> np.ndarray:
    """The whole batch's rows of a per-query-shard output, on the host (the
    reference's ``P(dp, ...)`` out_spec)."""
    for ax in reversed(dp):
        t = ax.all_gather(t).reshape((-1,) + tuple(t.shape[1:]))
    return t.cpu().numpy()


def _skr_shard_body(snap, delta, q_rects, q_bm, *, widths, take, dp, narrow, compact):
    """One query shard's SKR serving: the frontier descent on the local
    rows against the replicated snapshot (and replicated delta, when one is
    live); the only collective is the width maxima's max."""
    plan = ExecutionPlan(tag="skr", widths=widths)
    frontier, surv, nodes_checked, _, needs = _descend_frontier(
        snap, q_rects, q_bm, narrow, plan, delta)
    top_leaf, leaf_ok, overflow = _select_leaves_frontier(frontier, surv, take, snap.n_leaves)
    ids, counts, kw_scanned = _verify_leaves(
        snap, q_rects, q_bm, None, top_leaf, leaf_ok, delta, None, "auto", compact)
    return ids, counts, nodes_checked, kw_scanned, overflow, _pmax_needs(needs, dp, snap.device)


def serve_sharded(
    snap: IndexSnapshot,
    q_rects,
    q_bm,
    max_leaves: int = 32,
    mesh: Optional[ServingMesh] = None,
    plan_cache: Optional[PlanCache] = None,
    minimum_bucket: int = 8,
    delta: Optional[DeltaBuffer] = None,
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Query-parallel SKR serving of the hierarchical engine.

    Args:
        snap: the served ``IndexSnapshot`` (any device; replicated on each
            mesh rank's device once).
        q_rects: (m, 4) f32 query rectangles; ``q_bm``: (m, W) u32 bitmaps.
        max_leaves: per-query verification capacity (spill -> ``overflow``).
        mesh: serving mesh (None: every rank on the data axis).
        plan_cache: frontier width state (None: per-snapshot default).
        minimum_bucket: smallest per-shard power-of-two batch bucket.
        delta: optional ``DeltaBuffer`` over ``snap``, replicated like the
            snapshot and merged per shard.
        compact: leaf verification width (None: the compact bank when the
            snapshot has one; False: full width).

    Every rank calls it with the same batch and gets the same dict: the
    single-device ``retrieve``'s, ids and counters identical.
    """
    mesh = mesh if mesh is not None else default_serving_mesh()
    cache = plan_cache if plan_cache is not None else default_plan_cache(snap)
    rects, bms, m = pad_queries_to_bucket(q_rects, q_bm, minimum_bucket,
                                          shards=mesh_dp_size(mesh))
    snap_r = _replicated(snap, mesh)
    delta_r = _replicated(delta, mesh) if delta is not None else None
    _check_delta(snap_r, delta_r)
    narrow = _narrow_descent(snap_r, None, delta_r)
    rects_d, bms_d, _ = _shard_queries(mesh, snap_r.device, rects, bms, False)
    dp = dp_mesh_axes(mesh)

    def run(widths):
        leaf_width = widths[-1] if widths else snap.root_width()
        take = min(max_leaves, snap.n_leaves, leaf_width)
        return _skr_shard_body(snap_r, delta_r, rects_d, bms_d, widths=widths, take=take, dp=dp,
                               narrow=narrow, compact=compact)

    widths, out = _converge_widths(snap, cache, "skr", run)
    ids, counts, nodes_checked, kw_scanned, overflow = (_gather_rows(t, dp) for t in out[:5])
    used = [snap.root_width(), *widths]
    return dict(
        ids=ids[:m],
        counts=counts[:m],
        nodes_checked=nodes_checked.astype(np.int64)[:m],
        nodes_scanned=np.full((m,), sum(used), np.int64),
        verified=kw_scanned[:m],
        overflow=overflow[:m],
        frontier_widths=np.asarray(used, np.int32),
    )


def _knn_shard_body(snap, delta, points, q_bm, words, *, widths, k, kb, dp, narrow, compact):
    """One query shard's Boolean kNN: the bounded descent on the local rows
    against the replicated snapshot (and replicated delta)."""
    plan = ExecutionPlan(tag="knn", widths=widths)
    result, needs = _descend_knn(snap, points, q_bm, words, narrow, delta,
                                 _snap_cbank(snap, compact), k, kb, plan, "f32")
    top_d, top_id, nodes_checked, verified, leaves_verified, pruned, _, _ = result
    ids = torch.where(torch.isfinite(top_d[:, :k]), top_id[:, :k], -1)
    return (ids, top_d[:, :k], nodes_checked, verified, leaves_verified, pruned,
            _pmax_needs(needs, dp, snap.device))


def _knn_dict(out, m: int, used, dp) -> Dict[str, np.ndarray]:
    ids, dist2, nodes_checked, verified, leaves_verified, pruned = (
        _gather_rows(t, dp) for t in out[:6])
    return dict(
        ids=ids[:m],
        dist2=dist2[:m],
        nodes_checked=nodes_checked.astype(np.int64)[:m],
        verified=verified.astype(np.int64)[:m],
        leaves_verified=leaves_verified.astype(np.int64)[:m],
        pruned=pruned.astype(np.int64)[:m],
        frontier_widths=np.asarray(used, np.int32),
    )


def _empty_knn(points) -> Dict[str, np.ndarray]:
    M = int(np.asarray(points).reshape(-1, 2).shape[0])
    z = np.zeros(M, np.int64)
    return dict(
        ids=np.zeros((M, 0), np.int32), dist2=np.zeros((M, 0), np.float32),
        nodes_checked=z, verified=z.copy(), leaves_verified=z.copy(),
        pruned=z.copy(), frontier_widths=np.zeros(0, np.int32),
    )


def serve_knn_sharded(
    snap: IndexSnapshot,
    points,
    q_bm,
    k: int,
    mesh: Optional[ServingMesh] = None,
    plan_cache: Optional[PlanCache] = None,
    minimum_bucket: int = 8,
    min_topk_bucket: int = 8,
    delta: Optional[DeltaBuffer] = None,
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Query-parallel Boolean kNN serving of the bounded descent.

    Same regime as ``serve_sharded``: replicated snapshot, the batch split
    over the data axis, seeded-width descent with grow-and-redescend
    convergence. ``minimum_bucket`` / ``min_topk_bucket`` floor the
    per-shard batch and the top-k buffer. Identical ids, ``dist2`` and
    counters to ``retrieve_knn``.
    """
    if k <= 0:  # the single-device engine's degenerate shape
        return _empty_knn(points)
    mesh = mesh if mesh is not None else default_serving_mesh()
    cache = plan_cache if plan_cache is not None else default_plan_cache(snap)
    pts, bms, m = pad_knn_queries_to_bucket(points, q_bm, minimum_bucket,
                                            shards=mesh_dp_size(mesh))
    snap_r = _replicated(snap, mesh)
    delta_r = _replicated(delta, mesh) if delta is not None else None
    _check_delta(snap_r, delta_r)
    narrow = _narrow_descent(snap_r, None, delta_r)
    pts_d, bms_d, words = _shard_queries(mesh, snap_r.device, pts, bms, True)
    kb = round_up_bucket(k, min_topk_bucket)
    dp = dp_mesh_axes(mesh)
    widths, out = _converge_widths(
        snap, cache, "knn",
        lambda widths: _knn_shard_body(snap_r, delta_r, pts_d, bms_d, words, widths=widths, k=k,
                                       kb=kb, dp=dp, narrow=narrow, compact=compact),
    )
    return _knn_dict(out, m, [snap.root_width(), *widths], dp)


# ------------------------------------- index-parallel multi-rank serving
def mesh_index_size(mesh: ServingMesh) -> int:
    """Number of index shards: the size of the mesh's ``index`` axis."""
    return mesh.axis("index").size if "index" in mesh.axis_names else 1


def default_index_mesh(n_shards: int) -> ServingMesh:
    """Every rank in a (query, index) serving mesh with ``n_shards`` index
    shards (the remaining factor goes to query parallelism)."""
    n = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if n % n_shards:
        raise ValueError(f"{n} ranks not divisible into {n_shards} index shards")
    return make_serving_mesh(query=n // n_shards, index=n_shards)


class _Placed(NamedTuple):
    """One rank's placed slab: the shard-local snapshot, its global-id maps
    and its real root count."""

    snap: IndexSnapshot
    root_gid: torch.Tensor
    leaf_gid: torch.Tensor
    n_root_local: int


# Placement memos, mirroring _REPLICATED: moving a production-scale slab
# (or a delta routed to its shards) happens once per (object, mesh), not
# once per served batch.
_PLACED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _placed(psnap: PartitionedSnapshot, mesh: ServingMesh) -> _Placed:
    per_mesh = _PLACED.setdefault(psnap, {})
    got = per_mesh.get(mesh)
    if got is None:
        got = _Placed(psnap.shard(mesh), *psnap.shard_ids(mesh))
        per_mesh[mesh] = got
    return got


# Keyed by the (immutable) DeltaBuffer: every LiveIndex update makes a NEW
# buffer, so a fresh buffer is routed to its owning shards exactly once, on
# its first served batch.
_PARTITIONED_DELTA: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _partitioned_delta(delta: DeltaBuffer, psnap: PartitionedSnapshot, mesh: ServingMesh):
    per_key = _PARTITIONED_DELTA.setdefault(delta, {})
    got = per_key.get((mesh, psnap.part))
    if got is None:
        got = partition_delta(delta, psnap.part).shard(mesh)
        per_key[(mesh, psnap.part)] = got
    return got


def _converge_widths_indexed(cache: PlanCache, tag: str, n_shards: int, n_links: int, run):
    """Index-parallel twin of ``_converge_widths``: the observed per-level
    child-count maxima come back as an (S, n_links) matrix (each index
    shard's hierarchy has its own fan-outs), the cache learns per-shard
    sub-tags, and every shard of the next descent runs at the max width
    over shards (``seeded_shard_plan``)."""
    while True:
        widths = cache.seeded_shard_plan(tag, n_shards, n_links).widths
        out = run(widths)
        maxima = out[-1].cpu().numpy().reshape(n_shards, -1)
        cache.observe_shards(tag, maxima)
        if not n_links or not np.any(maxima.max(axis=0) > np.asarray(widths)):
            return widths, out


def _check_index_mesh(psnap: PartitionedSnapshot, mesh: ServingMesh) -> None:
    if mesh_index_size(mesh) != psnap.n_shards:
        raise ValueError(
            f"mesh index axis {mesh_index_size(mesh)} != partition shards {psnap.n_shards}")


def _ix_skr_body(placed: _Placed, delta, q_rects, q_bm, *, widths, take_g, take_loc, dp, index,
                 narrow, compact):
    """One (query shard, index shard)'s SKR: the engine descent on this
    rank's sub-hierarchy from its masked local root frontier, then two
    collectives over ``index`` -- the global smallest-gid leaf selection
    (``_select_leaves_indexed``: one bound exchange and a summed overflow)
    and the sum of the Eq. 1 counters. Result ids stay local (the caller
    concatenates the per-shard id unions); counters leave already global."""
    snap = placed.snap
    plan = ExecutionPlan(tag="skr_ix", widths=widths)
    root = _local_root_frontier(snap.root_width(), placed.n_root_local, q_rects.shape[0],
                                snap.device)
    frontier, surv, nodes_checked, _, needs = _descend_frontier(
        snap, q_rects, q_bm, narrow, plan, delta, root=root)
    top_leaf, leaf_ok, overflow = _select_leaves_indexed(
        frontier, surv, placed.leaf_gid, take_g, take_loc, index)
    ids, counts, kw_scanned = _verify_leaves(
        snap, q_rects, q_bm, None, top_leaf, leaf_ok, delta, None, "auto", compact)
    needs_all = index.all_gather(_pmax_needs(needs, dp, snap.device))  # (S, links)
    return (ids, index.psum(counts), index.psum(nodes_checked), index.psum(kw_scanned), overflow,
            needs_all)


def serve_index_sharded(
    psnap: PartitionedSnapshot,
    q_rects,
    q_bm,
    max_leaves: int = 32,
    mesh: Optional[ServingMesh] = None,
    plan_cache: Optional[PlanCache] = None,
    minimum_bucket: int = 8,
    delta: Optional[DeltaBuffer] = None,
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Index-parallel SKR serving: the hierarchy itself sharded.

    Args:
        psnap: a ``PartitionedSnapshot`` (``PartitionedSnapshot.build``);
            each rank places only its slab on its device.
        q_rects: (m, 4) f32 query rectangles; ``q_bm``: (m, W) u32 bitmaps.
        max_leaves: per-query verification capacity, global: the selection
            keeps the ``max_leaves`` smallest-id surviving leaves ACROSS
            shards, as the single-device engine does (spill ->
            ``overflow``).
        mesh: a serving mesh whose ``index`` axis has ``psnap.n_shards``
            ranks (None: every rank, query x index).
        plan_cache: frontier width state (None: per-partition default);
            learns per-shard sub-tags (``PlanCache.seeded_shard_plan``).
        minimum_bucket: smallest per-query-shard power-of-two batch bucket.
        delta: optional ``DeltaBuffer`` over the partitioned snapshot, in
            the ordinary global layout -- routed to the owning shards
            (``delta.partition_delta``, once per buffer) and merged
            shard-locally.

    Returns the ``retrieve`` dict: ``counts``/``nodes_checked``/``verified``
    /``overflow`` equal to the single-device engine's, ``ids`` the same id
    SET per query (in shard-concatenation order). ``nodes_scanned`` sums
    every shard's frontier slots, the one counter that depends on the
    layout.
    """
    S = psnap.n_shards
    mesh = mesh if mesh is not None else default_index_mesh(S)
    _check_index_mesh(psnap, mesh)
    cache = plan_cache if plan_cache is not None else default_plan_cache(psnap)
    rects, bms, m = pad_queries_to_bucket(q_rects, q_bm, minimum_bucket,
                                          shards=mesh_dp_size(mesh))
    placed = _placed(psnap, mesh)
    delta_s = _partitioned_delta(delta, psnap, mesh) if delta is not None else None
    _check_delta(placed.snap, delta_s)
    narrow = _narrow_descent(placed.snap, None, delta_s)
    rects_d, bms_d, _ = _shard_queries(mesh, mesh.device, rects, bms, False)
    dp, index = dp_mesh_axes(mesh), mesh.axis("index")
    n_links = psnap.n_levels - 1

    def run(widths):
        leaf_width = widths[-1] if widths else psnap.local_root_width()
        take_g = min(max_leaves, psnap.n_leaves_global)
        take_loc = min(take_g, leaf_width)
        return _ix_skr_body(placed, delta_s, rects_d, bms_d, widths=widths, take_g=take_g,
                            take_loc=take_loc, dp=dp, index=index, narrow=narrow, compact=compact)

    widths, out = _converge_widths_indexed(cache, "skr_ix", S, n_links, run)
    ids = _gather_rows(_gather_cat(out[0], index), dp)
    counts, nodes_checked, kw_scanned, overflow = (_gather_rows(t, dp) for t in out[1:5])
    used = [psnap.local_root_width(), *widths]
    return dict(
        ids=ids[:m],
        counts=counts[:m],
        nodes_checked=nodes_checked.astype(np.int64)[:m],
        nodes_scanned=np.full((m,), sum(used) * S, np.int64),
        verified=kw_scanned[:m],
        overflow=overflow[:m],
        frontier_widths=np.asarray(used, np.int32),
    )


def _ix_knn_body(placed: _Placed, delta, points, q_bm, words, *, widths, k, kb, dp, index, narrow,
                 compact):
    """One (query shard, index shard)'s kNN: ``_descend_knn_indexed``
    (canonical-probe election, shard-local bounded sweep, global-rank leaf
    phase) and the counter sums. The top-k buffers leave the descent equal
    on every shard (the leaf phase ends on a global merge)."""
    snap = placed.snap
    plan = ExecutionPlan(tag="knn_ix", widths=widths)
    result, needs = _descend_knn_indexed(
        snap, placed.root_gid, placed.leaf_gid, placed.n_root_local, points, q_bm, words, narrow,
        delta, _snap_cbank(snap, compact), k, kb, plan, index)
    top_d, top_id, nodes_checked, verified, leaves_verified, pruned, _ = result
    ids = torch.where(torch.isfinite(top_d[:, :k]), top_id[:, :k], -1)
    return (ids, top_d[:, :k], index.psum(nodes_checked), index.psum(verified),
            index.psum(leaves_verified), index.psum(pruned),
            index.all_gather(_pmax_needs(needs, dp, snap.device)))


def serve_knn_index_sharded(
    psnap: PartitionedSnapshot,
    points,
    q_bm,
    k: int,
    mesh: Optional[ServingMesh] = None,
    plan_cache: Optional[PlanCache] = None,
    minimum_bucket: int = 8,
    min_topk_bucket: int = 8,
    delta: Optional[DeltaBuffer] = None,
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Index-parallel Boolean kNN serving: the hierarchy itself sharded.

    Same contract as ``serve_knn_sharded`` but over a
    ``PartitionedSnapshot``: ids, ``dist2`` and every counter except
    ``frontier_widths`` equal the single-device ``retrieve_knn``'s (the
    bound exchanges in ``_descend_knn_indexed`` reproduce its probe chain,
    prune decisions and chunked leaf order). ``delta`` arrives in the
    global layout and is routed to the owning shards. Always exact f32.
    """
    if k <= 0:  # the single-device engine's degenerate shape
        return _empty_knn(points)
    S = psnap.n_shards
    mesh = mesh if mesh is not None else default_index_mesh(S)
    _check_index_mesh(psnap, mesh)
    cache = plan_cache if plan_cache is not None else default_plan_cache(psnap)
    pts, bms, m = pad_knn_queries_to_bucket(points, q_bm, minimum_bucket,
                                            shards=mesh_dp_size(mesh))
    placed = _placed(psnap, mesh)
    delta_s = _partitioned_delta(delta, psnap, mesh) if delta is not None else None
    _check_delta(placed.snap, delta_s)
    narrow = _narrow_descent(placed.snap, None, delta_s)
    pts_d, bms_d, words = _shard_queries(mesh, mesh.device, pts, bms, True)
    kb = round_up_bucket(k, min_topk_bucket)
    dp, index = dp_mesh_axes(mesh), mesh.axis("index")
    widths, out = _converge_widths_indexed(
        cache, "knn_ix", S, psnap.n_levels - 1,
        lambda widths: _ix_knn_body(placed, delta_s, pts_d, bms_d, words, widths=widths, k=k,
                                    kb=kb, dp=dp, index=index, narrow=narrow, compact=compact),
    )
    return _knn_dict(out, m, [psnap.local_root_width(), *widths], dp)


# ------------------------------- incremental maintenance front door (§7)
@dataclasses.dataclass(frozen=True)
class ServingGeneration:
    """One immutable serving epoch (DESIGN.md §7).

    Everything a request touches -- snapshot, delta log, plan cache, the
    backing dataset and artifacts -- is bundled so replacing a generation is
    ONE reference store (``LiveIndex._gen = new``): an in-flight batch that
    grabbed the old generation keeps serving a consistent view; the next
    batch sees the new one. ``seq`` increments per swap.
    """

    artifacts: object  # core.build.BuildArtifacts
    dataset: object  # core.types.GeoTextDataset
    snapshot: IndexSnapshot
    delta_log: DeltaLog
    plan_cache: PlanCache
    seq: int = 0
    # index-parallel regime: the snapshot's partition, rebuilt per
    # generation (a rebuild re-cuts the fresh hierarchy); None = one device
    partitioned: Optional[PartitionedSnapshot] = None

    def delta(self) -> Optional[DeltaBuffer]:
        """The live delta, or None when no updates are buffered (the
        executors' zero-overhead fast path)."""
        return self.delta_log.buffer if self.delta_log.n_updates() else None


class LiveIndex:
    """Serving front door that survives live traffic (DESIGN.md §7).

    Ties the incremental subsystem together: object updates land in the
    current generation's ``DeltaLog`` and are merged into every query on
    the fly; a ``DriftMonitor`` watches the observed per-query Eq.1 cost;
    and ``maybe_rebuild()`` reacts to a trip by warm-start rebuilding on
    the recently observed workload and atomically swapping in the fresh
    ``IndexSnapshot`` -- serving never blocks on a rebuild, in-flight
    batches finish on the generation they started on.

    All methods are host-side control plane; the descents they drive run on
    ``device`` (``cuda`` unless the caller names another; raises where CUDA
    is absent), where the build, every generation's snapshot, the
    subscription block and the warm rebuild's split learner live. Given
    ``artifacts``, their CDF bank moves there. Single-writer discipline:
    updates and swaps are expected from one maintenance thread; readers may
    hold ``generation`` freely.

    Index-parallel serving: with ``index_shards > 1`` (or an
    ``index_mesh``, whose ``index`` axis sets the count) every generation's
    snapshot stays on the host, is partitioned into that many shard-local
    sub-hierarchies, and each rank serves its slab on the mesh's device
    through ``serve_index_sharded`` / ``serve_knn_index_sharded``; updates
    land in the global-layout ``DeltaLog`` on the host and are routed to
    their owning shards once per buffer. Every rank of the mesh makes the
    same calls with the same arguments and holds the same host state;
    ``maybe_rebuild`` checks that the ranks agree on the decision, runs the
    warm rebuild on rank 0 and broadcasts its artifacts.
    """

    def __init__(
        self,
        dataset,
        workload,
        build_config=None,
        drift_config=None,
        artifacts=None,
        max_recent: int = 512,
        slots_per_leaf: int = 8,
        result_cache: Optional[HotQueryCache] = None,
        index_shards: int = 1,
        index_mesh: Optional[ServingMesh] = None,
        device=None,
    ) -> None:
        self.build_config = build_config or BuildConfig()
        self._slots_per_leaf = slots_per_leaf
        self.index_shards = int(index_shards)
        if index_mesh is not None and self.index_shards == 1:
            self.index_shards = mesh_index_size(index_mesh)
        if self.index_shards > 1 and index_mesh is None:
            index_mesh = default_index_mesh(self.index_shards)
        self.index_mesh = index_mesh
        if index_mesh is None:
            self.device = resolve_device(device)
        elif device is not None and resolve_device(device) != index_mesh.device:
            raise ValueError(f"device {device} is not the index mesh's {index_mesh.device}")
        else:
            self.device = index_mesh.device
        # hot-query result cache (§3.5): exact results keyed on the current
        # served state, so every state change below must invalidate it
        self.result_cache = result_cache
        if artifacts is None:
            artifacts = self._built_once(
                lambda: build_wisk(dataset, workload, self.build_config, device=self.device))
        else:
            artifacts = dataclasses.replace(artifacts, bank=artifacts.bank.to(self.device))
        self._gen = self._make_generation(artifacts, dataset, seq=0)
        # continuous-filter pub-sub (DESIGN.md §8): the standing-subscription
        # index + notification log live on the front door, NOT on a
        # generation -- subscriptions, queued notifications, and the
        # exactly-once high-water mark (global object ids are monotonic
        # across rebuilds) all survive maybe_rebuild() swaps untouched
        self.subscriptions = SubscriptionIndex(dataset.vocab_size, device=self.device)
        # baseline learned from the warmup window of observed traffic (see
        # core/drift.py: a trained-workload prediction undershoots steady
        # state by the generalization gap)
        self.monitor = DriftMonitor(None, drift_config)
        self.max_recent = max_recent
        self._recent_rects: list = []
        self._recent_bms: list = []
        self.swaps = 0

    @property
    def sharded(self) -> bool:
        return self.index_shards > 1

    def _built_once(self, build):
        """``build()``'s artifacts; in the index-parallel regime rank 0
        builds and broadcasts them (the bank travels on the host, and each
        rank moves it to its device)."""
        if not self.sharded:
            return build()
        art = build() if self.index_mesh.rank == 0 else None
        if art is not None:
            art = dataclasses.replace(art, bank=art.bank.to("cpu"))
        art = self.index_mesh.broadcast_object(art)
        return dataclasses.replace(art, bank=art.bank.to(self.device))

    def _make_generation(self, artifacts, dataset, seq: int) -> ServingGeneration:
        # the index-parallel regime keeps the whole snapshot (and the delta
        # log over it) on the host; only each rank's slab reaches its device
        snapshot = IndexSnapshot.build(artifacts.index, dataset,
                                       device="cpu" if self.sharded else self.device)
        partitioned = (PartitionedSnapshot.build(snapshot, self.index_shards)
                       if self.sharded else None)
        return ServingGeneration(
            artifacts=artifacts,
            dataset=dataset,
            snapshot=snapshot,
            delta_log=DeltaLog(artifacts.index, dataset, snapshot, self._slots_per_leaf),
            plan_cache=PlanCache(),
            seq=seq,
            partitioned=partitioned,
        )

    @property
    def generation(self) -> ServingGeneration:
        """The current generation; grab once per batch for a stable view."""
        return self._gen

    # ------------------------------------------------------------- serving
    def _record(self, rects, bms) -> None:
        self._recent_rects.extend(np.asarray(rects, np.float32).reshape(-1, 4))
        self._recent_bms.extend(np.asarray(bms, np.uint32).reshape(len(rects), -1))
        drop = len(self._recent_rects) - self.max_recent
        if drop > 0:
            del self._recent_rects[:drop]
            del self._recent_bms[:drop]

    def serve(self, q_rects, q_bm, max_leaves: int = 32) -> Dict[str, np.ndarray]:
        """Delta-merged SKR batch through the current generation; feeds the
        drift monitor with the observed Eq.1 counters.

        With a ``result_cache`` the batch goes through ``serve_batch_cached``
        and only MISS rows feed the monitor -- cache hits cost nothing, and
        counting them would mask drift in exactly the hot traffic a rebuild
        should follow.

        In the index-parallel regime the batch goes through
        ``serve_index_sharded`` over the partitioned snapshot, with the live
        delta routed to its owning shards; the result cache is bypassed
        (the counters are the same either way, so the monitor's feed is
        too)."""
        gen = self._gen
        if gen.partitioned is not None:
            out = serve_index_sharded(
                gen.partitioned, q_rects, q_bm, max_leaves, mesh=self.index_mesh,
                plan_cache=gen.plan_cache, delta=gen.delta(),
            )
            self._record(q_rects, q_bm)
            self.monitor.observe_counters(np.asarray(out["nodes_checked"]),
                                          np.asarray(out["verified"]))
            return out
        if self.result_cache is not None:
            out = serve_batch_cached(
                gen.snapshot, q_rects, q_bm, self.result_cache, max_leaves,
                plan_cache=gen.plan_cache, delta=gen.delta(),
            )
            fresh = ~out["cached"]
        else:
            out = serve_batch(
                gen.snapshot, q_rects, q_bm, max_leaves,
                plan_cache=gen.plan_cache, delta=gen.delta(),
            )
            fresh = slice(None)
        self._record(q_rects, q_bm)
        nc = np.asarray(out["nodes_checked"])[fresh]
        if nc.size:  # an all-hit batch observed no real descents
            self.monitor.observe_counters(nc, np.asarray(out["verified"])[fresh])
        return out

    def serve_knn(self, points, q_bm, k: int) -> Dict[str, np.ndarray]:
        """Delta-merged Boolean kNN batch through the current generation.

        kNN traffic enters the recent-traffic window as zero-area point
        rects, so kNN-driven drift both trips the monitor AND steers the
        rebuild's training workload toward the traffic that tripped it."""
        gen = self._gen
        if gen.partitioned is not None:
            out = serve_knn_index_sharded(
                gen.partitioned, points, q_bm, k, mesh=self.index_mesh,
                plan_cache=gen.plan_cache, delta=gen.delta(),
            )
        else:
            out = serve_knn_batch(
                gen.snapshot, points, q_bm, k, plan_cache=gen.plan_cache, delta=gen.delta(),
            )
        pts = np.asarray(points, np.float32).reshape(-1, 2)
        self._record(np.concatenate([pts, pts], axis=1), q_bm)
        self.monitor.observe_counters(out["nodes_checked"], out["verified"])
        return out

    # ------------------------------------------------------------- updates
    def insert(self, locs, kw_ids) -> np.ndarray:
        """Buffer new objects into the current generation's delta log;
        visible to the very next query. Returns the assigned global ids.

        In the same step, the arrivals are matched on the device against the
        compiled subscription block (DESIGN.md §8): any standing filter they
        satisfy queues an (object_id, subscription_id) notification for
        ``drain_notifications()``."""
        if self.result_cache is not None:
            self.result_cache.invalidate()
        ids = self._gen.delta_log.insert(locs, kw_ids)
        self.subscriptions.match_arrivals(ids, locs, kw_ids=kw_ids)
        return ids

    def delete(self, ids) -> int:
        """Mask objects out of serving immediately; returns #newly deleted.

        Deletion never retracts a queued notification -- the object *did*
        arrive while the matching subscriptions were live (§8 contract)."""
        if self.result_cache is not None:
            self.result_cache.invalidate()
        return self._gen.delta_log.delete(ids)

    # -------------------------------------------- continuous filters (§8)
    def subscribe(self, rect, kw_ids) -> int:
        """Register a standing spatio-textual filter (geofence); returns its
        subscription id. Matches objects inserted from now on: each
        ``insert`` batch is matched on the device against the compiled
        subscription block in the same step it enters the delta log."""
        return self.subscriptions.subscribe(rect, kw_ids)

    def unsubscribe(self, sub_id: int) -> bool:
        """Retire a standing filter; already-queued notifications survive."""
        return self.subscriptions.unsubscribe(sub_id)

    def drain_notifications(self) -> np.ndarray:
        """All queued (object_id, subscription_id) notifications, exactly
        once -- across buffer growth, freed-slot reuse, deletes, and
        rebuild swaps (the subscription state lives on the front door, and
        the exactly-once mark rides the monotonic global id space, which a
        swap continues rather than restarts)."""
        return self.subscriptions.drain()

    # ------------------------------------------------------------- rebuild
    def observed_workload(self):
        """The recent-traffic window as a trainable ``Workload``."""
        return observed_workload(
            np.asarray(self._recent_rects, np.float32),
            np.asarray(self._recent_bms, np.uint32),
            self._gen.dataset.vocab_size,
        )

    def maybe_rebuild(self, force: bool = False, min_observed: int = 16) -> bool:
        """Warm-start rebuild + atomic swap when the drift monitor tripped
        (or ``force``). Returns True when a swap happened.

        The rebuild runs on the *merged* dataset (base + buffered inserts,
        deletes tombstoned) and the recently observed workload; the old
        generation keeps serving until the single reference store at the
        end -- the atomicity contract held by tests/test_torch_live.py.

        In the index-parallel regime every rank must reach the same
        decision (raises otherwise); rank 0 rebuilds and broadcasts the
        artifacts, and each rank partitions the new snapshot and places its
        own slab.
        """
        go = bool(force or self.monitor.triggered) and len(self._recent_rects) >= min_observed
        if self.sharded:
            self.index_mesh.agree(int(go), "maybe_rebuild's decision")
        if not go:
            return False
        gen = self._gen
        merged = gen.delta_log.merged_dataset()
        artifacts = self._built_once(lambda: warm_start_rebuild(
            merged, self.observed_workload(), gen.artifacts, self.build_config,
            assign=gen.delta_log.merged_assignment(), device=self.device,
        ))
        new_gen = self._make_generation(artifacts, merged, seq=gen.seq + 1)
        self._gen = new_gen  # THE swap: one reference store
        if self.result_cache is not None:
            self.result_cache.invalidate()  # cached rows belong to the old gen
        self.monitor.rearm()  # back to warmup: re-learn the baseline
        self.swaps += 1
        return True


# the flat fallback (launch/flat_legacy.py), re-exported as the reference does
from .flat_legacy import (  # noqa: E402,F401
    OBJ_PER_LEAF as OBJ_PER_LEAF,
    TOP_LEAVES_LOCAL as TOP_LEAVES_LOCAL,
    wisk_serve_step,
)
