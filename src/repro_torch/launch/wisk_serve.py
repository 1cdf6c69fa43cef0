"""Single-device serving front door for the port.

``serve_batch`` pads a batch to its power-of-two bucket, runs the SKR
engine (serve/engine.py; the frontier descent, or with ``mode="dense"`` the
dense A/B scan) on the snapshot's device and slices the pads off;
``serve_knn_batch`` does the same for Boolean kNN; both take an optional
live ``DeltaBuffer`` (serve/delta.py);
``HotQueryCache`` / ``serve_batch_cached`` serve repeated probes from an
LRU cache; ``MicroBatcher`` coalesces singleton queries into one dispatch.
Host-side orchestration only, with the behaviour of the JAX package's
``launch/wisk_serve.py`` single-device front door. The multi-device
regimes are ROADMAP A.10; ``ServingGeneration``/``LiveIndex`` (rebuild
swaps that feed standing subscriptions, serve/subscribe.py) wait for the
construction port (A.9, A.11).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from ..serve.delta import DeltaBuffer
from ..serve.engine import IndexSnapshot, retrieve, retrieve_knn
from ..serve.plan import PlanCache, pad_knn_queries_to_bucket, pad_queries_to_bucket

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
