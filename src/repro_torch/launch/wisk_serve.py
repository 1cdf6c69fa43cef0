"""Single-device serving front door for the port.

``serve_batch`` pads a batch to its power-of-two bucket, runs the SKR
engine (serve/engine.py; the frontier descent, or with ``mode="dense"`` the
dense A/B scan) on the snapshot's device and slices the pads off;
``serve_knn_batch`` does the same for Boolean kNN; both take an optional
live ``DeltaBuffer`` (serve/delta.py);
``HotQueryCache`` / ``serve_batch_cached`` serve repeated probes from an
LRU cache; ``MicroBatcher`` coalesces singleton queries into one dispatch.

On top of them sits the incremental-maintenance front door (DESIGN.md §7):
``LiveIndex`` buffers object inserts and deletes in the current
``ServingGeneration``'s ``DeltaLog``, merged into every descent; matches
every insert batch against the standing subscriptions
(serve/subscribe.py); watches the observed Eq. 1 cost with a
``DriftMonitor`` (core/drift.py); and on a trip warm-start rebuilds on the
recently observed traffic (``core.build.warm_start_rebuild``) and swaps the
fresh generation in with one reference store.

Host-side orchestration only, with the behaviour of the JAX package's
``launch/wisk_serve.py`` single-device front door. The multi-device
regimes (query- and index-parallel serving) are ROADMAP A.10.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..core.build import BuildConfig, build_wisk, warm_start_rebuild
from ..core.drift import DriftMonitor, observed_workload
from ..serve.delta import DeltaBuffer, DeltaLog
from ..serve.engine import IndexSnapshot, retrieve, retrieve_knn
from ..serve.plan import PlanCache, pad_knn_queries_to_bucket, pad_queries_to_bucket
from ..serve.subscribe import SubscriptionIndex

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

    The reference's index-parallel regime (``index_shards``/``index_mesh``,
    a partitioned snapshot per generation) is not ported yet (ROADMAP A.10),
    so there are no such arguments.
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
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.build_config = build_config or BuildConfig()
        self._slots_per_leaf = slots_per_leaf
        # hot-query result cache (§3.5): exact results keyed on the current
        # served state, so every state change below must invalidate it
        self.result_cache = result_cache
        if artifacts is None:
            artifacts = build_wisk(dataset, workload, self.build_config, device=self.device)
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

    def _make_generation(self, artifacts, dataset, seq: int) -> ServingGeneration:
        snapshot = IndexSnapshot.build(artifacts.index, dataset, device=self.device)
        return ServingGeneration(
            artifacts=artifacts,
            dataset=dataset,
            snapshot=snapshot,
            delta_log=DeltaLog(artifacts.index, dataset, snapshot, self._slots_per_leaf),
            plan_cache=PlanCache(),
            seq=seq,
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
        should follow."""
        gen = self._gen
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
        """
        if not (force or self.monitor.triggered):
            return False
        if len(self._recent_rects) < min_observed:
            return False
        gen = self._gen
        merged = gen.delta_log.merged_dataset()
        artifacts = warm_start_rebuild(
            merged, self.observed_workload(), gen.artifacts, self.build_config,
            assign=gen.delta_log.merged_assignment(), device=self.device,
        )
        new_gen = self._make_generation(artifacts, merged, seq=gen.seq + 1)
        self._gen = new_gen  # THE swap: one reference store
        if self.result_cache is not None:
            self.result_cache.invalidate()  # cached rows belong to the old gen
        self.monitor.rearm()  # back to warmup: re-learn the baseline
        self.swaps += 1
        return True
