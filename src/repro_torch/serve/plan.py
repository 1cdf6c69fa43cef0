"""Plan layer: batch bucketing/padding and the frontier width discipline.

Serving an ``IndexSnapshot`` needs two kinds of planning state that are not
index data:

* **Batch bucketing.** Incoming query batches are padded to power-of-two
  buckets (optionally per query shard) with inert pad queries
  (``pad_queries_to_bucket``, and ``pad_knn_queries_to_bucket`` for kNN
  points), so the set of batch shapes stays logarithmic in the largest
  batch.
* **Execution plans.** Each frontier descent runs at per-level expansion
  widths. ``PlanCache`` owns the monotone per-(path, level) width cache,
  hands the executor an immutable ``ExecutionPlan`` per descent and absorbs
  the observed per-level child-count maxima afterwards.

Width discipline:

* ``plan.widths is None`` -- *exact* mode: the descent reads each level's
  batch-max child count on the host (one sync per level) and the caller
  grows the cache from those ints. First descent of a path only.
* ``plan.widths = (w0, w1, ...)`` -- *cached* mode: the descent runs at the
  cached widths and keeps the per-level maxima on the device; ONE batched
  device->host fetch checks them all at the end. Overflow (a width was too
  narrow: children were dropped) triggers an exact retry, so the result is
  always lossless. Monotone power-of-two growth bounds the retries at
  log2(level width) per (path, level) for the life of the process.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.query import round_up_bucket, sharded_bucket
from ..kernels.ops import NEVER_RECT

MIN_WIDTH_BUCKET = 8


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """One descent's resolved widths: ``widths=None`` is exact (per-level
    sync) mode, a tuple is the sync-free cached mode."""

    tag: str
    widths: Optional[Tuple[int, ...]]

    def pick_width(self, need: torch.Tensor, li: int, needs: List) -> int:
        """Per-level expansion width: exact mode syncs on the batch max and
        buckets it; cached mode keeps the max on the device for the single
        batched overflow check."""
        if self.widths is None:
            mx = int(need.max())
            needs.append(mx)
            return round_up_bucket(mx)
        needs.append(need.max())
        return self.widths[li]


class PlanCache:
    """Monotone per-(path tag, level) frontier expansion widths.

    ``widths`` is a plain dict keyed ``(tag, level) -> int`` (public: tests
    poison it to exercise the lossless overflow retry).
    """

    def __init__(self) -> None:
        self.widths: Dict[Tuple[str, int], int] = {}

    def plan(self, tag: str, n_links: int) -> ExecutionPlan:
        """Cached-mode plan if every level's width is learned, else exact."""
        ws = [self.widths.get((tag, li)) for li in range(n_links)]
        if any(w is None for w in ws):
            return ExecutionPlan(tag=tag, widths=None)
        return ExecutionPlan(tag=tag, widths=tuple(ws))  # type: ignore[arg-type]

    def seeded_plan(self, tag: str, n_links: int, minimum: int = MIN_WIDTH_BUCKET) -> ExecutionPlan:
        """Always-concrete widths (unlearned levels seeded at ``minimum``):
        the multi-rank descents run at widths every rank shares and converge
        by grow-and-redescend instead of per-level syncs."""
        return ExecutionPlan(
            tag=tag,
            widths=tuple(self.widths.get((tag, li), minimum) for li in range(n_links)),
        )

    def seeded_shard_plan(
        self, tag: str, n_shards: int, n_links: int, minimum: int = MIN_WIDTH_BUCKET,
    ) -> ExecutionPlan:
        """Per-shard width cache for the index-parallel descents: shard ``s``
        learns under the sub-tag ``f"{tag}/s{s}"``, but every shard of one
        descent runs the SAME widths, so the plan's per-level width is the
        max over the shard slots. A hot shard widens the others' frontiers
        (pad slots are inert)."""
        ws = []
        for li in range(n_links):
            ws.append(max(
                self.widths.get((f"{tag}/s{s}", li), minimum) for s in range(n_shards)
            ))
        return ExecutionPlan(tag=tag, widths=tuple(ws))

    def observe_shards(self, tag: str, per_shard_maxima) -> None:
        """Grow the per-shard slots from an (S, n_links) matrix of observed
        child-count maxima (one row per index shard)."""
        per_shard_maxima = np.asarray(per_shard_maxima)
        for s in range(per_shard_maxima.shape[0]):
            self.observe(f"{tag}/s{s}", per_shard_maxima[s])

    def observe(self, tag: str, maxima: Sequence[int]) -> None:
        """Grow each (tag, level) slot to the bucket of its observed maximum;
        slots only ever double."""
        for li, mx in enumerate(maxima):
            w = round_up_bucket(int(mx))
            if w > self.widths.get((tag, li), 0):
                self.widths[(tag, li)] = w

    def check_and_retry(self, plan: ExecutionPlan, needs: Sequence, descend: Callable):
        """The single batched sync of a cached-width descent: fetch all
        levels' observed child-count maxima at once; on overflow re-descend
        in exact mode (``descend(exact_plan)``) and grow the cache either
        way. Returns the retried descent output, or None when the original
        descent stands."""
        if plan.widths is None:
            self.observe(plan.tag, needs)  # exact descent: needs are host ints
            return None
        if needs:
            maxima = torch.stack(list(needs)).cpu().numpy()
            if np.any(maxima > np.asarray(plan.widths)):
                self.observe(plan.tag, maxima)
                out = descend(ExecutionPlan(tag=plan.tag, widths=None))
                self.observe(plan.tag, out[-1])
                return out
        return None


# One PlanCache per live snapshot for callers that pass none, weakly keyed
# so dropping the snapshot drops its learned widths too.
_DEFAULT_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def default_plan_cache(snapshot) -> PlanCache:
    """The per-snapshot fallback ``PlanCache``, created on first use."""
    cache = _DEFAULT_PLANS.get(snapshot)
    if cache is None:
        cache = PlanCache()
        _DEFAULT_PLANS[snapshot] = cache
    return cache


def pad_queries_to_bucket(q_rects, q_bm, minimum: int = 8, shards: int = 1):
    """Pad an incoming query batch to its power-of-two bucket (host-only).

    Args:
        q_rects: (m, 4) f32 query rectangles ``(xlo, ylo, xhi, yhi)``.
        q_bm: (m, W) u32 query keyword bitmaps.
        minimum: smallest bucket size.
        shards: pad to ``shards`` equal power-of-two buckets so the batch
            splits evenly over the query shards of a serving mesh.

    Returns:
        ``(rects, bms, m)``: the padded (bucket, 4)/(bucket, W) arrays plus
        the original batch size for slicing results. Pad queries use
        never-intersecting rects and empty bitmaps, so they survive no
        filter and verify nothing.
    """
    q_rects = np.asarray(q_rects, np.float32)
    q_bm = np.asarray(q_bm, np.uint32)
    m = q_rects.shape[0]
    bucket = sharded_bucket(m, shards, minimum)
    if bucket == m:
        return q_rects, q_bm, m
    pad = bucket - m
    rects = np.concatenate(
        [q_rects, np.tile(np.array([NEVER_RECT], np.float32), (pad, 1))], 0
    )
    bms = np.concatenate([q_bm, np.zeros((pad, q_bm.shape[1]), np.uint32)], 0)
    return rects, bms, m


def pad_knn_queries_to_bucket(points, q_bm, minimum: int = 8, shards: int = 1):
    """kNN twin of ``pad_queries_to_bucket`` (host-only).

    Args:
        points: (m, 2) f32 query points; ``q_bm``: (m, W) u32 bitmaps.
        minimum / shards: as in ``pad_queries_to_bucket``.

    Returns:
        ``(points, bms, m)`` padded to the bucket, plus the original size.

    Pad queries are inert because their all-zero bitmap fails the keyword
    AND, so every frontier slot scores +inf: they verify nothing and return
    all ``-1`` ids. The pad point ``(2.0, 2.0)`` lies outside the unit
    square, which alone would not exclude it.
    """
    points = np.asarray(points, np.float32)
    q_bm = np.asarray(q_bm, np.uint32)
    m = points.shape[0]
    bucket = sharded_bucket(m, shards, minimum)
    if bucket == m:
        return points, q_bm, m
    pad = bucket - m
    pts = np.concatenate([points, np.full((pad, 2), 2.0, np.float32)], 0)
    bms = np.concatenate([q_bm, np.zeros((pad, q_bm.shape[1]), np.uint32)], 0)
    return pts, bms, m
