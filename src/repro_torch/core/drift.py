"""Workload-drift detection for incremental index maintenance (DESIGN.md §7).

WISK's layout is learned *for a workload* (paper §7.5): when the query
distribution shifts, the trained partition stops matching where queries
actually land and the observed Eq.1 cost regresses. This module is the
serving-side monitor that notices:

* ``DriftMonitor`` tracks an EWMA of the observed per-query Eq.1 cost
  (``w1 * nodes_checked + w2 * verified`` -- exactly the counters every
  serving path already returns) against a baseline, and trips once the
  ratio crosses a threshold. The baseline is learned from the warmup
  window of *observed* traffic by default (a trained-workload prediction
  such as ``index_cost_baseline`` systematically undershoots steady state
  -- training queries are what the layout was optimized for -- so
  comparing against it would trip on the generalization gap alone). State
  machine::

      warmup --(min_queries observed; baseline = their mean)--> armed
      --(ewma > threshold * baseline)--> triggered --rearm()--> warmup

  ``triggered`` is sticky: it stays set until ``rearm()`` so the rebuild
  loop can act on its own schedule; ``rearm()`` re-enters warmup, which doubles as the post-swap
  cooldown. Same-distribution noise does not trip the monitor: the EWMA of
  a resampled workload stays near the warmup baseline.

* ``leaf_cost_profile`` / ``regressed_leaves`` localize the damage: the
  per-leaf share of the workload's Eq.1 verification cost, compared between
  the trained and the observed workload. Only leaves whose share regressed
  are re-split by the warm-start rebuild
  (``core.build.warm_start_rebuild``); everything else keeps its learned partition.

Everything here is host-only numpy -- drift tracking is serving control
plane, not descent work. A copy of the JAX package's ``core/drift.py``; the
port keeps its own so it never imports that package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .cost import DEFAULT_W1, DEFAULT_W2, object_query_match
from .query import execute_level_sync
from .types import ClusterSet, GeoTextDataset, Workload, WiskIndex, ids_to_bitmap, rects_intersect


@dataclasses.dataclass
class DriftConfig:
    """Knobs of the drift state machine.

    alpha:       EWMA smoothing per observed query (higher = faster react).
    threshold:   trigger when ``ewma > threshold * baseline``.
    min_queries: warmup window: queries observed before arming; when the
                 baseline is learned, it is their mean cost.
    w1/w2:       Eq.1 weights (must match the serving cost accounting).
    """

    alpha: float = 0.05
    threshold: float = 1.5
    min_queries: int = 32
    w1: float = DEFAULT_W1
    w2: float = DEFAULT_W2


class DriftMonitor:
    """EWMA drift tracker over per-query Eq.1 costs (host-only).

    Args:
        baseline: expected per-query Eq.1 cost, or None (default) to learn
            it as the mean cost of the warmup window -- the robust choice,
            see the module docstring.
        config: ``DriftConfig`` (None = defaults).

    Feed it with ``observe(costs)`` (per-query cost array) or
    ``observe_counters(nodes_checked, verified)`` (raw serving counters).
    Read ``state`` / ``ratio`` / ``triggered``; call ``rearm()`` after a
    rebuild swap.
    """

    def __init__(
        self, baseline: Optional[float] = None, config: Optional[DriftConfig] = None
    ) -> None:
        self.config = config or DriftConfig()
        self.baseline: Optional[float] = None if baseline is None else float(baseline)
        self.ewma: float = 0.0 if baseline is None else float(baseline)
        self.n_observed = 0
        self.state = "warmup" if baseline is None else "armed"
        self._warm_costs: List[float] = []
        self.history: List[float] = []  # EWMA after each observe() batch

    @property
    def ratio(self) -> float:
        """Observed EWMA cost relative to the baseline (0 during warmup)."""
        if self.baseline is None:
            return 0.0
        return self.ewma / max(self.baseline, 1e-9)

    @property
    def triggered(self) -> bool:
        return self.state == "triggered"

    def observe_counters(self, nodes_checked, verified) -> None:
        """Absorb raw serving counters (the dicts every execution path
        returns carry both)."""
        nodes = np.asarray(nodes_checked, np.float64)
        ver = np.asarray(verified, np.float64)
        self.observe(self.config.w1 * nodes + self.config.w2 * ver)

    def observe(self, costs) -> None:
        """Absorb a batch of per-query Eq.1 costs and advance the state
        machine. Pad queries must be sliced off by the caller (the front
        doors already do)."""
        costs = np.atleast_1d(np.asarray(costs, np.float64))
        if costs.size == 0:
            return
        self.n_observed += costs.size
        if self.state == "warmup":
            self._warm_costs.extend(float(c) for c in costs)
            if len(self._warm_costs) >= self.config.min_queries:
                if self.baseline is None:
                    self.baseline = float(np.mean(self._warm_costs))
                self.ewma = self.baseline
                self._warm_costs = []
                self.state = "armed"
            self.history.append(self.ewma)
            return
        a = self.config.alpha
        for c in costs:
            self.ewma = (1.0 - a) * self.ewma + a * float(c)
        self.history.append(self.ewma)
        if self.state == "armed" and self.ewma > self.config.threshold * self.baseline:
            self.state = "triggered"

    def rearm(self, baseline: Optional[float] = None) -> None:
        """Reset after a rebuild swap: back to warmup (which doubles as the
        cooldown -- nothing can trigger until a fresh baseline window is
        observed on the new index). Pass ``baseline`` to pin it instead of
        re-learning it from the warmup window."""
        self.baseline = None if baseline is None else float(baseline)
        self.ewma = 0.0 if baseline is None else float(baseline)
        self._warm_costs = []
        self.state = "warmup" if baseline is None else "armed"


def index_cost_baseline(
    index: WiskIndex,
    dataset: GeoTextDataset,
    workload: Workload,
    w1: float = DEFAULT_W1,
    w2: float = DEFAULT_W2,
) -> float:
    """Mean per-query Eq.1 cost of ``workload`` on ``index`` -- the trained
    baseline a ``DriftMonitor`` compares serving traffic against. Uses the
    vectorized host traversal (its counters equal the device engine's)."""
    st = execute_level_sync(index, dataset, workload, w1=w1, w2=w2)
    return float(st.cost.mean())


def leaf_cost_profile(
    dataset: GeoTextDataset,
    clusters: ClusterSet,
    workload: Workload,
    w2: float = DEFAULT_W2,
) -> np.ndarray:
    """(K,) mean per-query Eq.1 *verification* cost attributed to each leaf.

    For leaf ``c``: ``w2 / m * sum_{q relevant to c} |O_c(q)|`` with
    ``|O_c(q)|`` the keyword-matching members (the paper's verification
    term, cluster-local). This is the per-leaf decomposition of
    ``cost.exact_workload_cost``'s w2 term; comparing profiles between the
    trained and observed workloads localizes a drift to the leaves that
    actually regressed."""
    m, k = workload.m, clusters.k
    if m == 0:
        return np.zeros(k, np.float64)
    kw_match = object_query_match(dataset, workload)
    inter = rects_intersect(workload.rects[:, None, :], clusters.mbrs[None, :, :])
    kwc = np.any(
        workload.kw_bitmap[:, None, :] & clusters.bitmaps[None, :, :] != 0, axis=-1
    )
    relevant = inter & kwc  # (m, k)
    prof = np.zeros(k, np.float64)
    assign = clusters.assign
    for qi in range(m):
        counts = np.bincount(assign[kw_match[qi]], minlength=k).astype(np.float64)
        prof += np.where(relevant[qi], counts, 0.0)
    return w2 * prof / m


def regressed_leaves(
    trained_profile: np.ndarray,
    observed_profile: np.ndarray,
    ratio: float = 1.5,
    min_cost: float = 1.0,
) -> np.ndarray:
    """(K,) bool: leaves whose observed verification cost regressed.

    A leaf regresses when its observed per-query cost exceeds ``ratio``
    times its trained cost AND is material (``> min_cost``), so leaves that
    were already expensive under the trained workload (the optimizer chose
    not to split them further) and leaves with negligible traffic are left
    alone. The warm-start rebuild re-splits exactly these leaves."""
    trained = np.asarray(trained_profile, np.float64)
    observed = np.asarray(observed_profile, np.float64)
    return (observed > ratio * trained) & (observed > min_cost)


def observed_workload(rects, kw_bitmaps, vocab_size: int) -> Workload:
    """Reconstruct a trainable ``Workload`` from the (rects, bitmap) form
    the serving front doors receive -- keyword ids are recovered from the
    set bits, so the drift-triggered rebuild can train on exactly the
    traffic that tripped the monitor."""
    rects = np.asarray(rects, np.float32).reshape(-1, 4)
    bms = np.asarray(kw_bitmaps, np.uint32).reshape(rects.shape[0], -1)
    per_q: List[np.ndarray] = []
    for row in bms:
        bits = np.unpackbits(row.view(np.uint8), bitorder="little")
        per_q.append(np.nonzero(bits[:vocab_size])[0].astype(np.int32))
    max_kw = max((p.size for p in per_q), default=1) or 1
    kw_ids = np.full((rects.shape[0], max_kw), -1, np.int32)
    for i, p in enumerate(per_q):
        kw_ids[i, : p.size] = p
    return Workload(rects, kw_ids, ids_to_bitmap(kw_ids, vocab_size), vocab_size)
