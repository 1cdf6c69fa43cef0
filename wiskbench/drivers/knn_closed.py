"""Closed-loop Boolean kNN batches through the port's front door.

One client: each batch of the pool goes to
``repro_torch.launch.wisk_serve.serve_knn_batch(snap, points, bitmaps,
k)``, the points being the centres of the generated query rectangles, and
the next one follows once its result dict is on the host. A ``PlanCache``
of the driver's own carries the widths the warm-up learned.

What the check compares, after the window and with the program's state
freed, on a sample drawn from the seed (``check_per_batch`` queries a
batch) against the grid-scan reference (``reference/knn.py``):

* ``wrong_ids``: answers whose ids, in order, are not the reference's
  (ascending squared distance, then id);
* ``wrong_dist2``: answers whose squared distances are not the
  reference's, bit for bit;
* ``unanswered``: queries of batches whose result has the wrong shape.

All three are exact: the limit is 0.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from wiskbench.gen.pool import make_pool, sub_seed
from wiskbench.reference.control import KnnControl
from wiskbench.reference.knn import KnnReference

LIMITS = {"wrong_ids": 0, "wrong_dist2": 0, "unanswered": 0}


def centres(rects: np.ndarray) -> np.ndarray:
    r = np.asarray(rects, np.float32)
    return np.stack([(r[:, 0] + r[:, 2]) * np.float32(0.5),
                     (r[:, 1] + r[:, 3]) * np.float32(0.5)], 1).astype(np.float32)


class Driver:
    def __init__(self, traffic: dict, config: dict, data, seed: int) -> None:
        self.data = data
        self.pool = make_pool(traffic, data, seed)
        self.points = [centres(q.rects) for q in self.pool]
        self.n_batches = len(self.pool)
        self.k = int(traffic["k"])
        self.per_batch = int(traffic["check_per_batch"])
        self.rng = np.random.default_rng(sub_seed(seed, 3))
        self.reset()

    def reset(self) -> None:
        self.records = []
        self.sums = defaultdict(int)

    def start(self, snap) -> None:
        from repro_torch.serve.plan import PlanCache

        self.snap, self.cache = snap, PlanCache()

    def stop(self) -> None:
        self.snap = self.cache = None

    def serve(self, b: int):
        from repro_torch.launch import wisk_serve

        return wisk_serve.serve_knn_batch(self.snap, self.points[b], self.pool[b].kw_bitmap,
                                          self.k, plan_cache=self.cache)

    def control(self, precision: str):
        """``serve``'s stand-in: the reference at ``precision``."""
        ctl = KnnControl(self.data.locs, self.data.kw_ids, precision)
        return lambda b: ctl.serve(self.points[b], self.pool[b].kw_ids, self.k)

    def record(self, b: int, out) -> None:
        M = self.pool[b].m
        s = self.sums
        s["batches"] += 1
        s["queries"] += M
        ids, d2 = out.get("ids"), out.get("dist2")
        if ids is None or d2 is None or np.shape(ids) != (M, self.k) or np.shape(d2) != (M, self.k):
            s["unanswered"] += M
            return
        picks = self.rng.choice(M, size=min(self.per_batch, M), replace=False)
        for q in picks:
            self.records.append((b, int(q), np.array(ids[q]), np.array(d2[q])))
        s["verified"] += int(np.asarray(out["verified"], np.int64).sum())
        s["nodes_checked"] += int(np.asarray(out["nodes_checked"], np.int64).sum())
        s["leaves_verified"] += int(np.asarray(out["leaves_verified"], np.int64).sum())

    def check(self) -> dict:
        ref = KnnReference(self.data.locs, self.data.kw_ids)
        wrong_ids = wrong_d2 = 0
        for b, q, ids, d2 in self.records:
            want_ids, want_d2 = ref.answer(self.points[b][q], self.pool[b].kw_ids[q], self.k)
            n = want_ids.size
            ids_ok = np.array_equal(ids[:n], want_ids) and bool((ids[n:] == -1).all())
            wrong_ids += not ids_ok
            wrong_d2 += not np.array_equal(d2[:n].view(np.int32), want_d2.view(np.int32))
        values = {"wrong_ids": wrong_ids, "wrong_dist2": wrong_d2,
                  "unanswered": int(self.sums["unanswered"])}
        checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
        return {
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": int(self.sums["queries"]),
            "failed": int(self.sums["unanswered"]),
            "checks": checks,
        }
