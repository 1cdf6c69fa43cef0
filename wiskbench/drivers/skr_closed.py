"""Closed-loop SKR batches through the port's front door.

One client: each batch of the pool goes to
``repro_torch.launch.wisk_serve.serve_batch(snap, rects, bitmaps,
max_leaves)`` and the next one follows once its result dict is on the
host. Nothing caches results; a ``PlanCache`` of the driver's own carries
the frontier widths the warm-up learned.

What the check compares, after the window and with the program's state
freed, against the brute-force reference (``reference/skr.py``):

* ``wrong_counts``: answers, over every query of every batch in the
  window, whose ``counts`` differ from the reference's (a query that
  overflowed ``max_leaves`` may only fall short);
* ``wrong_ids``: of a sample drawn from the seed (``check_per_batch``
  queries a batch), answers whose ids are not the reference's (an
  overflowed one: not a subset of them);
* ``unanswered``: queries of batches whose result has the wrong shape.

All three are exact: the limit is 0. An overflowed query is an incomplete
answer, so it counts in ``failed``.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from wiskbench.gen.pool import make_pool, sub_seed
from wiskbench.reference.control import SkrControl
from wiskbench.reference.skr import SkrReference

LIMITS = {"wrong_counts": 0, "wrong_ids": 0, "unanswered": 0}


class Driver:
    def __init__(self, traffic: dict, config: dict, data, seed: int) -> None:
        self.data = data
        self.pool = make_pool(traffic, data, seed)
        self.n_batches = len(self.pool)
        self.max_leaves = int(config["serve"]["max_leaves"])
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

        q = self.pool[b]
        return wisk_serve.serve_batch(self.snap, q.rects, q.kw_bitmap, self.max_leaves,
                                      plan_cache=self.cache)

    def control(self, precision: str):
        """``serve``'s stand-in: the reference at ``precision``."""
        ctl = SkrControl(self.data.locs, self.data.kw_ids, precision)
        return lambda b: ctl.serve(self.pool[b].rects, self.pool[b].kw_ids)

    def record(self, b: int, out) -> None:
        M = self.pool[b].m
        s = self.sums
        s["batches"] += 1
        s["queries"] += M
        ids, counts, over = out.get("ids"), out.get("counts"), out.get("overflow")
        if (ids is None or counts is None or over is None or np.shape(counts) != (M,)
                or np.shape(over) != (M,) or np.ndim(ids) != 2 or np.shape(ids)[0] != M):
            s["unanswered"] += M
            self.records.append((b, None, None, {}))
            return
        over = np.asarray(over) != 0
        counts = np.asarray(counts, np.int64)
        picks = self.rng.choice(M, size=min(self.per_batch, M), replace=False)
        sample = {int(q): np.sort(ids[q][ids[q] >= 0]) for q in picks}
        self.records.append((b, counts, over, sample))
        s["overflow"] += int(over.sum())
        s["results"] += int(counts.sum())
        s["nodes_checked"] += int(np.asarray(out["nodes_checked"], np.int64).sum())
        s["verified"] += int(np.asarray(out["verified"], np.int64).sum())

    def check(self) -> dict:
        ref = SkrReference(self.data.locs, self.data.kw_ids)
        wrong_counts = wrong_ids = 0
        by_batch = defaultdict(list)
        for rec in self.records:
            by_batch[rec[0]].append(rec)
        for b, recs in sorted(by_batch.items()):
            q = self.pool[b]
            answers = ref.answers(q.rects, q.kw_ids)
            want = np.array([a.size for a in answers], np.int64)
            for _, counts, over, sample in recs:
                if counts is None:
                    continue
                wrong_counts += int(((counts != want) & ~over).sum() + ((counts > want) & over).sum())
                for qi, got in sample.items():
                    if over[qi]:
                        ok = got.size <= want[qi] and bool(np.isin(got, answers[qi]).all())
                    else:
                        ok = np.array_equal(got, answers[qi])
                    wrong_ids += not ok
        values = {"wrong_counts": wrong_counts, "wrong_ids": wrong_ids,
                  "unanswered": int(self.sums["unanswered"])}
        checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
        return {
            "correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": int(self.sums["queries"]),
            "failed": int(self.sums["overflow"] + self.sums["unanswered"]),
            "checks": checks,
        }
