"""How many leaves each served SKR query needs, for a configuration's
``serve.max_leaves``.

    python3 wiskbench/tools/max_leaves.py --config osm1m-str --traffic skr-mix \
        --seeds 0-11 [--device cpu|cuda]

builds the configuration's index (``indexes/<kind>.py``; ``build_wisk``
wants ``--device cuda``), makes each seed's pool (and, where the configuration's ``data.seed`` is
``"run"``, its objects and index) as a run does, and counts
for every query the leaves that survive the descent: those whose MBR meets
the query's rectangle and whose keyword bitmap shares a keyword with it
(an ancestor's MBR and bitmap cover its leaves', so a surviving leaf's
ancestors survive too). A query overflows ``max_leaves`` when it needs
more. Prints, per seed, the largest need and the overflowing queries at
each power of two from 32, then the rule's answer: the smallest power of
two of at least 32 at which no query of these pools overflows.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def leaf_keyword_table(bitmaps: np.ndarray) -> np.ndarray:
    """(vocab, n_leaf) bool: does leaf j hold keyword v."""
    bits = np.unpackbits(np.ascontiguousarray(bitmaps, np.uint32).view(np.uint8), axis=1,
                         bitorder="little")
    return np.ascontiguousarray(bits.astype(bool).T)


def leaves_needed(mbrs: np.ndarray, table: np.ndarray, rects: np.ndarray, kw_ids: np.ndarray,
                  chunk: int = 512) -> np.ndarray:
    """(m,) surviving leaves per query."""
    out = np.zeros(len(rects), np.int64)
    for s in range(0, len(rects), chunk):
        r = rects[s : s + chunk]
        inter = ((mbrs[None, :, 0] <= r[:, None, 2]) & (r[:, None, 0] <= mbrs[None, :, 2])
                 & (mbrs[None, :, 1] <= r[:, None, 3]) & (r[:, None, 1] <= mbrs[None, :, 3]))
        kw = kw_ids[s : s + chunk]
        has = np.zeros_like(inter)
        for j in range(kw.shape[1]):
            col = kw[:, j]
            live = col >= 0
            has[live] |= table[col[live]]
        out[s : s + chunk] = (inter & has).sum(axis=1)
    return out


def seeds_arg(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def build(config: dict, seed: int, device: str):
    """The objects of a run of ``seed`` and the configuration's index over them."""
    from wiskbench import harness

    data = harness.make_objects(config, seed)
    index = harness.load_module("indexes", config["index"]["kind"]).build(
        harness.to_port_dataset(data), data, config["index"], device)
    return data, index


def main() -> None:
    from wiskbench import harness
    from wiskbench.gen.pool import make_pool

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", default="skr-mix")
    p.add_argument("--seeds", type=seeds_arg, default=seeds_arg("0-11"))
    p.add_argument("--device", default="cpu")
    a = p.parse_args()
    config = harness.load_json(harness.BENCH / "configs" / f"{a.config}.json")
    traffic = harness.load_json(harness.BENCH / "traffic" / f"{a.traffic}.json")
    per_run = config["data"]["seed"] == "run"  # the objects too come from each run's seed
    worst, built = 0, None
    for seed in a.seeds:
        if built is None or per_run:
            t = time.perf_counter()
            data, index = built = build(config, seed, a.device)
            leaves = index.levels[-1]
            largest = int(np.diff(index.clusters.offsets).max())
            print(json.dumps({"data_seed": harness.data_seed(config, seed),
                              "index_s": round(time.perf_counter() - t, 3),
                              "levels": [l.n for l in index.levels], "largest_leaf": largest,
                              "obj_bucket": 1 << max(largest - 1, 0).bit_length()}), flush=True)
            table = leaf_keyword_table(leaves.bitmaps)
        need = np.concatenate([leaves_needed(leaves.mbrs, table, q.rects, q.kw_ids)
                               for q in make_pool(traffic, data, seed)])
        worst = max(worst, int(need.max()))
        over = {str(1 << e): int((need > (1 << e)).sum()) for e in range(5, 12)}
        print(json.dumps({"seed": seed, "queries": int(need.size), "max_leaves_needed": int(need.max()),
                          "p99": float(np.percentile(need, 99)), "overflowing": over}), flush=True)
    rule = 32
    while rule < worst:
        rule *= 2
    print(json.dumps({"config": a.config, "seeds": a.seeds, "largest_need": worst,
                      "max_leaves": rule}), flush=True)


if __name__ == "__main__":
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + sys.path[1:]
    main()
