#!/usr/bin/env python3
"""Batch latencies of the PyTorch/CUDA port's serving paths, for comparing two
trees on one GPU.

Run it once per tree, in turns on one card (tree A, tree B, tree B,
tree A), pointing ``--src`` at each tree's ``src`` directory:

    python3 tools/serve_ab.py --src /path/to/parent/src --label parent
    python3 tools/serve_ab.py --label change

It builds the ``osm`` synthetic profile at 1,000,000 objects (STR R-tree,
leaf 128, fanout 8) and the 4096-query MIX workload in 4 batches of 1024 --
the configuration of ``chip_smoke.py`` -- warms every path up once, then
times each batch (host clock after ``torch.cuda.synchronize``) of:

* SKR ``serve_batch`` (the narrow descent, the compact fused verify's
  (M, T) launch) and ``retrieve(fused_variant="vmem")`` (its query-tile
  launch);
* SKR ``retrieve(compact=False, fused_variant="vmem")`` (the full-width
  fused verify's query-tile launch);
* SKR ``retrieve(compact=False)`` (``variant="auto"``: the full-width
  fused verify's (M, T) launch);
* SKR ``retrieve(quantized=False)`` (the f32 descent);
* SKR ``serve_batch(delta=...)`` and kNN ``serve_knn_batch(delta=...)``
  over a ``DeltaLog`` of 10,000 inserts with their own keywords and 5,000
  deletes (the f32 descents on the widened level arrays);
* SKR ``serve_batch(delta=...)`` over a second ``DeltaLog`` whose 10,000
  inserts carry terms of the leaf they route to, so its insert slots stay
  on the compact words (``skr_delta_compact``);
* kNN ``serve_knn_batch`` at k = 10 (the narrow descent);
* kNN ``retrieve_knn(quantized=False)`` (the f32 descent).

It uses only entry points every tree of the port since its kNN and delta
slices has, checks nothing (``chip_smoke.py`` does), and prints the card
(``nvidia-smi`` name and power limit) and one JSON line of batch seconds.
It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_OBJECTS = 1_000_000
N_QUERIES = 4096
BATCH = 1024
K = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the src directory of the tree to time")
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
    from repro_torch.serve.delta import DeltaLog
    from repro_torch.serve.engine import retrieve, retrieve_knn
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot

    import repro_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; tree {args.label}: {Path(repro_torch.__file__).parent}", flush=True)
    ds = make_dataset("osm", n=N_OBJECTS, seed=0)
    index = build_str_rtree(ds, leaf_size=128, fanout=8)
    snap = IndexSnapshot.build(index, ds, device=torch.device("cuda:0"))
    wl = make_workload(ds, m=N_QUERIES, dist="MIX", seed=1)
    points = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                       (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
    bms = wl.kw_bitmap
    batches = [np.arange(i, i + BATCH) for i in range(0, N_QUERIES, BATCH)]
    rng = np.random.default_rng(22)
    dlog = DeltaLog(index, ds, snap)
    new_ids = []
    for _ in range(10):
        locs, kw = make_update_stream(ds, 1000, rng, 0.05)
        new_ids.append(dlog.insert(locs, kw))
    dlog.delete(np.concatenate([rng.choice(ds.n, 4900, replace=False),
                                rng.choice(np.concatenate(new_ids), 100, replace=False)]))
    buf = dlog.buffer
    clog = DeltaLog(index, ds, snap)  # inserts on their leaf's terms: compact insert slots
    vocab = (index.levels[-1].mbrs, snap.leaf_terms.cpu().numpy())
    for _ in range(10):
        clog.insert(*make_update_stream(ds, 1000, rng, 1e-3, *vocab))
    cbuf = clog.buffer

    paths = {
        "skr": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32, plan_cache=c),
        "skr_vmem": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                          fused_variant="vmem"),
        "skr_full_width_vmem": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                                     compact=False, fused_variant="vmem"),
        "skr_full_width": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                                compact=False),
        "skr_f32": lambda b, c: retrieve(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                         quantized=False),
        "skr_delta": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32, plan_cache=c,
                                              delta=buf),
        "skr_delta_compact": lambda b, c: serve_batch(snap, wl.rects[b], bms[b], 32,
                                                      plan_cache=c, delta=cbuf),
        "knn": lambda b, c: serve_knn_batch(snap, points[b], bms[b], K, plan_cache=c),
        "knn_f32": lambda b, c: retrieve_knn(snap, points[b], bms[b], K, plan_cache=c,
                                             quantized=False),
        "knn_delta": lambda b, c: serve_knn_batch(snap, points[b], bms[b], K, plan_cache=c,
                                                  delta=buf),
    }
    times = {}
    for name, serve in paths.items():
        warm = PlanCache()
        for b in batches:  # warm-up: builds, learns the widths
            serve(b, warm)
        torch.cuda.synchronize()
        cache = PlanCache()
        cache.widths = dict(warm.widths)
        times[name] = []
        for b in batches:
            t = time.perf_counter()
            serve(b, cache)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
        print(f"{args.label} {name}: batch s {times[name]}", flush=True)
    print(json.dumps({"label": args.label, "card": card, "batch_s": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
