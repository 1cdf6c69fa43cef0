#!/usr/bin/env python3
"""The multi-rank serving phase of ``chip_smoke.py`` alone, on the GPU.

    python3 tools/sharded_phase.py

It builds the port's CUDA kernels and what the smoke's phase 15 takes from
the phases before it, with the same sizes and seeds: the ``osm`` synthetic
profile at 1,000,000 objects (seed 0), its STR R-tree (leaf 128, fanout 8)
and snapshot, the 4096-query MIX workload (seed 1) served single-device in
4 batches of 1024 (SKR, and kNN at k = 10) at widths learned on those
batches, log B's delta (10,000 jittered-copy inserts, 5,000 deletes, seed
22) with its single-device SKR and kNN batch, and the 120,000-object twin
build (``BuildConfig()``, MIX training queries of seed 3). Then it runs
``chip_smoke.multi_rank_serving``: the same code and checks as the smoke's
phase. It prints the card's name and power limit first; any failed check
raises and exits non-zero.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.core.build import BuildConfig, build_wisk
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_update_stream, make_workload
    from repro_torch.kernels import _build
    from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
    from repro_torch.serve.delta import DeltaLog
    from repro_torch.serve.plan import PlanCache
    from repro_torch.serve.snapshot import IndexSnapshot

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    cs.log(f"card: {cs.gpu_line()}")
    with cs.phase("kernel build"):
        _build.build_all()
    with cs.phase("data, index, snapshot and single-device batches"):
        ds = make_dataset(cs.PROFILE, n=cs.N_OBJECTS, seed=cs.SEED)
        index = build_str_rtree(ds, leaf_size=cs.LEAF_SIZE, fanout=cs.FANOUT)
        snap = IndexSnapshot.build(index, ds, device=dev)
        wl = make_workload(ds, m=cs.N_QUERIES, dist="MIX", seed=1)
        points, bms = cs.query_points(wl), wl.kw_bitmap
        batches = [np.arange(i, i + cs.BATCH) for i in range(0, cs.N_QUERIES, cs.BATCH)]
        warm, warm_knn = PlanCache(), PlanCache()
        for b in batches:
            serve_batch(snap, wl.rects[b], bms[b], cs.MAX_LEAVES, plan_cache=warm)
            serve_knn_batch(snap, points[b], bms[b], cs.K, plan_cache=warm_knn)

        def cached(w):
            c = PlanCache()
            c.widths = dict(w.widths)
            return c

        c = cached(warm)
        skr_out = [serve_batch(snap, wl.rects[b], bms[b], cs.MAX_LEAVES, plan_cache=c)
                   for b in batches]
        knn_out = [serve_knn_batch(snap, points[batches[0]], bms[batches[0]], cs.K,
                                   plan_cache=cached(warm_knn))]
    with cs.phase("log B's delta"):
        rng = np.random.default_rng(22)
        dlog = DeltaLog(index, ds, snap)
        new_ids = []
        n_batches = cs.N_INSERT // cs.INSERT_BATCH
        for i in range(n_batches):
            locs, kw = make_update_stream(ds, cs.INSERT_BATCH, rng, 0.05)
            if i == n_batches - 1:  # the smoke's order: the deletes before the last insert
                dlog.delete(np.concatenate([
                    rng.choice(ds.n, cs.N_DELETE - cs.N_DELETE_BUFFERED, replace=False),
                    rng.choice(np.concatenate(new_ids), cs.N_DELETE_BUFFERED, replace=False)]))
            new_ids.append(dlog.insert(locs, kw))
        b0 = batches[0]
        delta_skr = serve_batch(snap, wl.rects[b0], bms[b0], cs.MAX_LEAVES,
                                plan_cache=PlanCache(), delta=dlog.buffer)
        delta_knn = serve_knn_batch(snap, points[b0], bms[b0], cs.K, plan_cache=PlanCache(),
                                    delta=dlog.buffer)
    with cs.phase("twin build"):
        small = make_dataset(cs.PROFILE, n=cs.N_TWIN, seed=cs.SEED)
        strain = make_workload(small, m=cs.N_TRAIN, dist="MIX", seed=3)
        t = time.perf_counter()
        art = build_wisk(small, strain, BuildConfig(), device=dev)
        torch.cuda.synchronize()
        cs.log(f"twin build n={small.n}: {time.perf_counter() - t:.3f} s, level widths "
               f"{[lvl.n for lvl in art.index.levels]}")
    with cs.phase("multi-rank serving"):
        cs.multi_rank_serving(dev, wl, points, batches, snap, warm, skr_out, warm_knn, knn_out,
                              dlog.buffer, delta_skr, delta_knn, (small, strain, art))
    cs.log(f"card: {cs.gpu_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
