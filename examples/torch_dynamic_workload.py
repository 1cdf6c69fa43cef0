"""Paper §7.5 scenario on the PyTorch/CUDA port's incremental-maintenance front door
(DESIGN.md §7): the query distribution shifts, the drift monitor notices,
and a warm-start rebuild is atomically swapped in -- while object updates
are absorbed by delta buffers without ever rebuilding.

Walkthrough:

1. Build a WISK index on a LAP (spatially concentrated) training workload
   and stand up a ``LiveIndex`` serving front door.
2. Serve same-distribution traffic: the drift monitor learns its baseline
   during warmup and stays armed.
3. Insert and delete objects mid-serving: they are buffered in the
   ``DeltaBuffer`` and merged into every query on the fly (results include
   fresh inserts immediately; deleted objects vanish immediately).
4. Shift traffic to UNI: the observed Eq.1 cost regresses, the monitor
   trips, and ``maybe_rebuild()`` warm-start rebuilds (re-learning splits
   only for regressed leaves, grafting the DQN-packed hierarchy) and swaps
   the fresh snapshot in atomically -- the generation counter advances,
   buffered updates are baked in, and cost recovers.

The same sizes, seeds and printed facts as ``examples/dynamic_workload.py``
(the JAX package's walkthrough); the build, the snapshots and the serving
run on ``--device`` (``cuda`` by default; ``cpu`` runs the kernels' plain
PyTorch versions).

    PYTHONPATH=src python examples/torch_dynamic_workload.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.build import BuildConfig
from repro_torch.core.drift import DriftConfig
from repro_torch.core.packing import PackingConfig
from repro_torch.core.partition import PartitionConfig
from repro_torch.data.synth import make_dataset
from repro_torch.data.workloads import make_workload
from repro_torch.launch.wisk_serve import LiveIndex


def main(device="cuda"):
    ds = make_dataset("fs", n=1500, seed=0)
    cfg = BuildConfig(
        partition=PartitionConfig(max_clusters=24, n_steps=25, n_restarts=2),
        packing=PackingConfig(epochs=3, max_label_queries=16),
        cdf_train_steps=40,
        cdf_force_class="gauss",
        use_itemsets=False,
    )
    train = make_workload(ds, m=32, dist="LAP", seed=1)
    print(f"building WISK on {ds.n} objects, LAP training workload ...")
    live = LiveIndex(ds, train, cfg, DriftConfig(threshold=1.3, min_queries=48), device=device)
    print(f"  {live.generation.artifacts.partition.clusters.k} bottom clusters, "
          f"{live.generation.artifacts.index.height} levels")

    # 2) same-distribution traffic: baseline learned, monitor stays armed
    for seed in (21, 22, 23):
        wl = make_workload(ds, m=24, dist="LAP", seed=seed)
        out = live.serve(wl.rects, wl.kw_bitmap, max_leaves=64)
    print(f"steady state: monitor={live.monitor.state}, "
          f"baseline cost/query={live.monitor.baseline:.1f}")

    # 3) object updates absorbed by the delta buffers, no rebuild
    rng = np.random.default_rng(5)
    src = rng.choice(ds.n, 30)
    locs = np.clip(ds.locs[src] + rng.normal(0, 0.02, (30, 2)).astype(np.float32), 0, 1)
    new_ids = live.insert(locs, ds.kw_ids[src])
    n_del = live.delete(rng.choice(ds.n, 15, replace=False))
    wl = make_workload(ds, m=24, dist="LAP", seed=24)
    out = live.serve(wl.rects, wl.kw_bitmap, max_leaves=64)
    served = {int(i) for row in out["ids"] for i in row[row >= 0]}
    print(f"buffered {len(new_ids)} inserts + {n_del} deletes; "
          f"delta holds {live.generation.delta_log.n_updates()} updates; "
          f"fresh inserts already served: {bool(served & set(map(int, new_ids)))}")

    # 4) distribution shift -> drift trigger -> warm-start rebuild + swap
    for seed in (31, 32, 33, 34, 35, 36):
        wl = make_workload(ds, m=24, dist="UNI", seed=seed)
        live.serve(wl.rects, wl.kw_bitmap, max_leaves=64)
    print(f"after shift: monitor={live.monitor.state}, "
          f"cost ratio={live.monitor.ratio:.2f}x")
    old_seq = live.generation.seq
    if live.maybe_rebuild():
        art = live.generation.artifacts
        print(f"warm-start rebuild swapped in: generation {old_seq} -> "
              f"{live.generation.seq}, refined "
              f"{art.counters['refined_leaves']} leaves, kept "
              f"{art.counters['kept_clusters']} clusters, "
              f"build {art.timings['total']:.2f}s, "
              f"dataset now {live.generation.dataset.n} objects")
    # post-swap traffic re-learns the baseline on the adapted index
    for seed in (41, 42):
        wl = make_workload(ds, m=24, dist="UNI", seed=seed)
        live.serve(wl.rects, wl.kw_bitmap, max_leaves=64)
    print(f"recovered: monitor={live.monitor.state}, "
          f"baseline cost/query={live.monitor.baseline:.1f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
