"""Continuous spatio-textual filters on the PyTorch/CUDA port's serving front door
(DESIGN.md §8): geofence alerts over a live object stream.

WISK answers request/response SKR queries; this walkthrough runs the
inverse, FAST-style problem on the same ``LiveIndex``: *standing*
subscriptions (rect + keyword filter) compiled into a device-resident
subscription block, matched against every insert batch in the same step
it enters the delta log.

Walkthrough:

1. Build a WISK index and stand up a ``LiveIndex``.
2. Register geofence subscriptions (``subscribe``): each is a rect plus a
   keyword set under the Boolean SKR contract -- an arriving object
   notifies a geofence when its point lies inside the rect AND it shares
   at least one keyword.
3. Stream object inserts: notifications are queued on device at insert
   time; ``drain_notifications()`` hands out (object_id, subscription_id)
   pairs exactly once.
4. Churn the filter set (``unsubscribe`` frees a slot for reuse), delete
   objects (queued notifications are never retracted), and force a
   warm-start rebuild mid-stream: the subscription state lives on the
   front door, so queued notifications and the exactly-once mark survive
   the generation swap untouched.

The same sizes, seeds and printed facts as ``examples/geofence_alerts.py``
(the JAX package's walkthrough); the build, the snapshots, the
subscription block and the match run on ``--device`` (``cuda`` by default;
``cpu`` runs the kernels' plain PyTorch versions).

    PYTHONPATH=src python examples/torch_geofence_alerts.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.build import BuildConfig
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
    print(f"building WISK on {ds.n} objects ...")
    live = LiveIndex(ds, train, cfg, device=device)

    # 2) standing geofences: rects around dataset hot spots, keyword
    # filters drawn from the head of the vocabulary
    rng = np.random.default_rng(7)
    n_subs = 24
    for _ in range(n_subs):
        c = ds.locs[rng.integers(ds.n)]
        w, h = rng.uniform(0.05, 0.2, size=2)
        rect = [c[0] - w, c[1] - h, c[0] + w, c[1] + h]
        kw = rng.choice(8, size=rng.integers(1, 4), replace=False)
        live.subscribe(rect, kw)
    print(f"registered {n_subs} geofence subscriptions "
          f"({live.subscriptions.n_slots} block slots)")

    # 3) object stream: every insert batch is matched on device in-step
    for _ in range(4):
        src = rng.choice(ds.n, 25)
        locs = np.clip(
            ds.locs[src] + rng.normal(0, 0.02, (25, 2)).astype(np.float32), 0, 1
        )
        live.insert(locs, ds.kw_ids[src])
    alerts = live.drain_notifications()
    print(f"streamed 100 objects -> {alerts.shape[0]} alerts queued, e.g. "
          f"{[(int(o), int(s)) for o, s in alerts[:3]]} (object_id, subscription_id)")

    # 4) churn + rebuild mid-stream: exactly-once survives all of it
    for sid in range(4):
        live.unsubscribe(sid)  # freed slots are reused by later subscribes
    src = rng.choice(ds.n, 25)
    ids = live.insert(ds.locs[src], ds.kw_ids[src])
    live.delete(ids[:10])  # deletion never retracts a queued notification
    for seed in (21, 22):  # recent traffic steers the forced rebuild
        wl = make_workload(ds, m=24, dist="LAP", seed=seed)
        live.serve(wl.rects, wl.kw_bitmap, max_leaves=64)
    queued_before = live.subscriptions.n_pending
    assert live.maybe_rebuild(force=True)
    src = rng.choice(ds.n, 25)
    live.insert(ds.locs[src], ds.kw_ids[src])  # stream continues post-swap
    alerts = live.drain_notifications()
    assert live.drain_notifications().shape[0] == 0  # exactly once
    print(f"rebuild swapped mid-stream (generation {live.generation.seq}); "
          f"{queued_before} queued alerts survived the swap, "
          f"{alerts.shape[0]} drained after it, second drain empty")
    print(f"stream totals: matched={live.subscriptions.matched_total} "
          f"emitted={live.subscriptions.emitted_total}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
