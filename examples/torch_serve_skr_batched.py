"""Batched SKR serving on the PyTorch/CUDA port, validated against the
serial reference -- ``examples/serve_skr_batched.py`` (the JAX package's)
on the port.

It builds WISK over the ``fs`` profile (4,000 objects by default) with the
same workloads, seeds and build settings, freezes it into an
``IndexSnapshot`` on ``--device`` (``cuda`` by default: the frontier and
fused-verify CUDA kernels; ``cpu`` runs their plain versions), serves 64
MIX queries through ``retrieve_workload`` and asserts that every query's
ids equal ``execute_serial`` over the same build.

    PYTHONPATH=src python examples/torch_serve_skr_batched.py [--device cpu] [--n 4000]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.build import BuildConfig, build_wisk
from repro_torch.core.partition import PartitionConfig
from repro_torch.core.query import execute_serial
from repro_torch.data.synth import make_dataset
from repro_torch.data.workloads import make_workload
from repro_torch.serve.engine import IndexSnapshot, retrieve_workload


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device="cuda", n=4000):
    ds = make_dataset("fs", n=n, seed=0)
    train = make_workload(ds, m=64, dist="MIX", seed=1)
    art = build_wisk(ds, train, BuildConfig(partition=PartitionConfig(max_clusters=32, n_steps=50)),
                     device=device)
    snap = IndexSnapshot.build(art.index, ds, device=device)

    test = make_workload(ds, m=64, dist="MIX", seed=3)
    max_leaves = art.partition.clusters.k
    out = retrieve_workload(snap, test, max_leaves=max_leaves)
    st = execute_serial(art.index, ds, test)
    agree = all(
        np.array_equal(np.sort(row[row >= 0]), np.sort(ref))
        for row, ref in zip(out["ids"], st.results)
    )
    assert agree, "batched ids differ from execute_serial"
    t0 = time.perf_counter()
    for _ in range(3):
        retrieve_workload(snap, test, max_leaves=max_leaves)
    _sync(device)
    dt = (time.perf_counter() - t0) / 3
    widths = ",".join(str(w) for w in out["frontier_widths"])
    print(f"batched pipeline on {device}: {test.m} queries in {dt*1e3:.1f} ms "
          f"({dt/test.m*1e6:.0f} us/query), exact={agree}, "
          f"verified/query={out['verified'].mean():.1f}, "
          f"frontier widths=[{widths}], "
          f"nodes checked/scanned per query="
          f"{out['nodes_checked'].mean():.1f}/{out['nodes_scanned'].mean():.1f}")
    return out, st


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=4000, help="objects in the dataset")
    args = ap.parse_args()
    main(args.device, args.n)
