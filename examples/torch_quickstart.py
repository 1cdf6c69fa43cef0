"""Quickstart on the PyTorch/CUDA port: build a WISK index on synthetic
geo-textual data and run spatial keyword range queries -- the paper's core
loop, as ``examples/quickstart.py`` (the JAX package's) runs it.

The same dataset (``fs``, 4,000 objects by default), workloads, seeds and
build settings; the build trains on ``--device`` (``cuda`` by default;
``cpu`` runs the plain PyTorch versions). The queries run through the
host's ``execute_serial``, which answers exactly.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--n 4000]
"""
import argparse

import numpy as np

from repro_torch.core.build import BuildConfig, build_wisk
from repro_torch.core.cost import exact_workload_cost
from repro_torch.core.packing import PackingConfig
from repro_torch.core.partition import PartitionConfig
from repro_torch.core.query import execute_serial
from repro_torch.core.types import ClusterSet
from repro_torch.data.synth import make_dataset
from repro_torch.data.workloads import make_workload


def main(device="cuda", n=4000):
    ds = make_dataset("fs", n=n, seed=0)
    train = make_workload(ds, m=64, dist="MIX", seed=1)
    print(f"dataset: {ds.n} objects, vocab {ds.vocab_size}; training workload {train.m} queries")

    cfg = BuildConfig(
        partition=PartitionConfig(max_clusters=48, n_steps=60, n_restarts=3),
        packing=PackingConfig(epochs=6),
        cdf_train_steps=120,
    )
    art = build_wisk(ds, train, cfg, device=device)
    print(f"built WISK on {device}: {art.partition.clusters.k} bottom clusters, "
          f"{art.index.height} levels, {art.index.nbytes()/1e3:.0f} KB, "
          f"timings {dict((k, round(v, 1)) for k, v in art.timings.items())}")

    test = make_workload(ds, m=32, dist="MIX", seed=2)
    st = execute_serial(art.index, ds, test)
    flat = ClusterSet.from_assignment(ds, np.zeros(ds.n, dtype=np.int32))
    c0 = exact_workload_cost(ds, flat, test).total
    print(f"query cost: no-index {c0:.0f} -> WISK {st.total_cost:.0f} "
          f"({c0/st.total_cost:.1f}x less work); results exact.")
    return art, st


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=4000, help="objects in the dataset")
    args = ap.parse_args()
    main(args.device, args.n)
