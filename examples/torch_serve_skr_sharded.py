"""Multi-rank SKR serving walkthrough on the PyTorch/CUDA port.

The port of ``examples/serve_skr_sharded.py``: the same sizes, seeds and
printed facts, with ``torch.distributed`` ranks in place of a JAX device
mesh. Every rank runs this script; each makes the same calls on the same
batch and gets the whole result back.

1. **Snapshot** -- rank 0 builds the index and broadcasts it; every rank
   freezes it with ``IndexSnapshot.build``, and ``.replicate(mesh)`` puts
   the whole snapshot on the rank's device (``serve_sharded`` does this
   too; shown here for the walkthrough).
2. **Plan** -- a ``PlanCache`` carries the monotone frontier widths; the
   ranks converge them by grow-and-redescend, then serve at them.
3. **Executor** -- ``serve_sharded`` splits the query batch over the mesh's
   data axis and runs the frontier descent on each rank's rows: per-query
   ids and Eq. 1 counters, identical to the single-device engine.
   ``serve_index_sharded`` then serves the same batch with the hierarchy
   itself cut into one shard per rank (``PartitionedSnapshot``).

Two ranks on the CPU (gloo):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        examples/torch_serve_skr_sharded.py --device cpu

On GPUs ``--device cuda`` (the default) gives each rank
``cuda:{local_rank % device_count}``: NCCL when every rank has a card of its
own, gloo when ranks share one.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.build import BuildConfig, build_wisk
from repro_torch.core.partition import PartitionConfig
from repro_torch.core.query import execute_serial
from repro_torch.data.synth import make_dataset
from repro_torch.data.workloads import make_workload
from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
from repro_torch.launch.wisk_serve import mesh_dp_size, serve_index_sharded, serve_sharded
from repro_torch.serve.engine import IndexSnapshot
from repro_torch.serve.plan import PlanCache
from repro_torch.serve.snapshot import PartitionedSnapshot


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    cards = torch.cuda.device_count()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    backend = "nccl" if args.device == "cuda" and cards >= world else "gloo"
    dist.init_process_group(backend)  # address, size and rank from torchrun's environment
    device = args.device if args.device == "cpu" else None  # None: cuda:{local_rank % cards}
    mesh = make_host_mesh(data=dist.get_world_size(), model=1, device=device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    ds = make_dataset("fs", n=4000, seed=0)
    train = make_workload(ds, m=64, dist="MIX", seed=1)
    art = None
    if mesh.rank == 0:
        art = build_wisk(ds, train, BuildConfig(partition=PartitionConfig(max_clusters=32,
                                                                          n_steps=50)),
                         device=mesh.device)
        art = dataclasses.replace(art, bank=art.bank.to("cpu"))
    art = mesh.broadcast_object(art)

    # snapshot layer: frozen, the whole index on every rank's device
    snap = IndexSnapshot.build(art.index, ds, device=mesh.device).replicate(mesh)
    say(f"mesh: {mesh.shape} over {mesh.size} rank(s), backend {backend}, rank 0 on "
        f"{mesh.device} ({mesh_dp_size(mesh)} query shards)")

    # plan layer: explicit width state, shared across batches
    cache = PlanCache()
    K = art.partition.clusters.k
    test = make_workload(ds, m=128, dist="MIX", seed=3)
    out = serve_sharded(snap, test.rects, test.kw_bitmap, max_leaves=K, mesh=mesh,
                        plan_cache=cache)
    st = execute_serial(art.index, ds, test)
    agree = all(np.array_equal(np.sort(row[row >= 0]), np.sort(ref))
                for row, ref in zip(out["ids"], st.results))

    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        serve_sharded(snap, test.rects, test.kw_bitmap, max_leaves=K, mesh=mesh, plan_cache=cache)
    dt = (time.perf_counter() - t0) / reps
    widths = ",".join(str(w) for w in out["frontier_widths"])
    say(f"sharded pipeline: {test.m} queries over {mesh.size} rank(s) "
        f"in {dt*1e3:.1f} ms ({test.m/dt:.0f} q/s), exact={agree}, "
        f"widths=[{widths}], learned={sorted(cache.widths.items())}")

    # the hierarchy itself sharded: one shard per rank
    n_root = art.index.levels[0].n
    if n_root >= mesh.size:
        psnap = PartitionedSnapshot.build(snap, mesh.size)
        ix_mesh = make_serving_mesh(query=1, index=mesh.size, device=device)
        ix = serve_index_sharded(psnap, test.rects, test.kw_bitmap, max_leaves=K, mesh=ix_mesh)
        same = all(np.array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0]))
                   for a, b in zip(ix["ids"], out["ids"]))
        same = same and all(np.array_equal(ix[k], out[k])
                            for k in ("counts", "nodes_checked", "verified", "overflow"))
        say(f"index-parallel: {mesh.size} shards of {psnap.per_shard_bytes()} B each (whole "
            f"snapshot {snap.nbytes()} B), same ids and counters={same}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
