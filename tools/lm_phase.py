#!/usr/bin/env python3
"""The LM serving phase of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/lm_phase.py

It builds the port's CUDA kernels, the ``osm`` synthetic profile at
1,000,000 objects (seed 0), its STR R-tree (leaf 128, fanout 8), the
device snapshot and the 4096-query MIX workload of seed 1 -- the smoke's
index and first batch -- then runs ``chip_smoke.lm_serving``: the same
code, sizes, seeds and checks as the smoke's LM phase, without the phases
before it. It prints the card's name and power limit first; any failed
check raises and exits non-zero.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from repro_torch.baselines.conventional import build_str_rtree
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_workload
    from repro_torch.kernels import _build
    from repro_torch.serve.snapshot import IndexSnapshot

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    card = cs.gpu_line()
    cs.log(f"card: {card}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with cs.phase("kernel build"):
        _build.build_all()
    with cs.phase("data, index and snapshot"):
        t = time.perf_counter()
        ds = make_dataset(cs.PROFILE, n=cs.N_OBJECTS, seed=cs.SEED)
        index = build_str_rtree(ds, leaf_size=cs.LEAF_SIZE, fanout=cs.FANOUT)
        snap = IndexSnapshot.build(index, ds, device=dev)
        wl = make_workload(ds, m=cs.N_QUERIES, dist="MIX", seed=1)
        torch.cuda.synchronize()
        cs.log(f"{cs.PROFILE} n={ds.n}, STR index and snapshot: {time.perf_counter() - t:.3f} s")
    with cs.phase("LM serving"):
        cs.lm_serving(dev, card, ds, index, snap, wl)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
