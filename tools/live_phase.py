#!/usr/bin/env python3
"""The live front door phase of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/live_phase.py

It builds the port's CUDA kernels, the ``osm`` synthetic profile at
1,000,000 objects (seed 0) and a WISK index on it with ``BuildConfig()``,
trained on the 4096-query MIX workload of seed 3 -- the construction
phase's full-size build -- then runs ``chip_smoke.live_front_door`` on that
build: the same code, sizes, seeds and checks as the smoke's last phase,
without the phases before it. It prints the card's name and power limit
first; any failed check raises and exits non-zero.
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
        print("live_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    from repro_torch.core.build import BuildConfig, build_wisk
    from repro_torch.data.synth import make_dataset
    from repro_torch.data.workloads import make_workload
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    cs.log(f"card: {cs.gpu_line()}")
    with cs.phase("kernel build"):
        _build.build_all()
    with cs.phase("data and build_wisk"):
        ds = make_dataset(cs.PROFILE, n=cs.N_OBJECTS, seed=cs.SEED)
        train = make_workload(ds, m=cs.N_TRAIN, dist="MIX", seed=3)
        t = time.perf_counter()
        art = build_wisk(ds, train, BuildConfig(), device=dev)
        torch.cuda.synchronize()
        cs.log(f"build_wisk {cs.PROFILE} n={ds.n}: {time.perf_counter() - t:.3f} s")
    with cs.phase("live front door"):
        cs.live_front_door(dev, ds, train, art)
    cs.log(f"card: {cs.gpu_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
