#!/usr/bin/env python3
"""The hybrid phase of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/hybrid_phase.py [--drift] [--profile-prefill]

It runs ``chip_smoke.hybrid_family``: the same code, sizes, seeds and
checks as the smoke's phase 20 (``jamba-v0.1-52b`` at its published
widths, depth cut: prefill, decode at B = 128, the ``long_500k`` decode,
decode against prefill; the card against the port's CPU run; a
``train_step`` at 8 layers and one against the CPU at ``reduced()``),
without the phases before it. The phase launches none of the port's CUDA
kernels, so nothing is built. It prints the card's name and power limit
first; any failed check raises and exits non-zero.

With ``--drift`` it first prints how far phase 20's decode drifts from
prefill at its check shape (``chip_smoke.HYBRID_CHECK``, from the zero
cache, the capacity not binding, each step replaying prefill's expert
choices) by depth and weight dtype: 16 and 8 layers in bf16, 8 in f32
(seeded weights; the k/v cache bf16, as the reference's), without failing.
With ``--profile-prefill`` part (a) also profiles one prefill
(``chip_smoke.HYBRID_PROFILE_PREFILL``, which the smoke leaves off).
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

DRIFT_RUNS = [(16, "bfloat16"), (8, "bfloat16"), (8, "float32")]


def drift(dev, n_layers: int, dtype: str) -> str:
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_steps

    cfg = dataclasses.replace(get_config(cs.HYBRID_ARCH), n_layers=n_layers, dtype=dtype,
                              capacity_factor=cs.HYBRID_CHECK_CF)
    t = time.perf_counter()
    steps = build_steps(cfg, device=dev)
    params = steps.bundle.init(torch.Generator(device=dev).manual_seed(cs.SEED), dev)
    B, S = cs.HYBRID_CHECK
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(cs.SEED + 2))
    err = cs.decode_prefill_gap(steps, params, toks, moe=True)
    del params, steps
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{cs.HYBRID_ARCH} n_layers={n_layers} {dtype}: {S} decode steps at B={B} against "
            f"prefill, max |err| / max |logit| {err:.6f} ({time.perf_counter() - t:.1f} s)")


def main() -> int:
    if not torch.cuda.is_available():
        print("hybrid_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    card = cs.gpu_line()
    cs.log(f"card: {card}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    cs.HYBRID_PROFILE_PREFILL = "--profile-prefill" in sys.argv[1:]
    if "--drift" in sys.argv[1:]:
        with cs.phase("hybrid decode drift by depth and dtype"):
            for n_layers, dtype in DRIFT_RUNS:
                cs.log(drift(dev, n_layers, dtype))
    with cs.phase("hybrid family"):
        cs.hybrid_family(dev, card)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
