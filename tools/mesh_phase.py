#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone, on one GPU: LMs served and trained
over a mesh of ranks, every family in the reference's rules layout, and the
dry run.

    python3 tools/mesh_phase.py [--dtype ARCH=DTYPE ...] [--train-dtype m1=DTYPE ...]
                                [--readings]

It runs ``chip_smoke.lms_over_ranks``: the same code, sizes, seeds and
checks as the smoke's phase 21 -- qwen2-moe at its published widths cut to
4 layers served on four ranks ``(data=2, model=2)`` and on two ``(1, 2)``,
deepseek-v3 cut to 4 layers on two; (j) whisper-base and (k) xlstm-125m at
their published widths and depth on four (xLSTM also one long-context
step), (l) jamba-v0.1-52b cut to one superblock of 8 layers on two with a
``long_500k`` step; each rank's logits against the single-device run's,
each rank's collective census against the dry run's; then, in the same
spawn, (f) qwen2-moe cut to 2 layers trained two steps on ``(2, 2)``,
(g) deepseek-v3's ``reduced()`` step with Adafactor, (h) its checkpoint
restored on ``plan_remesh(2)``'s ``(1, 2)`` and stepped on, (m) a step of
whisper-base, xlstm-125m and jamba's ``reduced()`` superblock, each
against one device's step, (i) every training census against the dry
run's; the full-width dry run of eight cells on the 256-GPU mesh --
without the phases before it. ``--dtype`` serves an arch's weights and
``--train-dtype`` steps one of (m)'s runs in another dtype than the
phase's (``RANKS_DTYPE``, ``RANKS_TRAIN_DTYPE``: xLSTM, and (m)'s whisper
and xLSTM, in f32); ``--readings`` logs a tolerance check that fails as a
reading instead of raising (the census checks still raise). The bf16
readings PERF.md records are

    python3 tools/mesh_phase.py --readings --dtype xlstm-125m=bfloat16 \
        --train-dtype m1=bfloat16 --train-dtype m2=bfloat16

The phase launches none of the port's CUDA kernels, so nothing is built.
It prints the card's name and power limit first; any failed check raises
and exits non-zero.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", action="append", default=[], metavar="ARCH=DTYPE",
                    help="serve ARCH's weights in DTYPE")
    ap.add_argument("--train-dtype", action="append", default=[], metavar="WHICH=DTYPE",
                    help="step (m)'s run WHICH (m1, m2) in DTYPE")
    ap.add_argument("--readings", action="store_true",
                    help="log a failed tolerance check as a reading instead of raising")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    cs.RANKS_READINGS = args.readings
    for item in args.dtype:
        arch, dtype = item.split("=")
        cs.RANKS_DTYPE[arch] = dtype
    for item in args.train_dtype:
        which, dtype = item.split("=")
        cs.RANKS_TRAIN_DTYPE[which] = dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    card = cs.gpu_line()
    cs.log(f"card: {card}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with cs.phase("LMs over ranks and the dry run"):
        cs.lms_over_ranks(dev, card)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
