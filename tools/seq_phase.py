#!/usr/bin/env python3
"""The enc-dec and xLSTM phase of ``chip_smoke.py`` alone, on one GPU.

    python3 tools/seq_phase.py

It runs ``chip_smoke.seq_families``: the same code, sizes, seeds and checks
as the smoke's phase 19 (``whisper-base`` and ``xlstm-125m`` at their
published widths and depth: prefill, a decode that starts where prefill
does, decode against prefill; the card against the port's CPU run; one
``train_step`` of each at full depth and one against the CPU at
``reduced()``), without the phases before it. The phase launches none of
the port's CUDA kernels, so nothing is built. It prints the card's name
and power limit first; any failed check raises and exits non-zero.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("seq_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    card = cs.gpu_line()
    cs.log(f"card: {card}")
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    with cs.phase("enc-dec and xLSTM families"):
        cs.seq_families(dev, card)
    cs.log(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
