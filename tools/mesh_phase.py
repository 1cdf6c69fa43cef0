#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone, on one GPU: LMs served and trained
over a mesh of ranks, and the dry run.

    python3 tools/mesh_phase.py

It runs ``chip_smoke.lms_over_ranks``: the same code, sizes, seeds and
checks as the smoke's phase 21, every model laid out as the reference's
rules place it (qwen2-moe at its published widths cut to 4 layers served
on four ranks ``(data=2, model=2)`` and on two ``(1, 2)``, deepseek-v3 cut
to 4 layers on two; each rank's logits against the single-device run's,
each rank's collective census against the dry run's; then, in the same
spawn, (f) qwen2-moe cut to 2 layers trained two steps on ``(2, 2)``,
(g) deepseek-v3's ``reduced()`` step with Adafactor,
(h) its checkpoint restored on ``plan_remesh(2)``'s ``(1, 2)`` and stepped
on, each against one device's step, (i) every training census against the
dry run's; the full-width dry run of eight cells on the 256-GPU mesh),
without the phases before it. The phase launches none of the port's CUDA kernels, so
nothing is built. It prints the card's name and power limit first; any
failed check raises and exits non-zero.
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
        print("mesh_phase: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
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
