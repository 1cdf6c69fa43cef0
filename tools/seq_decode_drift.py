#!/usr/bin/env python3
"""How far the enc-dec and xLSTM families' teacher-forced decode drifts
from their prefill, by depth and dtype, on one GPU (or ``--device cpu``).

    python3 tools/seq_decode_drift.py [--device cpu] [--batch B] [--steps S]

At the published widths (seeded weights, ``chip_smoke.SEQ_CHECK``'s
B = 8, S = 256 unless given): ``xlstm-125m`` cut to one unit (6 layers)
and at all 12 layers in bf16 and f32, its decode from ``init_*_state``
(``chip_smoke.start_cache``) and, at 12 layers, from the zero cache (the
reference's own decode); ``whisper-base`` at all its layers in bf16 and
f32, the cross cache filled from the encoder. Each line is the last
decode step's logits against ``prefill_step``'s, ``chip_smoke.rel_err``.
On a GPU it prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

RUNS = [("xlstm-125m", 6, "bfloat16"), ("xlstm-125m", 12, "bfloat16"),
        ("xlstm-125m", 12, "float32"), ("whisper-base", 6, "bfloat16"),
        ("whisper-base", 6, "float32")]


def drift(dev, arch: str, n_layers: int, dtype: str, B: int, S: int) -> str:
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_steps

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dtype)
    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = steps.bundle.init(gen, dev)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev, dtype=torch.int32)
    frames = cs.seq_frames(cfg, B, S, gen, dev)
    batch = dict(tokens=toks) if frames is None else dict(tokens=toks, frames=frames)
    want = steps.prefill_step(params, batch)
    out = []
    starts = [("start_cache", True)] + ([("zero cache", False)] if arch == "xlstm-125m" and
                                        n_layers == 12 else [])
    for label, filled in starts:
        cache = (cs.start_cache(steps, params, B, S, frames) if filled
                 else steps.init_cache(B, S))
        pos = torch.zeros((), dtype=torch.int32, device=dev)
        for t in range(S):
            got, cache = steps.decode_step(params, cache, toks[:, t:t + 1], pos)
            pos = pos + 1
        out.append(f"{label} {cs.rel_err(got, want):.6f}")
        del cache
    del params, steps
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return f"{arch} n_layers={n_layers} {dtype} B={B} S={S}: " + ", ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=cs.SEQ_CHECK[0])
    ap.add_argument("--steps", type=int, default=cs.SEQ_CHECK[1])
    args = ap.parse_args()
    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        cs.log(f"card: {cs.gpu_line()}")
    with torch.no_grad():
        for arch, n_layers, dtype in RUNS:
            cs.log(drift(dev, arch, n_layers, dtype, args.batch, args.steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
