#!/usr/bin/env python3
"""How far a MoE model's teacher-forced decode drifts from its prefill on
one GPU, layer by layer, with decode replaying prefill's expert choices.

    python3 tools/moe_decode_drift.py

For ``qwen2-moe-a2.7b`` at its published widths, cut to 1, 2, 4, 8 and
all 24 layers in bf16 and at all 24 in f32, and for ``deepseek-v3-671b``
cut to 4 layers in bf16 (seeded weights, ``chip_smoke.MOE_CHECK``'s
B = 2, S = 4 tokens): each MoE layer's router logits (the centered
log-probabilities of the real experts) at every position, decode against
prefill, relative to their largest magnitude, and the final logits'
``chip_smoke.rel_err``. It prints the card's name and power limit first.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

RUNS = [("qwen2-moe-a2.7b", n, "bfloat16") for n in (1, 2, 4, 8, 24)] + [
    ("qwen2-moe-a2.7b", 24, "float32"), ("deepseek-v3-671b", 4, "bfloat16")]


def centered(probs: torch.Tensor, n_experts: int) -> torch.Tensor:
    lp = torch.log(probs[..., :n_experts].double())
    return lp - lp.mean(-1, keepdim=True)


def drift(dev, arch: str, n_layers: int, dtype: str) -> str:
    from repro_torch.configs import get_config
    from repro_torch.train.step import build_steps

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers, dtype=dtype)
    steps = build_steps(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = steps.bundle.init(gen, dev)
    B, S = cs.MOE_CHECK
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev, dtype=torch.int32)
    with torch.no_grad(), cs.RoutingLog(keep=True) as pl:
        want = steps.prefill_step(params, dict(tokens=toks))
    L = len(pl.calls)
    replay = types.SimpleNamespace(calls=[
        dict(top_idx=pl.calls[layer]["top_idx"].view(B, S, -1)[:, t])
        for t in range(S) for layer in range(L)])
    cache = steps.init_cache(B, S)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    with cs.RoutingLog(replay=replay) as dl:
        for t in range(S):
            got, cache = steps.decode_step(params, cache, toks[:, t:t + 1], pos)
            pos = pos + 1
    per_layer = []
    for layer in range(L):
        p = centered(pl.calls[layer]["probs"], cfg.n_experts).view(B, S, -1)
        d = torch.stack([centered(dl.calls[t * L + layer]["probs"], cfg.n_experts)
                         for t in range(S)], dim=1)
        per_layer.append(float((p - d).abs().max() / p.abs().max()))
    out = (f"{arch} n_layers={n_layers} {dtype}: final logits {cs.rel_err(got, want):.6f} of "
           f"the largest; router logits by MoE layer {[f'{e:.6f}' for e in per_layer]}")
    del params, cache, steps
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_decode_drift: no CUDA device; this run needs the GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(cs.DEVICE)
    cs.log(f"card: {cs.gpu_line()}")
    for arch, n, dtype in RUNS:
        cs.log(drift(dev, arch, n, dtype))
    return 0


if __name__ == "__main__":
    sys.exit(main())
