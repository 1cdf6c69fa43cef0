#!/usr/bin/env python3
"""The f32 noise floor of the enc-dec and xLSTM families' gradients and
training steps: the port against itself with one f32 ulp of random sign
on every initial weight.

    PYTHONPATH=src python tools/seq_noise_floor.py [--device cpu|cuda]

For each family's ``reduced()`` config in f32 (AdamW, ``remat="none"``;
weights from a CPU generator of seed 0, the perturbation's signs of seed
1): the loss and each gradient leaf of ``loss_and_grads`` at B = 2,
S = 64 (token seeds 7 and 8), then three ``train_step``s at B = 2, S = 32
(token seeds 10-12, warm-up 2): each step's loss and grad_norm, each
optimizer-state leaf and each parameter after the third step -- relative
to the unperturbed run's largest magnitude (a parameter: to the summed
learning rate). Comparisons between two packages or two devices that sit
below these numbers are held to rounding noise; ``tests/test_torch_xlstm.py``
and ``chip_smoke.py`` set their xLSTM bounds from them.
"""
from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import full_f32_matmul, resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def perturbed(state, seed: int = 1):
    """A deep copy of ``state`` with every weight moved one f32 ulp up or down."""
    out = copy.deepcopy(state)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out["params"].parameters():
            up = torch.randint(0, 2, p.shape, generator=g).to(p.device).bool()
            p.copy_(torch.nextafter(p, torch.where(up, torch.inf, -torch.inf).to(p.dtype)))
    return out


def floor(arch: str, dev) -> str:
    cfg = get_config(arch).reduced()
    steps = build_steps(cfg, device=dev, warmup=2)
    base = steps.init_state(torch.Generator().manual_seed(0))
    out = []
    for seed in (7, 8):
        batch = TokenPipeline(cfg.vocab, 64, 2, seed=seed).next_batch(cfg, dev)
        l1, g1 = loss_and_grads(steps.bundle, base["params"], batch)
        l2, g2 = loss_and_grads(steps.bundle, perturbed(base)["params"], batch)
        out.append(f"grads (token seed {seed}): loss {_rel(l2, l1):.2e}, max leaf "
                   f"{max(_rel(a, b) for a, b in zip(leaves(g2), leaves(g1))):.2e}")
    runs = []
    for state in (copy.deepcopy(base), perturbed(base)):
        ms = []
        for i in range(3):
            batch = TokenPipeline(cfg.vocab, 32, 2, seed=10 + i).next_batch(cfg, dev)
            state, m = steps.train_step(state, batch)
            ms.append(m)
        runs.append((state, ms))
    (a, ma), (b, mb) = runs
    lr_sum = sum(float(m["lr"]) for m in ma)
    out.append("three steps: grad_norm " + ", ".join(
        f"{_rel(x['grad_norm'], y['grad_norm']):.2e}" for x, y in zip(mb, ma))
        + f"; state leaf {max(_rel(x, y) for x, y in zip(leaves(b['opt']), leaves(a['opt']))):.2e}"
        + f"; parameter / summed lr "
        + f"{max(float((x - y).detach().abs().max()) for x, y in zip(leaves(b['params']), leaves(a['params']))) / lr_sum:.3f}")
    return f"{arch} reduced() f32 on {dev.type}: " + "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    dev = resolve_device(ap.parse_args().device)
    with full_f32_matmul():
        for arch in ("xlstm-125m", "whisper-base"):
            print(floor(arch, dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
