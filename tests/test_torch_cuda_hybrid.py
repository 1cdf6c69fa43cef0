"""The port's hybrid family (``jamba-v0.1-52b``) on the card against its
plain run on the CPU, the same weights on both.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_hybrid.py

At reduced widths in f32 (full f32 products on both devices): the Mamba
mixer and its decode steps (the states too), prefill logits, 4 decode
steps and one ``train_step``'s loss and grad_norm within ``1e-5``, each
Adafactor factor within ``1e-4`` of its largest value (the smoke's phase
20 (d) and (e) bounds); a bf16 mixer within ``5e-2``. The MoE layers run
the CPU's routing decisions on the card (``chip_smoke.RoutingLog``): a
token's experts are a discontinuous function of its router logits, which
the two devices round apart.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32_matmul  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda

ARCH = "jamba-v0.1-52b"
F32_REL = 1e-5
BF16_REL = 5e-2
STATE_REL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _mamba(dtype: str, seed: int):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype)
    params, _ = split_params(SSM.init_mamba(torch.Generator().manual_seed(seed), cfg))
    return cfg, params


@pytest.mark.parametrize("dtype,rel", [("float32", F32_REL), ("bfloat16", BF16_REL)])
@full_f32_matmul()
def test_mamba_mixer_card_equals_cpu(cuda, dtype, rel):
    cfg, params = _mamba(dtype, seed=1)
    x = torch.randn((2, 96, cfg.d_model), generator=torch.Generator().manual_seed(2)).to(
        getattr(torch, dtype))
    got = SSM.mamba_mixer({k: v.to(cuda) for k, v in params.items()}, x.to(cuda), cfg)
    assert got.dtype == x.dtype
    assert _rel(got, SSM.mamba_mixer(params, x, cfg)) <= rel


@full_f32_matmul()
def test_mamba_decode_card_equals_cpu(cuda):
    cfg, params = _mamba("float32", seed=3)
    gparams = {k: v.to(cuda) for k, v in params.items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(4))
    st, gst = SSM.init_mamba_state(cfg, 2), SSM.init_mamba_state(cfg, 2, cuda)
    for t in range(x.shape[1]):
        want = SSM.mamba_decode(params, x[:, t:t + 1], st, cfg)[0]
        got = SSM.mamba_decode(gparams, x[:, t:t + 1].to(cuda), gst, cfg)[0]
        assert _rel(got, want) <= F32_REL, t
    for k in ("h", "conv"):
        assert _rel(gst[k], st[k]) <= F32_REL, k


def _pair(cuda, seed):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat="full")
    steps, csteps = build_steps(cfg, device=cuda), build_steps(cfg, device="cpu")
    return (cfg, steps, csteps, steps.init_state(torch.Generator().manual_seed(seed)),
            csteps.init_state(torch.Generator().manual_seed(seed)))


@full_f32_matmul()
def test_prefill_and_decode_card_equals_cpu(cuda):
    cfg, steps, csteps, card, cpu = _pair(cuda, seed=5)
    B, S, n = 4, 32, 4
    toks = TokenPipeline(cfg.vocab, S, B, seed=6).next_batch(cfg, "cpu")["tokens"]
    with chip_smoke.RoutingLog(keep=True) as cl:
        want = csteps.prefill_step(cpu["params"], dict(tokens=toks))
    with chip_smoke.RoutingLog(replay=cl):
        got = steps.prefill_step(card["params"], dict(tokens=toks.to(cuda)))
    assert _rel(got, want) <= F32_REL
    caches = dict(card=steps.init_cache(B, n), cpu=csteps.init_cache(B, n))
    with chip_smoke.RoutingLog(keep=True) as cl:
        want = [csteps.decode_step(cpu["params"], caches["cpu"], toks[:, t:t + 1],
                                   torch.tensor(t, dtype=torch.int32))[0] for t in range(n)]
    with chip_smoke.RoutingLog(replay=cl):
        got = [steps.decode_step(card["params"], caches["card"], toks[:, t:t + 1].to(cuda),
                                 torch.tensor(t, dtype=torch.int32, device=cuda))[0]
               for t in range(n)]
    for t in range(n):
        assert _rel(got[t], want[t]) <= F32_REL, t
    for k in ("h", "conv"):
        assert _rel(caches["card"][k], caches["cpu"][k]) <= F32_REL, k


@full_f32_matmul()
def test_train_step_card_equals_cpu(cuda):
    cfg, steps, csteps, card, cpu = _pair(cuda, seed=7)
    assert cfg.optimizer == "adafactor"
    batch = TokenPipeline(cfg.vocab, 32, 2, seed=8).next_batch(cfg, "cpu")
    with chip_smoke.RoutingLog(keep=True) as cl:
        cpu, cm = csteps.train_step(cpu, batch)
    with chip_smoke.RoutingLog(replay=cl):
        card, gm = steps.train_step(card, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        err = abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
        assert err <= F32_REL, (k, err)
    err = max(chip_smoke.rel_err(a, b) for a, b in zip(leaves(card["opt"]), leaves(cpu["opt"])))
    assert err <= STATE_REL, err
