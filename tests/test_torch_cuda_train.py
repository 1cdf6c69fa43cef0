"""The port's LM training on the card against its plain run on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

At reduced widths, from one state drawn on the CPU:

- one ``train_step`` on both devices: in f32 (full f32 products on the
  card) loss and grad_norm within ``1e-5`` relative and every AdamW
  moment and parameter within ``1e-4`` of its leaf's largest value
  (summation order alone differs); in bf16 loss within ``1e-2``,
  grad_norm within ``2e-2``, m within ``5e-2`` and v within ``1e-1`` (v is
  g^2: twice m's relative error) -- ``chip_smoke.py``'s phase 17 bounds.
- ``train`` with checkpoints and a restart on the card: the first 3
  losses within ``1e-4`` of the CPU's for each optimizer, the loss falling
  over 40 steps, the restart restored from the first run's last step.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32_matmul  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.train.loop import TrainConfig, train  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

pytestmark = pytest.mark.cuda

F32 = dict(loss=1e-5, grad_norm=1e-5, m=1e-4, v=1e-4, params=1e-4)
BF16 = dict(loss=1e-2, grad_norm=2e-2, m=5e-2, v=1e-1, params=5e-2)
LOOP_REL = 1e-4


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,remat", [("float32", "none"), ("bfloat16", "full")])
@full_f32_matmul()
def test_train_step_card_equals_cpu(cuda, dtype, remat):
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), dtype=dtype, remat=remat)
    tol = F32 if dtype == "float32" else BF16
    csteps, gsteps = build_steps(cfg, device="cpu"), build_steps(cfg, device=cuda)
    cstate = csteps.init_state(torch.Generator().manual_seed(0))
    gmodel = copy.deepcopy(cstate["params"]).to(cuda)
    opt_init, _ = get_optimizer(cfg.optimizer)
    gstate = dict(params=gmodel, opt=opt_init(gmodel.tree()),
                  step=torch.zeros((), dtype=torch.int32, device=cuda))
    batch = TokenPipeline(cfg.vocab, 64, 2, seed=3).next_batch(cfg, "cpu")
    cstate, cm = csteps.train_step(cstate, batch)
    gstate, gm = gsteps.train_step(gstate, {k: v.to(cuda) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(gm[k]) - float(cm[k])) <= tol[k] * abs(float(cm[k])), k
    assert float(gm["lr"]) == pytest.approx(float(cm["lr"]), rel=1e-6)
    for name in ("m", "v"):
        for a, b in zip(leaves(getattr(gstate["opt"], name)), leaves(getattr(cstate["opt"], name))):
            assert a.device.type == "cuda" and a.dtype == torch.float32
            assert _rel(a, b) <= tol[name], name
    for a, b in zip(leaves(gstate["params"]), leaves(cstate["params"])):
        assert a.dtype == b.dtype and _rel(a, b) <= tol["params"]
    assert int(gstate["step"]) == 1


@full_f32_matmul()
def test_train_loop_card_equals_cpu_and_restarts(cuda, tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    tc = dict(batch=4, seq=64, ckpt_every=20, log_every=0)
    r1 = train(cfg, TrainConfig(n_steps=40, ckpt_dir=str(tmp_path), **tc), device=cuda)
    r2 = train(cfg, TrainConfig(n_steps=44, ckpt_dir=str(tmp_path), **tc), device=cuda)
    assert r1.restored_from is None and r2.restored_from == 40 and len(r2.losses) == 4
    assert sum(r1.losses[-5:]) < sum(r1.losses[:5])
    for opt in ("adamw", "adafactor", "sgd"):
        ocfg = dataclasses.replace(cfg, optimizer=opt)
        got = train(ocfg, TrainConfig(n_steps=3, **tc), device=cuda).losses
        want = train(ocfg, TrainConfig(n_steps=3, **tc), device="cpu").losses
        assert all(abs(a - b) <= LOOP_REL * abs(b) for a, b in zip(got, want)), (opt, got, want)
