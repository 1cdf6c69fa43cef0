"""The port's MoE and MLA layers on the card against their plain run on the
CPU, the same weights on both.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py

At reduced widths in f32 (full f32 products on both devices):
``moe_ffn_dense`` within ``1e-4`` of the largest magnitude, its routing
equal wherever the CPU's k-th and (k+1)-th router logits are further apart
than twice the two devices' largest difference (and the capacity cut's
gates likewise); ``mla_decode`` within ``2e-2`` (what it reads from the
bf16 latent cache can round an f32 ulp apart to neighbouring values), the
cache written in the same slot; two forwards of the MoE layer on the card
equal bit for bit, in f32 and in bf16, with repeated rows so that the
capacity binds on ties.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32_matmul  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _moe(dtype="float32", **kw):
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(), dtype=dtype, **kw)
    params, _ = split_params(MOE.init_moe(torch.Generator().manual_seed(0), cfg))
    return cfg, params


def _x(cfg, B=4, S=48, dtype=torch.float32):
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(dtype)
    x[1] = x[0]  # repeated rows: equal gates at the capacity cut
    return x


@full_f32_matmul()
def test_moe_ffn_dense_card_equals_cpu(cuda):
    cfg, params = _moe()
    x = _x(cfg)
    T = x.shape[0] * x.shape[1]
    want = MOE.moe_ffn_dense(params, x, cfg)
    got = MOE.moe_ffn_dense(_to(params, cuda), x.to(cuda), cfg)
    assert _rel(got, want) <= 1e-4
    # the routing, under the margin rule
    x2d = x.reshape(T, -1)
    cp, ci = MOE._route(x2d, params["w_router"], cfg)
    gp, gi = MOE._route(x2d.to(cuda), params["w_router"].to(cuda), cfg)
    gp, gi = gp.cpu(), gi.cpu()
    lc = torch.log(cp[:, :cfg.n_experts].double())
    err = float((torch.log(gp[:, :cfg.n_experts].double()) - lc).abs().max())
    srt = torch.sort(lc, 1, descending=True).values
    K = cfg.moe_topk
    decided = srt[:, K - 1] - srt[:, K] > 2 * err
    assert decided.float().mean() > 0.9
    assert torch.equal(torch.sort(gi[decided], 1).values, torch.sort(ci[decided], 1).values)
    cap = MOE._capacity(T, cfg, cfg.n_experts)
    E = params["w_gate"].shape[0]
    cval, ctok = MOE._select(cp, ci, 0, E, cap)
    gval, gtok = MOE._select(cp.to(cuda), ci.to(cuda), 0, E, cap)  # the CPU's routing fed in
    assert torch.equal(gtok.cpu(), ctok) and torch.equal(gval.cpu(), cval)
    assert int((cval > 0).sum()) < T * K  # the capacity binds


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_forward_twice_same_bits_on_the_card(cuda, dtype):
    cfg, params = _moe("float32" if dtype == torch.float32 else "bfloat16")
    params = _to(params, cuda)
    x = _x(cfg, B=8, S=64, dtype=dtype).to(cuda)
    a = MOE.moe_ffn_dense(params, x, cfg)
    b = MOE.moe_ffn_dense(params, x, cfg)
    assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("pos", [0, 9, 16])  # 16 == S: the write clamps to slot S - 1
@full_f32_matmul()
def test_mla_decode_card_equals_cpu(cuda, pos):
    cfg = get_config("deepseek-v3-671b").reduced()
    params, _ = split_params(MLA.init_mla(torch.Generator().manual_seed(2), cfg))
    g = torch.Generator().manual_seed(3 + pos)
    S = 16
    ckv = torch.randn((2, S, cfg.kv_lora), generator=g).to(torch.bfloat16)
    kr = torch.randn((2, S, cfg.qk_rope), generator=g).to(torch.bfloat16)
    x = torch.randn((2, 1, cfg.d_model), generator=g)
    p = torch.tensor(pos, dtype=torch.int32)
    cy, cckv, ckr = MLA.mla_decode(params, x, ckv.clone(), kr.clone(), p, cfg)
    gy, gckv, gkr = MLA.mla_decode(_to(params, cuda), x.to(cuda), ckv.to(cuda), kr.to(cuda),
                                   p.to(cuda), cfg)
    assert _rel(gy, cy) <= 2e-2
    slot = min(pos, S - 1)
    keep = torch.arange(S) != slot
    for a, b in ((gckv.cpu(), cckv), (gkr.cpu(), ckr)):
        assert torch.equal(a[:, keep], b[:, keep])
        assert _rel(a[:, slot], b[:, slot]) <= 2**-7
