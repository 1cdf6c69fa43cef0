"""The port's enc-dec and xLSTM families on the card against their plain
run on the CPU, the same weights on both.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_seq.py

At reduced widths in f32 (full f32 products on both devices, as the
promoted f32 x bf16 products always are): ``layer_norm`` within ``2e-6``
(bf16 inputs: a bf16 ulp, ``2**-7`` of the largest magnitude); cross
attention from an f32 source against bf16 weights, whose output is bf16,
within ``2**-7`` of the largest magnitude; the mLSTM and sLSTM mixers
and prefill logits within ``1e-5``; xLSTM's decode, whose f32 states
carry the roundings from step to step, within ``5e-5``; whisper's decode
logits, which read the bf16 self cache (an f32 ulp apart can round to
neighbouring bf16 values), within ``2e-2``; loss and grad_norm of one ``train_step``
within ``1e-5``, each AdamW moment within ``1e-4`` of its largest value
(xLSTM: grad_norm ``5e-5`` and the moments ``1e-3``, above the f32 noise
that ``tools/seq_noise_floor.py`` measures for it).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32_matmul  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

pytestmark = pytest.mark.cuda

F32_REL = 1e-5
CACHE_REL = 2e-2
# xLSTM's decode carries its f32 states' roundings from step to step: 1.0e-5
# at step 13 of 16 on an H100 (NVIDIA H100 80GB HBM3, 700.00 W)
XLSTM_DECODE_REL = 5e-5
# xLSTM's exponential gates amplify f32 roundings: one f32 ulp on every
# weight moves its gradient leaves by up to 4.05e-4 and grad_norm by up to
# 8.9e-5 (tools/seq_noise_floor.py), so its train step is held to these
TRAIN_REL = {"whisper-base": dict(loss=1e-5, grad_norm=1e-5, state=1e-4),
             "xlstm-125m": dict(loss=1e-5, grad_norm=5e-5, state=1e-3)}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def _rel(got, want) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _pair(arch, cuda, seed=0):
    """The reduced config's steps and fresh states on both devices, one set
    of weights (each drawn from a CPU generator of ``seed``)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
    steps, csteps = build_steps(cfg, device=cuda), build_steps(cfg, device="cpu")
    card = steps.init_state(torch.Generator().manual_seed(seed))
    cpu = csteps.init_state(torch.Generator().manual_seed(seed))
    return cfg, steps, csteps, card, cpu


def _start(steps, params, B, S, frames):
    """A decode cache that starts where prefill does (the smoke's
    ``start_cache``): the cross cache from the encoder, or the xLSTM
    stabilizers at ``init_*_state``'s value."""
    cache = steps.init_cache(B, S)
    with torch.no_grad():
        if steps.cfg.family == "encdec":
            enc = params.encode(frames)
            ca = params.tree()["dec_blocks"]["cross_attn"]
            for i in range(cache["xk"].shape[0]):
                cache["xk"][i].copy_(L._proj(enc, ca["wk"][i]))
                cache["xv"][i].copy_(L._proj(enc, ca["wv"][i]))
        else:
            cache["m"].fill_(XL.STAB_INIT)
            cache["sm"].fill_(XL.STAB_INIT)
    return cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_card_equals_cpu(cuda, dtype):
    g = torch.Generator().manual_seed(1)
    x = (torch.randn((4, 9, 128), generator=g) * 3 + 1).to(dtype)
    w, b = torch.randn(128, generator=g), torch.randn(128, generator=g)
    want = L.layer_norm(x, w, b)
    got = L.layer_norm(x.to(cuda), w.to(cuda), b.to(cuda))
    assert got.dtype == dtype
    tol = 2e-6 if dtype == torch.float32 else 2**-7 * float(want.float().abs().max())
    assert float((got.float().cpu() - want.float()).abs().max()) <= tol


def test_cross_attention_f32_source_card_equals_cpu(cuda):
    cfg = dataclasses.replace(get_config("whisper-base").reduced(), dtype="bfloat16",
                              attn_chunk=32)
    params, _ = split_params(L.init_attention(torch.Generator().manual_seed(2), cfg))
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 48, cfg.d_model), generator=g).to(torch.bfloat16)
    src = torch.randn((2, 100, cfg.d_model), generator=g)
    want = L.attention(params, x, cfg, causal=False, kv_x=src)
    got = L.attention(_to(params, cuda), x.to(cuda), cfg, causal=False, kv_x=src.to(cuda))
    assert got.dtype == torch.bfloat16
    # bf16 outputs: a bf16 ulp where the f32 context rounds apart
    assert _rel(got, want) <= 2**-7


@pytest.mark.parametrize("which", ["mlstm", "slstm"])
@full_f32_matmul()
def test_xlstm_mixer_card_equals_cpu(cuda, which):
    cfg = get_config("xlstm-125m").reduced()
    init, mix = ((XL.init_mlstm, XL.mlstm_mixer) if which == "mlstm"
                 else (XL.init_slstm, XL.slstm_mixer))
    params, _ = split_params(init(torch.Generator().manual_seed(4), cfg))
    x = torch.randn((2, 96, cfg.d_model), generator=torch.Generator().manual_seed(5))
    assert _rel(mix(_to(params, cuda), x.to(cuda), cfg), mix(params, x, cfg)) <= F32_REL


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m"])
@full_f32_matmul()
def test_prefill_and_decode_card_equals_cpu(cuda, arch):
    cfg, steps, csteps, card, cpu = _pair(arch, cuda)
    B, S = 2, 16
    pipe = TokenPipeline(cfg.vocab, S, B, seed=6).next_batch(cfg, "cpu")
    want = csteps.prefill_step(cpu["params"], pipe)
    got = steps.prefill_step(card["params"], {k: v.to(cuda) for k, v in pipe.items()})
    err = _rel(got, want)
    assert err <= F32_REL, ("prefill", err)
    frames = None
    if cfg.family == "encdec":
        n_x = steps.cache_spec(B, S)[0]["xk"].shape[2]
        frames = torch.randn((B, n_x, cfg.d_model), generator=torch.Generator().manual_seed(7))
    caches = dict(card=_start(steps, card["params"], B, S, None if frames is None
                              else frames.to(cuda)),
                  cpu=_start(csteps, cpu["params"], B, S, frames))
    for t in range(S):
        tok = pipe["tokens"][:, t:t + 1]
        cl, caches["cpu"] = csteps.decode_step(cpu["params"], caches["cpu"], tok,
                                               torch.tensor(t, dtype=torch.int32))
        gl, caches["card"] = steps.decode_step(card["params"], caches["card"], tok.to(cuda),
                                               torch.tensor(t, dtype=torch.int32, device=cuda))
        err = _rel(gl, cl)
        assert err <= (CACHE_REL if cfg.family == "encdec" else XLSTM_DECODE_REL), (t, err)


@pytest.mark.parametrize("arch", ["whisper-base", "xlstm-125m"])
@full_f32_matmul()
def test_train_step_card_equals_cpu(cuda, arch):
    cfg, steps, csteps, card, cpu = _pair(arch, cuda, seed=8)
    batch = TokenPipeline(cfg.vocab, 32, 2, seed=9).next_batch(cfg, "cpu")
    cpu, cm = csteps.train_step(cpu, batch)
    card, gm = steps.train_step(card, {k: v.to(cuda) for k, v in batch.items()})
    rel = TRAIN_REL[arch]
    for k in ("loss", "grad_norm"):
        err = abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k]))
        assert err <= rel[k], (k, err)
    err = max(_rel(a, b) for a, b in zip(leaves(card["opt"]), leaves(cpu["opt"])))
    assert err <= rel["state"], err
