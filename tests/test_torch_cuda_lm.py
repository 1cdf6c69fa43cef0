"""The port's LM serving path on the card against its plain run on the CPU.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm.py

One set of weights, drawn on the CPU from a seeded generator, serves on
both devices at reduced widths: prefill logits within ``1e-4`` of their
largest magnitude in f32 (full f32 products on both, the summation order
differs) and ``5e-2`` in bf16; decode logits after teacher forcing within
``2e-2`` (f32; the bf16 cache can round an f32 ulp apart to neighbouring
values) or ``5e-2`` (bf16); greedy tokens equal; and the clamped cache
write at ``pos = S`` lands in slot ``S - 1`` on both.
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import full_f32_matmul  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train.decode import greedy_generate  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

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


@pytest.mark.parametrize("arch,dtype", [
    ("tinyllama-1.1b", "float32"), ("starcoder2-7b", "float32"),
    ("phi-3-vision-4.2b", "float32"), ("tinyllama-1.1b", "bfloat16"),
])
@full_f32_matmul()
def test_card_equals_cpu(cuda, arch, dtype):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    csteps, gsteps = build_steps(cfg, device="cpu"), build_steps(cfg, device=cuda)
    cmodel = csteps.init_state(torch.Generator().manual_seed(0))["params"]
    gmodel = copy.deepcopy(cmodel).to(cuda)
    pre_tol = 1e-4 if dtype == "float32" else 5e-2
    dec_tol = 2e-2 if dtype == "float32" else 5e-2
    g = torch.Generator().manual_seed(1)
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g, dtype=torch.int32)
    batch = dict(tokens=toks)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=g)
    want = csteps.prefill_step(cmodel, batch)
    got = gsteps.prefill_step(gmodel, {k: v.to(cuda) for k, v in batch.items()})
    assert _rel(got, want) <= pre_tol

    ccache, gcache = csteps.init_cache(B, S + 8), gsteps.init_cache(B, S + 8)
    for t in range(S):
        pos = torch.tensor(t, dtype=torch.int32)
        cl, ccache = csteps.decode_step(cmodel, ccache, toks[:, t:t + 1], pos)
        gl, gcache = gsteps.decode_step(gmodel, gcache, toks[:, t:t + 1].to(cuda), pos.to(cuda))
        assert _rel(gl, cl) <= dec_tol, t
    ctoks, ccache = greedy_generate(csteps, cmodel, ccache, toks, n_new=8, start_pos=S)
    gtoks, gcache = greedy_generate(gsteps, gmodel, gcache, toks.to(cuda), n_new=8, start_pos=S)
    assert torch.equal(gtoks.cpu(), ctoks)
    assert _rel(gcache["k"], ccache["k"]) <= dec_tol


def test_cache_write_clamps_on_the_card(cuda):
    cfg = get_config("tinyllama-1.1b").reduced()
    steps = build_steps(cfg, device=cuda)
    model = steps.init_state(torch.Generator(device=cuda).manual_seed(0))["params"]
    S = 4
    cache = steps.init_cache(1, S)
    tok = torch.ones((1, 1), dtype=torch.int32, device=cuda)
    logits, cache = steps.decode_step(model, cache, tok, torch.tensor(S, dtype=torch.int32,
                                                                      device=cuda))
    assert torch.isfinite(logits).all()
    written = cache["k"].abs().sum(dim=(0, 1, 3, 4))
    assert written[:S - 1].eq(0).all() and written[S - 1] > 0
