"""The port's MoE and MLA layers (``repro_torch.models.moe``,
``repro_torch.models.mla``) against the JAX package on the CPU.

Inputs are seeded numpy; weights are the reference's, carried across with
``params_from_reference``. Tolerances, each against the reference:

- ``n_experts_padded`` and ``_capacity``: equal (Python integers).
- ``_route``: ``probs`` within ``1e-6`` relative to each row's largest
  probability (XLA's and PyTorch's ``exp`` and f32 sums differ by an ulp
  or two); ``top_idx`` equal for every token whose k-th and (k+1)-th
  logits are further apart than the logits' error.
- ``_select`` fed the reference's own ``probs`` and ``top_idx``: the
  selected tokens and their gates equal, the tie order at a binding
  capacity included (``jax.lax.top_k`` puts the lower index first among
  equal values); the output ``y`` within ``1e-4`` of its largest
  magnitude (f32 products summed in other orders).
- ``moe_ffn_dense``: ``1e-4`` of the largest magnitude in f32, ``5e-2``
  in bf16 (the reference's bf16 test bound).
- MLA: ``_project_qkv`` and ``mla_attention`` ``1e-4`` in f32; anything
  read from the bf16 latent cache (``mla_decode``) ``2e-2`` of the largest
  magnitude, as ``tests/test_torch_lm.py``'s cache bound: a latent an f32
  ulp apart can round to neighbouring bf16 values.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import mla as JMLA  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.layers import split_params as jsplit_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import split_params  # noqa: E402

MATMUL_REL = 1e-4
PROB_REL = 1e-6
CACHE_REL = 2e-2
BF16_REL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the suite's workers would
    otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert np.all(np.isfinite(g)), what
    err = float(np.max(np.abs(g - w)))
    scale = float(np.max(np.abs(w)))
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"
    return err / scale


def _cfgs(arch="qwen2-moe-a2.7b", **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def _carry(jtree):
    """The reference's Param tree's values as the port's nested tensors."""
    flat = params_from_reference(jax.tree.map(np.asarray, jsplit_params(jtree)[0]))
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = v
    return out, jsplit_params(jtree)[0]


# ----------------------------------------------------------------- sizes
@pytest.mark.parametrize("n_experts", [1, 8, 15, 16, 17, 60, 64, 256])
def test_n_experts_padded(n_experts):
    cfg, jcfg = _cfgs(n_experts=n_experts)
    assert MOE.n_experts_padded(cfg) == JMOE.n_experts_padded(jcfg)
    assert MOE.EP_PAD == JMOE.EP_PAD == 16
    assert MOE.n_experts_padded(cfg) % 16 == 0


@pytest.mark.parametrize("n_tokens,topk,factor,E", [
    (1, 2, 1.25, 8), (64, 2, 1.25, 8), (16384, 4, 1.25, 60), (128, 4, 1.25, 60),
    (2048, 8, 1.25, 256), (128, 8, 1.25, 256), (100, 3, 1.0, 7), (4096, 8, 2.0, 256),
    (77, 1, 1.5, 0), (24, 2, 1.25, 8),
])
def test_capacity_table(n_tokens, topk, factor, E):
    cfg, jcfg = _cfgs(moe_topk=topk, capacity_factor=factor)
    got = MOE._capacity(n_tokens, cfg, E)
    assert got == JMOE._capacity(n_tokens, jcfg, E)
    assert got >= 8 and got % 8 == 0


def test_top_k_breaks_ties_by_lower_index():
    x = np.zeros((3, 25), np.float32)
    x[1, ::3] = 1.0
    x[2] = np.repeat(np.arange(5, dtype=np.float32), 5)
    for k in (1, 7, 20, 25):
        val, idx = MOE._top_k(torch.from_numpy(x), k)
        jval, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))


# ---------------------------------------------------------------- routing
def _router_case(seed, T=64, tie_rows=0):
    cfg, jcfg = _cfgs()
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg)
    tp, jv = _carry(jp)
    r = np.random.default_rng(seed)
    x = r.normal(size=(T, cfg.d_model)).astype(np.float32)
    if tie_rows:
        x[1:tie_rows] = x[0]
    return cfg, jcfg, tp, jv, x


@pytest.mark.parametrize("seed", [0, 1])
def test_route(seed):
    cfg, jcfg, tp, jv, x = _router_case(seed)
    probs, top_idx = MOE._route(torch.from_numpy(x), tp["w_router"], cfg)
    jprobs, jtop = JMOE._route(jnp.asarray(x), jv["w_router"], jcfg)
    assert probs.dtype == torch.float32 and top_idx.shape == (x.shape[0], cfg.moe_topk)
    p, jp_ = probs.numpy(), np.asarray(jprobs)
    assert np.all(np.abs(p - jp_) <= PROB_REL * jp_.max(axis=1, keepdims=True))
    E = tp["w_router"].shape[1]
    assert np.all(p[:, cfg.n_experts:] == 0) and E == 16
    logits = x @ np.asarray(jv["w_router"])
    err = float(np.max(np.abs(x.astype(np.float64) @ np.asarray(jv["w_router"], np.float64)
                              - logits))) * 4 + 1e-6
    srt = -np.sort(-logits[:, :cfg.n_experts], axis=1)
    decided = srt[:, cfg.moe_topk - 1] - srt[:, cfg.moe_topk] > err
    assert decided.mean() > 0.9
    np.testing.assert_array_equal(top_idx.numpy()[decided], np.asarray(jtop)[decided])


def _jselect(probs, top_idx, e_lo, e_n, cap):
    """The reference's selection, as the first lines of its
    ``_select_and_apply``."""
    T = probs.shape[0]
    eids = e_lo + jnp.arange(e_n)
    chosen = (top_idx[None, :, :] == eids[:, None, None]).any(-1)
    gate = jax.lax.dynamic_slice_in_dim(probs, e_lo, e_n, axis=1).T
    score = jnp.where(chosen, gate, -1.0)
    return jax.lax.top_k(score, min(cap, T))


def test_select_and_apply_ties_at_a_binding_capacity():
    """T = 64 tokens, 8 experts padded to 16, top-2: capacity 24. Rows 0-31
    are identical, so two experts are chosen by at least 32 tokens with
    equal gates; which of them each keeps is the tie order."""
    T = 64
    cfg, jcfg, tp, jv, x = _router_case(3, T=T, tie_rows=32)
    cap = MOE._capacity(T, cfg, cfg.n_experts)
    assert cap == JMOE._capacity(T, jcfg, jcfg.n_experts) == 24
    jprobs, jtop = JMOE._route(jnp.asarray(x), jv["w_router"], jcfg)
    probs = torch.from_numpy(np.array(jprobs))
    top_idx = torch.from_numpy(np.asarray(jtop).astype(np.int64))
    E = tp["w_gate"].shape[0]
    val, tok = MOE._select(probs, top_idx, 0, E, cap)
    jval, jtok = _jselect(jprobs, jtop, 0, E, cap)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    # the case binds: tokens are dropped, and the tied rows decide it
    kept = int((val > 0).sum())
    assert kept < T * cfg.moe_topk
    tied = set(np.asarray(jtop)[0].tolist())
    for e in tied:
        takers = set(np.asarray(jtok)[e][np.asarray(jval)[e] > 0].tolist())
        assert len(takers & set(range(32))) < 32  # some tied rows dropped
    y = MOE._select_and_apply(torch.from_numpy(x), probs, top_idx, tp["w_gate"], tp["w_up"],
                              tp["w_down"], cfg, 0, E, cap)
    jy = JMOE._select_and_apply(jnp.asarray(x), jprobs, jtop, jv["w_gate"], jv["w_up"],
                                jv["w_down"], jcfg, 0, E, cap)
    _close(y, jy, MATMUL_REL, "y")


def test_select_and_apply_expert_slice():
    """A slice of the experts (``e_lo``, ``e_n``), as one rank of the
    reference's sharded MoE computes: the same selection and output."""
    T = 48
    cfg, jcfg, tp, jv, x = _router_case(4, T=T)
    jprobs, jtop = JMOE._route(jnp.asarray(x), jv["w_router"], jcfg)
    probs = torch.from_numpy(np.array(jprobs))
    top_idx = torch.from_numpy(np.asarray(jtop).astype(np.int64))
    cap = MOE._capacity(T, cfg, cfg.n_experts)
    for e_lo, e_n in ((0, 4), (4, 4), (8, 8)):
        sl = {k: tp[k][e_lo:e_lo + e_n] for k in ("w_gate", "w_up", "w_down")}
        y = MOE._select_and_apply(torch.from_numpy(x), probs, top_idx, sl["w_gate"],
                                  sl["w_up"], sl["w_down"], cfg, e_lo, e_n, cap)
        jy = JMOE._select_and_apply(
            jnp.asarray(x), jprobs, jtop, *(jv[k][e_lo:e_lo + e_n] for k in
                                            ("w_gate", "w_up", "w_down")), jcfg, e_lo, e_n, cap)
        if float(np.max(np.abs(np.asarray(jy)))) == 0:
            assert float(y.abs().max()) == 0  # padding experts only: nothing valid
        else:
            _close(y, jy, MATMUL_REL, f"experts {e_lo}..{e_lo + e_n}")


@pytest.mark.parametrize("shared,dtype,rel", [
    (1, "float32", MATMUL_REL), (0, "float32", MATMUL_REL), (1, "bfloat16", BF16_REL),
], ids=["shared", "routed-only", "bf16"])
def test_moe_ffn_dense(shared, dtype, rel):
    cfg, jcfg = _cfgs(n_shared_experts=shared, dtype=dtype)
    jp = JMOE.init_moe(jax.random.PRNGKey(5), jcfg)
    tp, jv = _carry(jp)
    assert ("shared" in tp) == bool(shared)
    r = np.random.default_rng(6)
    x = jnp.asarray(r.normal(size=(2, 24, cfg.d_model)), dtype)
    want = JMOE.moe_ffn_dense(jv, x, jcfg, {})
    got = MOE.moe_ffn(tp, params_from_reference(dict(x=np.asarray(x)))["x"], cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, rel, "moe_ffn_dense")


def test_init_moe_tree_and_specs():
    cfg, jcfg = _cfgs()
    tree = MOE.init_moe(torch.Generator().manual_seed(0), cfg)
    values, specs = split_params(tree)
    jvalues, jspecs = jsplit_params(JMOE.init_moe(jax.random.PRNGKey(0), jcfg))
    assert specs == jspecs
    assert jax.tree.map(lambda a: a.shape, jvalues) == {
        k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict)
            else tuple(v.shape)) for k, v in values.items()}
    assert values["w_router"].dtype == torch.float32
    assert values["w_gate"].shape == (16, cfg.d_model, cfg.d_expert)
    # the reference's scale rule: fan_in is the expert count
    assert abs(float(values["w_gate"].std()) * 16**0.5 - 1) < 0.05
    meta, _ = split_params(MOE.init_moe(torch.Generator(), cfg, device="meta"))
    assert meta["w_up"].device.type == "meta" and meta["w_up"].shape == values["w_up"].shape


# -------------------------------------------------------------------- MLA
def _mla_case(seed=7):
    cfg, jcfg = _cfgs("deepseek-v3-671b")
    jp = JMLA.init_mla(jax.random.PRNGKey(seed), jcfg)
    tp, jv = _carry(jp)
    return cfg, jcfg, tp, jv


def test_init_mla_specs():
    cfg, jcfg = _cfgs("deepseek-v3-671b")
    tree = MLA.init_mla(torch.Generator().manual_seed(0), cfg)
    assert split_params(tree)[1] == jsplit_params(JMLA.init_mla(jax.random.PRNGKey(0), jcfg))[1]


def test_project_qkv_and_mla_attention():
    cfg, jcfg, tp, jv = _mla_case()
    r = np.random.default_rng(8)
    x = r.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40)[None, :] + 2
    got = MLA._project_qkv(tp, torch.from_numpy(x), cfg, torch.from_numpy(pos))
    want = JMLA._project_qkv(jv, jnp.asarray(x), jcfg, jnp.asarray(pos))
    for g, w, name in zip(got, want, ("q_nope", "q_rope", "c_kv", "k_rope")):
        _close(g, w, MATMUL_REL, name)
    assert got[3].shape == (2, 40, 1, cfg.qk_rope)
    for chunk in (16, 64):  # KV padded to a chunk multiple, and one chunk
        c, jc = dataclasses.replace(cfg, attn_chunk=chunk), dataclasses.replace(jcfg,
                                                                                attn_chunk=chunk)
        _close(MLA.mla_attention(tp, torch.from_numpy(x), c),
               JMLA.mla_attention(jv, jnp.asarray(x), jc, {}), MATMUL_REL, f"chunk {chunk}")


@pytest.mark.parametrize("pos,dtype", [(0, "float32"), (9, "float32"), (16, "float32"),
                                       (9, "bfloat16")])  # 16 == S: the write clamps
def test_mla_decode(pos, dtype):
    cfg, jcfg = _cfgs("deepseek-v3-671b", dtype=dtype)
    jp = JMLA.init_mla(jax.random.PRNGKey(9), jcfg)
    tp, jv = _carry(jp)
    r = np.random.default_rng(10 + pos)
    S = 16
    ckv = jnp.asarray(r.normal(size=(2, S, cfg.kv_lora)), jnp.bfloat16)
    kr = jnp.asarray(r.normal(size=(2, S, cfg.qk_rope)), jnp.bfloat16)
    x = jnp.asarray(r.normal(size=(2, 1, cfg.d_model)), dtype)
    y, nckv, nkr = JMLA.mla_decode(jv, x, ckv, kr, jnp.int32(pos), jcfg, {})
    tc = params_from_reference(dict(a=np.asarray(ckv), b=np.asarray(kr), x=np.asarray(x)))
    gy, gckv, gkr = MLA.mla_decode(tp, tc["x"], tc["a"], tc["b"],
                                   torch.tensor(pos, dtype=torch.int32), cfg)
    assert gckv is tc["a"] and gkr is tc["b"]  # written in place
    assert gy.dtype == getattr(torch, dtype) and gy.shape == (2, 1, cfg.d_model)
    slot = min(pos, S - 1)
    keep = np.arange(S) != slot
    for got, want in ((gckv, nckv), (gkr, nkr)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got)[:, keep], _np(want)[:, keep])
        _close(got[:, slot], want[:, slot], 2**-7, "the written slot")
    _close(gy, y, CACHE_REL if dtype == "float32" else BF16_REL, "mla_decode")
