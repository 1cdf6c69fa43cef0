"""The port's hybrid family (reduced ``jamba-v0.1-52b``: two superblocks of
four layers, attention at position 1, an MoE FFN at positions 1 and 3, d_model
128, d_inner 256, d_state 8, SSM chunks of 32, 8 experts top-2) and its
Mamba mixer against the JAX package on the CPU.

Weights are the reference's, carried across with ``params_from_reference``;
inputs are seeded numpy. Tolerances, each against the reference:

- ``_ssm_scan``, both eager: equal (JAX's own ``associative_scan``
  recursion, the same tree of combines; the reference's interleave adds a
  zero, so -0 and +0 compare equal); ``_causal_conv`` equal (the same
  shifted multiplies in the same order); ``softplus`` within ``4e-7``
  relative of ``jax.nn.softplus`` (measured up to 3 f32 ulps: ``log1p``
  and ``exp`` of two libraries) and ``1e-37`` absolute (XLA flushes the
  subnormal results near ``x = -87`` to 0).
- ``mamba_mixer`` and prefill logits in f32: ``1e-4`` of the largest
  magnitude (f32 sums in other orders: the products, the einsums, XLA's
  fused multiply-adds in the jitted scan); the bf16 mixer, and a bf16
  model without experts: ``5e-2``, the reference test's
  ``test_decode_matches_prefill_tinyllama`` bound (measured 2.1-2.2 % over
  token seeds 0-3). A bf16 model with its experts routes near-ties apart
  in either package: the reference's own bf16 prefill lies 11-98 % from its
  f32 run on the same weights (seeds 0-3), so the port's bf16 prefill is
  held to lie no further from that f32 run than the reference's bf16 does,
  plus ``5e-2``.
- ``mamba_decode`` step by step against the reference's, the states too:
  ``1e-4``.
- decode logits from the zero cache (the reference's own decode; the zero
  cache is the mixer's own start), step by step, the caches too: ``1e-4``
  (the caches' bf16 k and v: ``2e-2``, an f32 ulp apart can round to
  neighbouring bf16 values).
- decode against prefill, in the port, with a capacity that cannot bind and
  the cache's k and v in f32: ``1e-5`` (the reference reads ``2.2e-6`` at
  B = 2, S = 64; as built, its prefill drops choices at capacity that its
  decode keeps, and its decode reads k and v through the bf16 cache).
- greedy tokens: equal.
- loss and gradients (``value_and_grad``): the loss within ``1e-5``
  relative, each gradient leaf within ``5e-5`` of its largest magnitude;
  three Adafactor ``train_step``s at ``tests/test_torch_train.py``'s
  bounds for loss and grad_norm (``1e-5`` relative), lr (``1e-6``) and
  each parameter (within ``0.02`` of the summed learning rate); each
  optimizer-state leaf, Adafactor's factored squared gradients, within
  ``1e-4`` of its largest magnitude: the square of a gradient held to
  ``5e-5`` (measured up to ``3.7e-5``, the ``A_log`` row factor, whose
  gradient sums over the scan's exponentials).
- ``remat="full"`` (a checkpoint a block) against ``"none"``: equal bit for
  bit.
- checkpoints: the bf16 model's state written by either package restores
  in the other bit for bit, in JAX's flatten order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as JK  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models.layers import split_params as jsplit_params  # noqa: E402
from repro.train.decode import greedy_generate as jgreedy_generate  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.ckpt import checkpoint as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import (HybridLM, block_kinds, build_model,  # noqa: E402
                                      hybrid_attn_position, hybrid_moe_positions)
from repro_torch.train.decode import greedy_generate  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "jamba-v0.1-52b"
MATMUL_REL = 1e-4
CACHE_REL = 2e-2
BF16_REL = 5e-2
GAP_REL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 5e-5
STATE_REL = 1e-4
LR_REL = 1e-6
PARAM_LR_FRAC = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor with the same bits."""
    return params_from_reference(dict(x=np.asarray(a)))["x"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.all(np.isfinite(g))
    return float(np.max(np.abs(g - w)) / np.max(np.abs(w)))


def _close(got, want, rel, what=""):
    err = _err(got, want)
    assert err <= rel, f"{what}: max |err| / max |want| {err} > {rel}"
    return err


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_leaf(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.all(np.isfinite(g))
    return float(np.max(np.abs(g - w), initial=0.0) / max(np.max(np.abs(w), initial=0.0), 1e-30))


def _cfgs(**kw):
    return (dataclasses.replace(get_config(ARCH).reduced(), **kw),
            dataclasses.replace(jget_config(ARCH).reduced(), **kw))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


class _Pair:
    """The port's steps and the reference's for one reduced config, with the
    reference's initial state carried into the port's."""

    def __init__(self, **kw):
        self.cfg, self.jcfg = _cfgs(**kw)
        self.jsteps = jbuild_steps(self.jcfg, warmup=2)
        self.steps = build_steps(self.cfg, device="cpu", warmup=2)
        self.jstate = jax.jit(self.jsteps.init_state)(jax.random.PRNGKey(1))
        self.jparams = self.jstate["params"]
        self.jdecode = jax.jit(self.jsteps.decode_step)
        self.jprefill = jax.jit(self.jsteps.prefill_step)

    def carried(self):
        return params_from_reference(jax.tree.map(np.asarray, self.jparams))

    def state(self):
        state = self.steps.init_state(torch.Generator().manual_seed(0))
        state["params"].load_state_dict(self.carried())
        return state


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype="float32", **kw):
        key = (dtype,) + tuple(sorted(kw.items()))
        if key not in cache:
            cache[key] = _Pair(dtype=dtype, **kw)
        return cache[key]

    return get


@pytest.fixture(scope="module")
def pair(pairs):
    return pairs()


def _jzero_cache(jsteps, B, S):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])


def _mamba_params(jcfg, seed):
    jp, _ = jsplit_params(JSSM.init_mamba(jax.random.PRNGKey(seed), jcfg))
    return {k: _t(v) for k, v in jp.items()}, jp


# ------------------------------------------------------------- the mixer
@pytest.mark.parametrize("L", [1, 2, 3, 7, 32, 33])
def test_ssm_scan_equals_reference(L):
    """Both eager: the same tree of combines gives the same f32 values."""
    r = np.random.default_rng(L)
    dA = np.exp(-np.abs(r.normal(size=(2, L, 16, 8)))).astype(np.float32)
    dBx = r.normal(size=(2, L, 16, 8)).astype(np.float32)
    h0 = r.normal(size=(2, 16, 8)).astype(np.float32)
    jh, jlast = JSSM._ssm_scan(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(h0))
    h, last = SSM._ssm_scan(*map(torch.from_numpy, (dA, dBx, h0)))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_causal_conv_and_softplus_equal_reference():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 19, 24)).astype(np.float32)
    w = r.normal(size=(4, 24)).astype(np.float32)
    b = r.normal(size=(24,)).astype(np.float32)
    want = JSSM._causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_array_equal(SSM._causal_conv(*map(torch.from_numpy, (x, w, b))).numpy(),
                                  np.asarray(want))
    s = np.concatenate([r.normal(scale=30, size=20000), [0.0, -0.0, 1e30, -1e30, 88.0, -104.0,
                                                         np.inf, -np.inf, np.nan]])
    s = s.astype(np.float32)
    got = SSM.softplus(torch.from_numpy(s)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(s)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=4e-7, atol=1e-37)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_matches_reference(dtype):
    cfg, jcfg = _cfgs(dtype=dtype)
    p, jp = _mamba_params(jcfg, seed=2)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 96, cfg.d_model)), jnp.dtype(dtype))
    want = JSSM.mamba_mixer(jp, x, jcfg, {})
    got = SSM.mamba_mixer(p, _t(x), cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, MATMUL_REL if dtype == "float32" else BF16_REL, "mamba_mixer")


def test_ssm_chunk_must_divide_the_sequence():
    cfg, jcfg = _cfgs()
    p, _ = _mamba_params(jcfg, seed=2)
    with pytest.raises(ValueError, match="multiple of the SSM chunk"):
        SSM.mamba_mixer(p, torch.zeros((1, 48, cfg.d_model)), cfg)
    assert SSM.mamba_mixer(p, torch.zeros((1, 16, cfg.d_model)), cfg).shape == (1, 16, 128)


def test_mamba_decode_step_by_step_matches_reference():
    """The reference's decode and the port's, step by step from
    ``init_mamba_state``, the states too; and the port's decode against its
    own mixer over the same inputs."""
    cfg, jcfg = _cfgs()
    p, jp = _mamba_params(jcfg, seed=6)
    B, S = 2, 64
    x = np.random.default_rng(7).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jst = JSSM.init_mamba_state(jcfg, B)
    jdec = jax.jit(lambda st, xt: JSSM.mamba_decode(jp, xt, st, jcfg, {}))
    st = SSM.init_mamba_state(cfg, B)
    h_buf = st["h"]
    ys = []
    for t in range(S):
        jy, jst = jdec(jst, jnp.asarray(x[:, t:t + 1]))
        y, st = SSM.mamba_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        _close(y, jy, MATMUL_REL, f"decode step {t}")
        ys.append(y)
    assert st["h"] is h_buf  # written in place
    for name in ("h", "conv"):
        _close(st[name], jst[name], MATMUL_REL, f"state {name}")
    mix = SSM.mamba_mixer(p, torch.from_numpy(x), cfg)
    _close(torch.cat(ys, 1), mix, MATMUL_REL, "decode against the mixer")


# ------------------------------------------------------------------ trees
def test_build_model_makes_the_hybrid_module():
    cfg = get_config(ARCH)
    bundle = build_model(cfg)
    model = HybridLM(cfg, bundle.init_tree(torch.Generator(), device="meta"))  # nothing drawn
    # the reference's count (its jax.eval_shape of the init)
    assert sum(p.numel() for p in model.parameters()) == 51_570_315_264
    assert hybrid_attn_position(cfg) == 3 and hybrid_moe_positions(cfg) == (1, 3, 5, 7)
    assert block_kinds(cfg)[2:] == (16, 16)
    assert model.units.b3.mix.wq.shape == (4, 4096, 32, 128)
    assert model.units.b0.mix.A_log.shape == (4, 8192, 16)
    assert model.units.b1.ffn.w_gate.shape == (4, 16, 4096, 14336)
    assert hasattr(model.units.b0.ffn, "w_up") and not hasattr(model.units.b0.ffn, "w_router")
    with pytest.raises(ValueError, match="whole superblocks"):
        build_model(dataclasses.replace(cfg, n_layers=12))


def test_param_tree_and_specs_equal_reference(pair):
    steps, jsteps = pair.steps, pair.jsteps
    assert pair.cfg.attn_every == 4 and pair.cfg.n_layers == 8  # two superblocks
    assert steps.param_specs == jsteps.param_specs
    assert steps.state_specs == jsteps.state_specs
    sd = pair.state()["params"].state_dict()
    want = pair.carried()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape) and sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k], v), k
    for name in ("A_log", "D", "conv_w", "conv_b", "dt_proj", "dt_bias"):
        assert sd[f"units.b0.mix.{name}"].dtype == torch.float32, name
    assert sd["units.b0.mix.A_log"].shape == (2, 256, 8)
    assert [tuple(x.shape) for x in leaves(pair.state()["params"])] == [
        x.shape for x in jax.tree.leaves(pair.jparams)]
    # the port's own init: the reference's fixed A_log and D
    own = pair.steps.init_state(torch.Generator().manual_seed(0))["params"].state_dict()
    np.testing.assert_allclose(own["units.b2.mix.A_log"].numpy(), _np(want["units.b2.mix.A_log"]),
                               rtol=1.2e-7)
    assert torch.equal(own["units.b2.mix.D"], want["units.b2.mix.D"])


def test_bf16_weights_load_bit_for_bit(pairs):
    p = pairs("bfloat16")
    sd = p.state()["params"].state_dict()
    for k, v in p.carried().items():
        assert sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k].reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), k
    assert sd["units.b0.mix.in_proj"].dtype == torch.bfloat16
    assert sd["units.b0.mix.dt_proj"].dtype == torch.float32


def test_cache_and_batch_spec_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    for long_ctx in (False, True):
        sds, specs = steps.cache_spec(4, 64, long_ctx)
        jsds, jspecs = jsteps.cache_spec(4, 64, long_ctx)
        assert specs == jspecs and sorted(sds) == sorted(jsds)
        for k in jsds:
            assert sds[k].shape == jsds[k].shape, k
            assert str(sds[k].dtype).removeprefix("torch.") == str(jsds[k].dtype), k
    assert sds["k"].shape == (2, 4, 64, 2, 32) and sds["k"].dtype == torch.bfloat16
    assert sds["h"].shape == (2, 3, 4, 256, 8) and sds["conv"].shape == (2, 3, 4, 3, 256)
    b, s = steps.batch_spec("train", 64, 2)
    jb, js = jsteps.batch_spec("train", 64, 2)
    assert s == js and {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in jb.items()}
    assert sorted(b) == ["tokens"]


# ----------------------------------------------------- prefill and decode
@pytest.mark.parametrize("dtype,experts", [("float32", True), ("bfloat16", False)])
def test_prefill_matches_reference(pairs, dtype, experts):
    p = pairs(dtype) if experts else pairs(dtype, n_experts=0)
    assert block_kinds(p.cfg)[3] == (4 if experts else 0)
    toks = _tokens(p.cfg, 2, 64)
    want = p.jprefill(p.jparams, dict(tokens=jnp.asarray(toks)))
    got = p.steps.prefill_step(p.state()["params"], dict(tokens=torch.from_numpy(toks)))
    assert tuple(got.shape) == (2, 1, p.cfg.vocab) and got.dtype == getattr(torch, dtype)
    _close(got, want, MATMUL_REL if dtype == "float32" else BF16_REL, "prefill")


def test_bf16_prefill_within_the_references_own_noise(pairs):
    """With its experts, bf16 flips routing near-ties in both packages: the
    port's bf16 prefill lies no further from the f32 run of the same
    weights than the reference's bf16 prefill does, plus ``5e-2``."""
    p, f = pairs("bfloat16"), pairs()
    toks = _tokens(p.cfg, 2, 64)
    jb = p.jprefill(p.jparams, dict(tokens=jnp.asarray(toks)))
    jf = f.jprefill(jax.tree.map(lambda a: a.astype(jnp.float32), p.jparams),
                    dict(tokens=jnp.asarray(toks)))
    got = p.steps.prefill_step(p.state()["params"], dict(tokens=torch.from_numpy(toks)))
    ref_noise = _err(jb, jf)
    assert _err(got, jf) <= ref_noise + BF16_REL, (_err(got, jf), ref_noise)


def test_zero_cache_decode_matches_reference(pair):
    """The reference's own decode from ``cache_spec``'s zeros, step by
    step, every cache entry too."""
    model = pair.state()["params"]
    B, S = 2, 16
    toks = _tokens(pair.cfg, B, S, seed=4)
    cache, jcache = pair.steps.init_cache(B, S), _jzero_cache(pair.jsteps, B, S)
    bufs = {k: v.data_ptr() for k, v in cache.items()}
    for t in range(S):
        jl, jcache = pair.jdecode(pair.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, cache = pair.steps.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                           torch.tensor(t, dtype=torch.int32))
        _close(tl, jl, MATMUL_REL, f"decode step {t}")
    assert {k: v.data_ptr() for k, v in cache.items()} == bufs  # written in place
    for name in jcache:
        _close(cache[name], jcache[name], CACHE_REL if name in "kv" else MATMUL_REL,
               f"cache {name}")


def test_decode_against_prefill(pair):
    """The port's decode from the zero cache against its prefill over the
    same tokens, where no capacity binds and the cache's k and v are f32:
    one function, other roundings."""
    B, S = 2, 64
    cfg = dataclasses.replace(pair.cfg, capacity_factor=100.0)
    steps = build_steps(cfg, device="cpu")
    model = steps.bundle.init(torch.Generator().manual_seed(0))
    model.load_state_dict(pair.carried())
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=6))
    want = steps.prefill_step(model, dict(tokens=toks))
    cache = steps.init_cache(B, S)
    cache["k"], cache["v"] = cache["k"].float(), cache["v"].float()
    for t in range(S):
        got, cache = steps.decode_step(model, cache, toks[:, t:t + 1],
                                       torch.tensor(t, dtype=torch.int32))
    _close(got, want, GAP_REL, "decode against prefill")
    # as built, prefill's capacity binds (choices dropped) and decode reads
    # the bf16 cache: the gap is the reference's own, far above
    as_built = pair.steps.prefill_step(pair.state()["params"], dict(tokens=toks))
    assert _err(got, as_built) > 100 * GAP_REL


def test_greedy_generate_tokens_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    model = pair.state()["params"]
    B, S = 3, 20
    prompt = _tokens(pair.cfg, B, 4, seed=5)
    want, _ = jgreedy_generate(jsteps, pair.jparams, _jzero_cache(jsteps, B, S),
                               jnp.asarray(prompt), n_new=8, start_pos=3)
    got, cache = greedy_generate(steps, model, steps.init_cache(B, S), torch.from_numpy(prompt),
                                 n_new=8, start_pos=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.any(cache["h"] != 0) and torch.any(cache["conv"] != 0)
    assert torch.any(cache["k"][:, :, 3:11] != 0) and not torch.any(cache["k"][:, :, 11:] != 0)


def test_checkpoints_cross_restore_bit_for_bit(pairs, tmp_path):
    """The bf16 model's whole state (parameters, Adafactor's f32 factors,
    the step) written by the reference restores in the port leaf for leaf
    in JAX's flatten order, and back."""
    p = pairs("bfloat16")
    assert p.cfg.optimizer == "adafactor"
    JK.save(str(tmp_path / "ref"), 3, p.jstate)
    got, step = K.restore(str(tmp_path / "ref"), p.steps.init_state(
        torch.Generator().manual_seed(5)))
    jl, tl = jax.tree.leaves(p.jstate), leaves(got)
    assert step == 3 and len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype) and tuple(a.shape) == b.shape
        assert torch.equal(a.detach().reshape(-1).view(torch.uint8), _t(b).reshape(-1).view(
            torch.uint8))
    state = p.steps.init_state(torch.Generator().manual_seed(6))
    K.save(str(tmp_path / "port"), 4, state)
    back, jstep = JK.restore(str(tmp_path / "port"), p.jstate)
    assert jstep == 4
    for a, b in zip(jax.tree.leaves(back), leaves(state)):
        assert torch.equal(_t(a).reshape(-1).view(torch.uint8),
                           b.detach().reshape(-1).view(torch.uint8))


# --------------------------------------------------------------- training
def test_loss_and_grads_match_value_and_grad(pair):
    steps, jsteps = pair.steps, pair.jsteps
    state = pair.state()
    toks = _tokens(pair.cfg, 2, 64, seed=7)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jsteps.bundle.loss(p, b, jsteps.rules, None)))
    jl, jg = vg(pair.jparams, dict(tokens=jnp.asarray(toks)))
    loss, grads = loss_and_grads(steps.bundle, state["params"], dict(tokens=torch.from_numpy(toks)))
    assert loss.dtype == torch.float32 and _rel(loss, jl) <= LOSS_REL
    jleaves, tleaves = jax.tree.leaves(jg), leaves(grads)
    assert len(jleaves) == len(tleaves) == len(leaves(state["params"]))
    for jgl, tgl in zip(jleaves, tleaves):
        assert _rel_leaf(tgl, jgl) <= GRAD_REL
    mix = grads["units"]["b0"]["mix"]
    for name in ("A_log", "D", "dt_proj", "conv_w"):
        assert float(mix[name].abs().max()) > 0, name


def test_remat_full_equals_none_bit_for_bit():
    cfg, _ = _cfgs()
    batch = dict(tokens=torch.from_numpy(_tokens(cfg, 2, 64, seed=9)))
    out = {}
    for remat in ("none", "full"):
        steps = build_steps(dataclasses.replace(cfg, remat=remat), device="cpu")
        state = steps.init_state(torch.Generator().manual_seed(3))
        out[remat] = loss_and_grads(steps.bundle, state["params"], batch)
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(leaves(out["full"][1]), leaves(out["none"][1])):
        assert torch.equal(a, b)


def test_three_adafactor_train_steps_match_reference(pair):
    assert pair.cfg.optimizer == "adafactor"
    state = pair.state()
    jstep = jax.jit(pair.jsteps.train_step)
    jstate = pair.jstate
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(pair.cfg, 2, 32, seed=10 + i)
        jstate, jm = jstep(jstate, dict(tokens=jnp.asarray(toks)))
        state, m = pair.steps.train_step(state, dict(tokens=torch.from_numpy(toks)))
        assert _rel(m["loss"], jm["loss"]) <= LOSS_REL, i
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= LOSS_REL, i
        assert _rel(m["lr"], jm["lr"]) <= LR_REL, i
        lr_sum += float(jm["lr"])
    jopt, topt = jax.tree.leaves(jstate["opt"]), leaves(state["opt"])
    assert len(jopt) == len(topt)
    for a, b in zip(topt, jopt):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert _rel_leaf(a, b) <= STATE_REL
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        assert float(np.max(np.abs(_np(a) - _np(b)))) <= PARAM_LR_FRAC * lr_sum
