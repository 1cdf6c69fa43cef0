"""The port's enc-dec family (reduced ``whisper-base``: 2 encoder layers, 4
decoder layers, d_model 128) and its layers against the JAX package on the
CPU.

Weights are the reference's, carried across with ``params_from_reference``;
inputs are seeded numpy. Tolerances, each against the reference:

- ``layer_norm`` and ``sinusoidal_positions``: ``atol=2e-6`` at unit-scale
  values (XLA's and PyTorch's ``rsqrt``, ``exp``, ``sin`` and ``cos`` differ
  by an ulp or two), the positions' plus ``seq * 2**-23`` (a frequency an
  ulp apart moves the angle at position p by up to p ulps of 1);
  ``layer_norm`` of bf16 inputs: one bf16 ulp (``2**-7`` relative) where
  the f32 results round apart.
- f32 products (bidirectional and cross attention, prefill logits, an f32
  source against bf16 weights promoted to f32): ``1e-4`` of the largest
  magnitude; a bf16 model (bf16 weights and frames): ``5e-2``, the
  reference test's ``test_decode_matches_prefill_tinyllama`` bound.
- anything read from the bf16 caches (``decode_attention``, decode logits
  from the zero cache): ``2e-2`` of the largest magnitude, as
  ``tests/test_torch_lm.py``: each package rounds its own k and v.
- decode against prefill with the cross cache filled from the encoder (a
  helper of this file: the reference fills nothing): the port's decode
  logits within ``1e-3`` of the reference's own decode (``7.4e-4`` at B =
  2, S = 64, token seed 6: the two packages round their own self-attention
  k and v into the bf16 cache), under the reference's own decode-to-prefill
  gap (``2.0e-3`` there); the port's own gap (``2.0e-3``) within ``5e-4``
  of the reference's.
- greedy tokens: equal.
- loss and gradients (``value_and_grad``): the loss within ``1e-5``
  relative, each gradient leaf within ``1e-5`` of its largest magnitude;
  three AdamW ``train_step``s: ``tests/test_torch_train.py``'s bounds.
- ``remat="full"`` against ``"none"``: equal bit for bit.
- checkpoints: the bf16 model's state written by either package restores
  in the other bit for bit, in JAX's flatten order.
- ``TokenPipeline``'s frames: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as JK  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.layers import split_params as jsplit_params  # noqa: E402
from repro.train.decode import greedy_generate as jgreedy_generate  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.ckpt import checkpoint as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import EncDecLM, build_model  # noqa: E402
from repro_torch.train.decode import greedy_generate  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "whisper-base"
F32_ATOL = 2e-6
BF16_ULP = 2**-7
MATMUL_REL = 1e-4
CACHE_REL = 2e-2
BF16_REL = 5e-2
FILLED_REL = 1e-3
REF_GAP_SLACK = 5e-4
LOSS_REL = 1e-5
GRAD_REL = 1e-5
STATE_REL = 1e-5
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


def _close(got, want, rel, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, what
    assert np.all(np.isfinite(g)), what
    err = float(np.max(np.abs(g - w)))
    scale = float(np.max(np.abs(w)))
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"
    return err / scale


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


def _frames(cfg, B, S, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).normal(0, 1, (B, S, cfg.d_model)).astype(dtype)


def _batch(toks, frames):
    """The same batch for both packages: (port's, reference's)."""
    return (dict(tokens=torch.from_numpy(toks), frames=_t(frames)),
            dict(tokens=jnp.asarray(toks), frames=jnp.asarray(frames)))


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

    def state(self):
        state = self.steps.init_state(torch.Generator().manual_seed(0))
        state["params"].load_state_dict(params_from_reference(
            jax.tree.map(np.asarray, self.jparams)))
        return state


@pytest.fixture(scope="module")
def pairs():
    """Each config's pair, built once for the file (the reference's jits)."""
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            cache[dtype] = _Pair(dtype=dtype)
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def pair(pairs):
    return pairs()


# ----------------------------------------------------- the cross-cache fill
def fill_cross(model: EncDecLM, cache, enc_out):
    """The port's cross cache from the encoder's output: each decoder
    layer's cross-attention k and v projections, rounded to the cache."""
    blocks = model.tree()["dec_blocks"]["cross_attn"]
    for i in range(cache["xk"].shape[0]):
        cache["xk"][i] = L._proj(enc_out, blocks["wk"][i]).to(cache["xk"].dtype)
        cache["xv"][i] = L._proj(enc_out, blocks["wv"][i]).to(cache["xv"].dtype)
    return cache


def jencode(jcfg, params, frames):
    """The reference's encoder (``build_encdec``'s ``encode``, a closure
    there) from its layers, as it composes them."""
    x = frames + JL.sinusoidal_positions(frames.shape[1], jcfg.d_model).astype(frames.dtype)

    def body(carry, lp):
        h = JL.layer_norm(carry, lp["ln1"], lp["ln1b"])
        carry = carry + JL.attention(lp["attn"], h, jcfg, {}, causal=False)
        h = JL.layer_norm(carry, lp["ln2"], lp["ln2b"])
        return carry + JL.ffn(lp["ffn"], h, {}), None

    x, _ = jax.lax.scan(body, x, params["enc_blocks"])
    return JL.layer_norm(x, params["enc_norm"], params["enc_norm_b"])


def jfill_cross(jparams, jcache, enc_out):
    """The same fill of the reference's cache."""
    ca = jparams["dec_blocks"]["cross_attn"]
    proj = jax.vmap(lambda w: jnp.einsum("bsd,dhk->bshk", enc_out, w))
    return dict(jcache, xk=proj(ca["wk"]).astype(jcache["xk"].dtype),
                xv=proj(ca["wv"]).astype(jcache["xv"].dtype))


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    r = np.random.default_rng(3)
    x = (r.normal(size=(3, 7, 128)) * 4 + 1.5).astype(np.float32)
    w = r.normal(size=(128,)).astype(np.float32)
    b = r.normal(size=(128,)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = JL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(_t(jx), torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP, atol=F32_ATOL)
    # jnp.var is the population variance: a constant row normalizes to the bias
    const = L.layer_norm(torch.full((2, 128), 3.0), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(const.numpy(), np.broadcast_to(b, (2, 128)), atol=F32_ATOL)


@pytest.mark.parametrize("seq,d", [(64, 128), (300, 512), (7, 6)])
def test_sinusoidal_positions_match_reference(seq, d):
    want = np.asarray(JL.sinusoidal_positions(seq, d))
    got = L.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d)
    # an ulp apart in a frequency (XLA's and PyTorch's exp) is up to seq ulps
    # of 1 apart in the angle
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_ATOL + seq * 2**-23)
    # interleaved: sin in the even columns, cos in the odd ones
    np.testing.assert_array_equal(got[0, 0::2].numpy(), np.zeros(d // 2, np.float32))
    np.testing.assert_array_equal(got[0, 1::2].numpy(), np.ones(d // 2, np.float32))


def _attn_params(cfg, jcfg, seed=4):
    jp, _ = jsplit_params(JL.init_attention(jax.random.PRNGKey(seed), jcfg))
    return {k: _t(v) for k, v in jp.items()}, jp


@pytest.mark.parametrize("S", [64, 40])
def test_bidirectional_attention_matches_reference(S):
    """``causal=False`` over the encoder's frames, S a multiple of the
    chunk and not (the padded keys masked)."""
    cfg, jcfg = _cfgs(attn_chunk=16)
    p, jp = _attn_params(cfg, jcfg)
    x = np.random.default_rng(5).normal(size=(2, S, cfg.d_model)).astype(np.float32)
    want = JL.attention(jp, jnp.asarray(x), jcfg, {}, causal=False)
    got = L.attention(p, torch.from_numpy(x), cfg, causal=False)
    _close(got, want, MATMUL_REL, "bidirectional attention")
    causal = L.attention(p, torch.from_numpy(x), cfg)
    assert not torch.allclose(causal, got)  # the flag changes the mask


@pytest.mark.parametrize("S_src", [24, 100])
def test_cross_attention_f32_source_bf16_weights(S_src):
    """Cross attention from a bf16 decoder stream to an f32 source with bf16
    weights: k and v are f32 (JAX promotes), the scores and the context in
    f32, the output cast back to q's bf16; no rope on k. The source is
    shorter and longer than ``x`` (padded to the chunk)."""
    cfg, jcfg = _cfgs(dtype="bfloat16", attn_chunk=32, rope_theta=10000.0)
    p, jp = _attn_params(cfg, jcfg, seed=6)
    r = np.random.default_rng(7)
    x = jnp.asarray(r.normal(size=(2, 48, cfg.d_model)), jnp.bfloat16)
    src = r.normal(size=(2, S_src, cfg.d_model)).astype(np.float32)
    want = JL.attention(jp, x, jcfg, {}, causal=False, kv_x=jnp.asarray(src))
    got = L.attention(p, _t(x), cfg, causal=False, kv_x=torch.from_numpy(src))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want, BF16_REL, "cross attention")
    # the f32 source's k and v are f32, as the reference's promotion
    assert L._proj(torch.from_numpy(src), p["wk"]).dtype == torch.float32


@pytest.mark.parametrize("update_cache,rope", [(True, True), (True, False), (False, False),
                                               (False, True)])
def test_decode_attention_flags(update_cache, rope):
    cfg, jcfg = _cfgs(rope_theta=10000.0)
    p, jp = _attn_params(cfg, jcfg, seed=8)
    r = np.random.default_rng(9)
    B, S = 2, 16
    x = r.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kv = [jnp.asarray(r.normal(size=(B, S, cfg.n_kv_heads, cfg.head_dim)), jnp.bfloat16)
          for _ in range(2)]
    pos = 5 if update_cache else S - 1
    plain = not (update_cache or rope)  # the cross call's: an int position
    jpos = pos if plain else jnp.int32(pos)
    want, jk, jv = JL.decode_attention(jp, jnp.asarray(x), kv[0], kv[1], jpos, jcfg, {},
                                       update_cache=update_cache, rope=rope)
    ck, cv = _t(kv[0]), _t(kv[1])
    tpos = pos if plain else torch.tensor(pos, dtype=torch.int32)
    got, gk, gv = L.decode_attention(p, torch.from_numpy(x), ck, cv, tpos, cfg,
                                     update_cache=update_cache, rope=rope)
    _close(got, want, CACHE_REL, "decode_attention")
    _close(gk, jk, BF16_ULP, "cache k")
    _close(gv, jv, BF16_ULP, "cache v")
    if not update_cache:
        assert torch.equal(gk, _t(kv[0])) and torch.equal(gv, _t(kv[1]))


# ------------------------------------------------------------------ trees
def test_build_model_makes_the_encdec_module():
    bundle = build_model(get_config(ARCH))
    model = bundle.init(torch.Generator().manual_seed(0), "meta")
    assert isinstance(model, EncDecLM) and model.cfg.enc_layers == 6
    assert sum(p.numel() for p in model.parameters()) == 97_182_720


def test_param_tree_and_specs_equal_reference(pair):
    steps, jsteps = pair.steps, pair.jsteps
    assert steps.param_specs == jsteps.param_specs
    assert steps.state_specs == jsteps.state_specs
    sd = pair.state()["params"].state_dict()
    want = params_from_reference(jax.tree.map(np.asarray, pair.jparams))
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape) and sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k], v), k
    assert sd["enc_blocks.ln1b"].shape == (2, 128) and sd["dec_blocks.cross_attn.wk"].shape[0] == 4
    assert "dec_blocks.ffn.w_gate" not in sd  # the gelu FFN
    jleaves = jax.tree.leaves(pair.jparams)
    assert [tuple(x.shape) for x in leaves(pair.state()["params"])] == [x.shape for x in jleaves]


def test_bf16_weights_load_bit_for_bit(pairs):
    p = pairs("bfloat16")
    sd = p.state()["params"].state_dict()
    for k, v in params_from_reference(jax.tree.map(np.asarray, p.jparams)).items():
        assert sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k].reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), k


def test_cache_and_batch_spec_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    for B, S in ((4, 64), (2, 1024)):  # the cross cache's floor of 64, and seq // 4
        for long_ctx in (False, True):
            sds, specs = steps.cache_spec(B, S, long_ctx)
            jsds, jspecs = jsteps.cache_spec(B, S, long_ctx)
            assert specs == jspecs and sorted(sds) == sorted(jsds) == ["k", "v", "xk", "xv"]
            for k in jsds:
                assert sds[k].shape == jsds[k].shape and sds[k].dtype == torch.bfloat16
        b, s = steps.batch_spec("train", S, B)
        jb, js = jsteps.batch_spec("train", S, B)
        assert s == js and {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in jb.items()}
        assert b["frames"].dtype == torch.bfloat16 and b["frames"].shape[1] == max(S // 4, 64)


def test_token_pipeline_frames_bit_for_bit():
    cfg, jcfg = _cfgs()
    for seq in (16, 64):  # the pipeline's floor of 8 frames, and seq // 4
        pipe, jpipe = TokenPipeline(cfg.vocab, seq, 3, seed=5), JTokenPipeline(jcfg.vocab, seq, 3,
                                                                               seed=5)
        for _ in range(2):
            b, jb = pipe.next_batch(cfg, "cpu"), jpipe.next_batch(jcfg)
            assert sorted(b) == sorted(jb) == ["frames", "tokens"]
            assert b["frames"].dtype == torch.float32 and b["frames"].shape == (3, max(seq // 4, 8),
                                                                              cfg.d_model)
            for k in jb:
                np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))


# ----------------------------------------------------- prefill and decode
@pytest.mark.parametrize("frames", ["pipeline_f32", "batch_spec_bf16"])
def test_prefill_matches_reference(pairs, frames):
    """f32 frames as ``TokenPipeline`` gives them into the bf16 model (the
    encoder then runs in f32 against bf16 weights, promoted), and bf16
    frames of ``batch_spec``'s shape and dtype."""
    p = pairs("bfloat16")
    cfg = p.cfg
    model = p.state()["params"]
    B, S = 2, 64
    toks = _tokens(cfg, B, S)
    if frames == "pipeline_f32":
        batch = TokenPipeline(cfg.vocab, S, B, seed=3).next_batch(cfg, "cpu")
        fr = batch["frames"].numpy()
    else:
        shape = p.steps.batch_spec("prefill", S, B)[0]["frames"].shape
        fr = np.asarray(jnp.asarray(_frames(cfg, *shape[:2]), jnp.bfloat16))
    tb, jb = _batch(toks, fr)
    want = p.jprefill(p.jparams, jb)
    got = p.steps.prefill_step(model, tb)
    assert tuple(got.shape) == (B, 1, cfg.vocab) and got.dtype == torch.bfloat16
    _close(got, want, BF16_REL, f"prefill ({frames})")
    enc = model.encode(tb["frames"])
    assert enc.dtype == tb["frames"].dtype  # f32 frames keep the encoder in f32


def test_prefill_f32_matches_reference(pair):
    cfg = pair.cfg
    toks, fr = _tokens(cfg, 2, 48, seed=2), _frames(cfg, 2, 12)
    tb, jb = _batch(toks, fr)
    _close(pair.steps.prefill_step(pair.state()["params"], tb), pair.jprefill(pair.jparams, jb),
           MATMUL_REL, "prefill")


def test_zero_cache_decode_matches_reference(pair):
    """The reference's own decode: the cross cache as ``cache_shape`` gives
    it (zeros, which nothing in the reference fills)."""
    steps, jsteps, cfg = pair.steps, pair.jsteps, pair.cfg
    model = pair.state()["params"]
    B, S = 2, 12
    toks = _tokens(cfg, B, S, seed=4)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])
    cache = steps.init_cache(B, S)
    for t in range(S):
        jl, jcache = pair.jdecode(pair.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, cache = steps.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.tensor(t, dtype=torch.int32))
        _close(tl, jl, CACHE_REL, f"decode step {t}")
    for name in ("k", "v"):
        _close(cache[name], jcache[name], BF16_ULP, f"cache {name}")
    assert not cache["xk"].any() and not cache["xv"].any()  # read, never written


def test_decode_against_prefill_with_filled_cross_cache(pair):
    """Both packages' decode with the cross cache filled from the encoder,
    against each one's teacher-forced prefill."""
    steps, jsteps, cfg = pair.steps, pair.jsteps, pair.cfg
    model = pair.state()["params"]
    B, S = 2, 64
    enc_s = steps.cache_spec(B, S)[0]["xk"].shape[2]  # the cross cache's length: the frames'
    toks, fr = _tokens(cfg, B, S, seed=6), _frames(cfg, B, enc_s, seed=7)
    tb, jb = _batch(toks, fr)
    jenc = jax.jit(lambda p, f: jencode(pair.jcfg, p, f))(pair.jparams, jb["frames"])
    jcache = jfill_cross(pair.jparams, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                                                    jsteps.cache_spec(B, S)[0]), jenc)
    with torch.no_grad():
        enc = model.encode(tb["frames"])
    _close(enc, jenc, MATMUL_REL, "encoder output")
    cache = fill_cross(model, steps.init_cache(B, S), enc)
    for t in range(S):
        jl, jcache = pair.jdecode(pair.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, cache = steps.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.tensor(t, dtype=torch.int32))
    want = pair.jprefill(pair.jparams, jb)
    got = steps.prefill_step(model, tb)
    _close(got, want, MATMUL_REL, "prefill")
    err = _close(tl, jl, FILLED_REL, "decode against the reference's decode")
    ref_gap = float(np.max(np.abs(_np(jl) - _np(want))) / np.max(np.abs(_np(want))))
    gap = float(np.max(np.abs(_np(tl) - _np(got))) / np.max(np.abs(_np(got))))
    assert err < max(ref_gap, FILLED_REL) and gap <= ref_gap + REF_GAP_SLACK, (err, gap, ref_gap)


def test_greedy_generate_tokens_equal(pair):
    steps, jsteps, cfg = pair.steps, pair.jsteps, pair.cfg
    model = pair.state()["params"]
    B, S = 3, 20
    prompt = _tokens(cfg, B, 4, seed=5)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])
    want, _ = jgreedy_generate(jsteps, pair.jparams, jcache, jnp.asarray(prompt), n_new=8,
                               start_pos=3)
    got, cache = greedy_generate(steps, model, steps.init_cache(B, S), torch.from_numpy(prompt),
                                 n_new=8, start_pos=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.all(cache["k"][:, :, :3] == 0) and torch.any(cache["k"][:, :, 3] != 0)


def test_checkpoints_cross_restore_bit_for_bit(pairs, tmp_path):
    """The bf16 model's whole state (parameters, AdamW's f32 moments, the
    step) written by the reference restores in the port leaf for leaf in
    JAX's flatten order, and back."""
    p = pairs("bfloat16")
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
    steps, jsteps, cfg = pair.steps, pair.jsteps, pair.cfg
    state = pair.state()
    toks, fr = _tokens(cfg, 2, 32, seed=7), _frames(cfg, 2, 8, seed=8)
    tb, jb = _batch(toks, fr)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jsteps.bundle.loss(p, b, jsteps.rules, None)))
    jl, jg = vg(pair.jparams, jb)
    loss, grads = loss_and_grads(steps.bundle, state["params"], tb)
    assert loss.dtype == torch.float32 and _rel(loss, jl) <= LOSS_REL
    jleaves, tleaves = jax.tree.leaves(jg), leaves(grads)
    assert len(jleaves) == len(tleaves) == len(leaves(state["params"]))
    for jgl, tgl in zip(jleaves, tleaves):
        assert _rel_leaf(tgl, jgl) <= GRAD_REL
    # the encoder is on the loss's path: its layers have gradients
    assert float(grads["enc_blocks"]["attn"]["wq"].abs().max()) > 0


def test_remat_full_equals_none_bit_for_bit():
    cfg, _ = _cfgs()
    toks = _tokens(cfg, 2, 24, seed=9)
    batch = dict(tokens=torch.from_numpy(toks), frames=torch.from_numpy(_frames(cfg, 2, 6)))
    out = {}
    for remat in ("none", "full"):
        steps = build_steps(dataclasses.replace(cfg, remat=remat), device="cpu")
        state = steps.init_state(torch.Generator().manual_seed(3))
        out[remat] = loss_and_grads(steps.bundle, state["params"], batch)
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(leaves(out["full"][1]), leaves(out["none"][1])):
        assert torch.equal(a, b)


def test_three_adamw_train_steps_match_reference(pair):
    assert pair.cfg.optimizer == "adamw"
    state = pair.state()
    jstep = jax.jit(pair.jsteps.train_step)
    jstate = pair.jstate
    pipe, jpipe = TokenPipeline(pair.cfg.vocab, 32, 2, seed=9), JTokenPipeline(pair.cfg.vocab, 32,
                                                                               2, seed=9)
    lr_sum = 0.0
    for i in range(3):
        jstate, jm = jstep(jstate, jpipe.next_batch(pair.jcfg))
        state, m = pair.steps.train_step(state, pipe.next_batch(pair.cfg, "cpu"))
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
