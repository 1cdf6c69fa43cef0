"""The port's xLSTM family (reduced ``xlstm-125m``: two units of one mLSTM
and one sLSTM layer, d_model 128, 4 heads of 64, mLSTM chunks of 32) and
its mixers against the JAX package on the CPU.

Weights are the reference's, carried across with ``params_from_reference``;
inputs are seeded numpy. Tolerances, each against the reference:

- the mixers (``mlstm_mixer``, ``slstm_mixer``) and prefill logits in f32:
  ``1e-4`` of the largest magnitude (f32 sums in other orders: XLA's
  ``cumsum``, the einsums, the hoisted ``x @ w_in``); a bf16 model:
  ``5e-2``, the reference test's ``test_decode_matches_prefill_tinyllama``
  bound.
- decode logits from the zero cache (the reference's own decode: ``m`` and
  ``sm`` start at 0, not at ``init_*_state``'s ``-1e30``): ``1e-4``; the
  states are f32.
- decode against prefill from ``init_mlstm_state`` / ``init_slstm_state``
  (a helper of this file, as the smoke's): the port's decode logits within
  ``1e-5`` of the reference's decode from the same start (``1.8e-6`` at
  B = 2, S = 64, token seed 6, where the reference's own decode-to-prefill
  gap is ``2.0e-6``); the port's own gap within ``2e-5``. From the zero
  cache both packages' decode drift ``9.8e-2`` from prefill.
- one layer's ``mlstm_mixer`` against ``mlstm_decode`` step by step from
  ``init_mlstm_state``, in both packages: the port's gap within twice the
  reference's own and ``1e-5``.
- greedy tokens: equal.
- loss and gradients (``value_and_grad``): the loss within ``1e-5``
  relative, each gradient leaf within ``5e-5`` of its largest magnitude;
  three AdamW ``train_step``s: the loss and lr as
  ``tests/test_torch_train.py``, grad_norm within ``2e-4`` and each
  optimizer-state leaf within ``1e-3``, each parameter within ``0.2`` of
  the summed learning rate. The exponential gates amplify f32 roundings:
  the port against itself with one f32 ulp of random sign on every weight
  (``tools/seq_noise_floor.py``, the reduced config's own seeded weights)
  moves a gradient leaf by up to ``4.05e-4`` (B = 2, S = 64), and after
  three steps grad_norm by ``8.9e-5``, a state leaf by ``4.9e-4`` and a
  parameter by ``0.40`` of the summed learning rate (an update's sign
  flips where a gradient is near 0), so ``tests/test_torch_train.py``'s
  bounds would sit below the f32 noise of this model.
- ``remat="full"`` against ``"none"``: equal bit for bit.
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
from repro.models import xlstm as JXL  # noqa: E402
from repro.models.layers import split_params as jsplit_params  # noqa: E402
from repro.train.decode import greedy_generate as jgreedy_generate  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.ckpt import checkpoint as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import XLSTMLM, build_model  # noqa: E402
from repro_torch.train.decode import greedy_generate  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ARCH = "xlstm-125m"
MATMUL_REL = 1e-4
BF16_REL = 5e-2
STATE_START_REL = 1e-5
GAP_REL = 2e-5
LOSS_REL = 1e-5
GRAD_REL = 5e-5
GNORM_REL = 2e-4  # three steps in
STATE_REL = 1e-3
LR_REL = 1e-6
PARAM_LR_FRAC = 0.2


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

    def state(self):
        state = self.steps.init_state(torch.Generator().manual_seed(0))
        state["params"].load_state_dict(params_from_reference(
            jax.tree.map(np.asarray, self.jparams)))
        return state


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype="float32"):
        if dtype not in cache:
            cache[dtype] = _Pair(dtype=dtype)
        return cache[dtype]

    return get


@pytest.fixture(scope="module")
def pair(pairs):
    return pairs()


# ---------------------------------------------- the init_*_state decode start
def state_start(cache):
    """The port's zero cache with every stabilizer at ``init_*_state``'s
    value, so that decode starts where the mixers do."""
    cache["m"].fill_(XL.STAB_INIT)
    cache["sm"].fill_(XL.STAB_INIT)
    return cache


def jstate_start(jcache):
    return dict(jcache, m=jnp.full_like(jcache["m"], -1e30), sm=jnp.full_like(jcache["sm"], -1e30))


def _jzero_cache(jsteps, B, S):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])


def _decode_all(pair, model, toks, cache, jcache, check=None):
    """Both packages' decode over ``toks``, each step's logits within
    ``check`` of the reference's where given; the last step's logits and
    the caches."""
    for t in range(toks.shape[1]):
        jl, jcache = pair.jdecode(pair.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, cache = pair.steps.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                           torch.tensor(t, dtype=torch.int32))
        if check is not None:
            _close(tl, jl, check, f"decode step {t}")
    return tl, cache, jl, jcache


def _mixer_params(jcfg, which, seed):
    init = JXL.init_mlstm if which == "mlstm" else JXL.init_slstm
    jp, _ = jsplit_params(init(jax.random.PRNGKey(seed), jcfg))
    return {k: _t(v) for k, v in jp.items()}, jp


# ----------------------------------------------------------------- mixers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["mlstm", "slstm"])
def test_mixer_matches_reference(which, dtype):
    cfg, jcfg = _cfgs(dtype=dtype)
    p, jp = _mixer_params(jcfg, which, seed=2)
    x = jnp.asarray(np.random.default_rng(3).normal(size=(2, 96, cfg.d_model)), jnp.dtype(dtype))
    jmix, mix = ((JXL.mlstm_mixer, XL.mlstm_mixer) if which == "mlstm"
                 else (JXL.slstm_mixer, XL.slstm_mixer))
    want = jmix(jp, x, jcfg, {})
    got = mix(p, _t(x), cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, MATMUL_REL if dtype == "float32" else BF16_REL, which)


def test_mlstm_chunk_must_divide_the_sequence():
    cfg, _ = _cfgs()
    p, _ = _mixer_params(_cfgs()[1], "mlstm", seed=2)
    with pytest.raises(ValueError, match="multiple of the mLSTM chunk"):
        XL.mlstm_mixer(p, torch.zeros((1, 48, cfg.d_model)), cfg)
    assert XL.mlstm_mixer(p, torch.zeros((1, 16, cfg.d_model)), cfg).shape == (1, 16, 128)


def test_mlstm_nan_where_the_reference_has_it():
    """``n_inter``'s ``... * 0 + ...``: an infinite normalizer product makes
    NaN in both packages."""
    cfg, jcfg = _cfgs(ssm_chunk=8)
    p, jp = _mixer_params(jcfg, "mlstm", seed=4)
    H, dh = cfg.n_heads, cfg.d_inner // cfg.n_heads
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(1, 8, H, dh)).astype(np.float32) for _ in range(3))
    li, lf = (r.normal(size=(1, 8, H)).astype(np.float32) for _ in range(2))
    C = np.zeros((1, H, dh, dh), np.float32)
    N = np.full((1, H, dh), np.inf, np.float32)
    m = np.zeros((1, H), np.float32)
    jh, (jC, jN, jm) = JXL._mlstm_chunk(*map(jnp.asarray, (q, k, v, li, lf)),
                                        tuple(map(jnp.asarray, (C, N, m))))
    h, (C2, N2, m2) = XL._mlstm_chunk(*map(torch.from_numpy, (q, k, v, li, lf)),
                                      tuple(map(torch.from_numpy, (C, N, m))))
    np.testing.assert_array_equal(np.isnan(h.numpy()), np.isnan(np.asarray(jh)))
    assert np.isnan(np.asarray(jh)).any()
    np.testing.assert_allclose(m2.numpy(), np.asarray(jm), rtol=1e-6)


def test_mlstm_mixer_against_decode_step_by_step():
    """One layer's mixer against its decode from ``init_mlstm_state``, in
    both packages: the port's gap is the reference's own."""
    cfg, jcfg = _cfgs()
    p, jp = _mixer_params(jcfg, "mlstm", seed=6)
    B, S = 2, 64
    x = np.random.default_rng(7).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jmix = JXL.mlstm_mixer(jp, jnp.asarray(x), jcfg, {})
    jst = JXL.init_mlstm_state(jcfg, B)
    jdec = jax.jit(lambda st, xt: JXL.mlstm_decode(jp, xt, st, jcfg, {}))
    mix = XL.mlstm_mixer(p, torch.from_numpy(x), cfg)
    st = XL.init_mlstm_state(cfg, B)
    jys, ys = [], []
    for t in range(S):
        jy, jst = jdec(jst, jnp.asarray(x[:, t:t + 1]))
        y, st = XL.mlstm_decode(p, torch.from_numpy(x[:, t:t + 1]), st, cfg)
        jys.append(np.asarray(jy)), ys.append(y.numpy())
    jgap, gap = _err(np.concatenate(jys, 1), jmix), _err(np.concatenate(ys, 1), mix)
    assert gap <= max(2 * jgap, STATE_START_REL), (gap, jgap)
    _close(np.concatenate(ys, 1), np.concatenate(jys, 1), STATE_START_REL, "decode vs decode")
    for name in ("C", "N", "m"):
        _close(st[name], jst[name], STATE_START_REL, f"state {name}")


# ------------------------------------------------------------------ trees
def test_build_model_makes_the_xlstm_module():
    model = build_model(get_config(ARCH)).init(torch.Generator().manual_seed(0), "meta")
    assert isinstance(model, XLSTMLM)
    assert sum(p.numel() for p in model.parameters()) == 194_191_184
    assert model.units.m0.core.wq.shape == (2, 1536, 4, 384)  # 2 units of 5 mLSTM + 1 sLSTM
    assert hasattr(model.units, "s5") and not hasattr(model.units, "m5")
    with pytest.raises(ValueError, match="whole units"):
        build_model(dataclasses.replace(get_config(ARCH), n_layers=10))


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
    assert sd["units.m0.core.w_if"].dtype == torch.float32
    assert [tuple(x.shape) for x in leaves(pair.state()["params"])] == [
        x.shape for x in jax.tree.leaves(pair.jparams)]


def test_bf16_weights_load_bit_for_bit(pairs):
    p = pairs("bfloat16")
    sd = p.state()["params"].state_dict()
    for k, v in params_from_reference(jax.tree.map(np.asarray, p.jparams)).items():
        assert sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k].reshape(-1).view(torch.uint8), v.reshape(-1).view(torch.uint8)), k
    assert sd["units.s1.core.w_rec"].dtype == torch.bfloat16


def test_cache_and_batch_spec_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    for long_ctx in (False, True):
        sds, specs = steps.cache_spec(4, 64, long_ctx)
        jsds, jspecs = jsteps.cache_spec(4, 64, long_ctx)
        assert specs == jspecs and sorted(sds) == sorted(jsds)
        for k in jsds:
            assert sds[k].shape == jsds[k].shape and sds[k].dtype == torch.float32
    assert sds["C"].shape == (2, 1, 4, 4, 64, 64) and sds["sm"].shape == (2, 4, 128)
    b, s = steps.batch_spec("train", 64, 2)
    jb, js = jsteps.batch_spec("train", 64, 2)
    assert s == js and {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in jb.items()}


# ----------------------------------------------------- prefill and decode
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(pairs, dtype):
    p = pairs(dtype)
    toks = _tokens(p.cfg, 2, 64)
    want = p.jprefill(p.jparams, dict(tokens=jnp.asarray(toks)))
    got = p.steps.prefill_step(p.state()["params"], dict(tokens=torch.from_numpy(toks)))
    assert tuple(got.shape) == (2, 1, p.cfg.vocab) and got.dtype == getattr(torch, dtype)
    _close(got, want, MATMUL_REL if dtype == "float32" else BF16_REL, "prefill")


def test_zero_cache_decode_matches_reference(pair):
    """The reference's own decode from ``cache_spec``'s zeros (stabilizers
    at 0), step by step, the states too."""
    model = pair.state()["params"]
    B, S = 2, 16
    toks = _tokens(pair.cfg, B, S, seed=4)
    tl, cache, jl, jcache = _decode_all(pair, model, toks, pair.steps.init_cache(B, S),
                                        _jzero_cache(pair.jsteps, B, S), check=MATMUL_REL)
    for name in jcache:
        _close(cache[name], jcache[name], MATMUL_REL, f"state {name}")


def test_decode_against_prefill_from_init_state(pair):
    model = pair.state()["params"]
    B, S = 2, 64
    toks = _tokens(pair.cfg, B, S, seed=6)
    tl, _, jl, _ = _decode_all(pair, model, toks, state_start(pair.steps.init_cache(B, S)),
                               jstate_start(_jzero_cache(pair.jsteps, B, S)))
    want = pair.jprefill(pair.jparams, dict(tokens=jnp.asarray(toks)))
    got = pair.steps.prefill_step(model, dict(tokens=torch.from_numpy(toks)))
    ref_gap, gap = _err(jl, want), _err(tl, got)
    err = _close(tl, jl, STATE_START_REL, "decode against the reference's decode")
    assert gap <= GAP_REL and err <= max(ref_gap, STATE_START_REL), (err, gap, ref_gap)
    # from the zero cache instead, the reference's own decode drifts from prefill
    zl, *_ = _decode_all(pair, model, toks, pair.steps.init_cache(B, S),
                         _jzero_cache(pair.jsteps, B, S))
    assert _err(zl, got) > 100 * gap


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
    assert torch.any(cache["C"] != 0) and torch.any(cache["sh"] != 0)  # written in place


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
    assert float(grads["units"]["s1"]["core"]["w_rec"].abs().max()) > 0


def test_remat_full_equals_none_bit_for_bit():
    cfg, _ = _cfgs()
    batch = dict(tokens=torch.from_numpy(_tokens(cfg, 2, 32, seed=9)))
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
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(pair.cfg, 2, 32, seed=10 + i)
        jstate, jm = jstep(jstate, dict(tokens=jnp.asarray(toks)))
        state, m = pair.steps.train_step(state, dict(tokens=torch.from_numpy(toks)))
        assert _rel(m["loss"], jm["loss"]) <= LOSS_REL, i
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= GNORM_REL, i
        assert _rel(m["lr"], jm["lr"]) <= LR_REL, i
        lr_sum += float(jm["lr"])
    jopt, topt = jax.tree.leaves(jstate["opt"]), leaves(state["opt"])
    assert len(jopt) == len(topt)
    for a, b in zip(topt, jopt):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert _rel_leaf(a, b) <= STATE_REL
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        assert float(np.max(np.abs(_np(a) - _np(b)))) <= PARAM_LR_FRAC * lr_sum
