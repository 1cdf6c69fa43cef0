"""The port's MoE and MLA decoder-only families (reduced ``qwen2-moe-a2.7b``,
family ``moe``, and ``deepseek-v3-671b``, family ``mla_moe``: one dense
MLA layer, three MLA + MoE layers and the MTP block) against the JAX
package on the CPU.

Weights are the reference's, carried across with ``params_from_reference``;
inputs are seeded numpy. Each reference function is jitted once per
fixture. Tolerances, each against the reference:

- prefill logits: ``1e-4`` of the largest magnitude (f32 products summed
  in other orders); decode logits read from the bf16 cache: ``2e-2``, as
  ``tests/test_torch_lm.py``; the caches ``2**-7`` (a bf16 ulp apart).
- greedy tokens: equal.
- loss and gradients (``value_and_grad``, the MTP term included for
  deepseek): the loss within ``1e-5`` relative, each gradient leaf within
  ``1e-5`` of its largest magnitude, ``tests/test_torch_train.py``'s
  bounds.
- ``remat="full"`` against ``"none"``: equal bit for bit.
- three Adafactor ``train_step``s of deepseek (its published optimizer):
  ``tests/test_torch_train.py``'s bounds for the loss, grad_norm, lr,
  every optimizer-state leaf and the parameters.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.train.decode import greedy_generate as jgreedy_generate  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import block_kinds, build_model  # noqa: E402
from repro_torch.train.decode import greedy_generate  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

MATMUL_REL = 1e-4
CACHE_REL = 2e-2
LOSS_REL = 1e-5
GRAD_REL = 1e-5
STATE_REL = 1e-5
LR_REL = 1e-6
PARAM_LR_FRAC = 0.02
ARCHS = ["qwen2-moe-a2.7b", "deepseek-v3-671b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
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


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _rel_leaf(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.all(np.isfinite(g))
    return float(np.max(np.abs(g - w), initial=0.0) / max(np.max(np.abs(w), initial=0.0), 1e-30))


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


class _Pair:
    """The port's steps and the reference's for one reduced config, with the
    reference's initial state carried into the port's."""

    def __init__(self, arch, **kw):
        self.cfg, self.jcfg = _cfgs(arch, **kw)
        self.jsteps = jbuild_steps(self.jcfg, warmup=2)
        self.steps = build_steps(self.cfg, device="cpu", warmup=2)
        self.jstate = jax.jit(self.jsteps.init_state)(jax.random.PRNGKey(1))
        self.jparams = self.jstate["params"]
        self.jdecode = jax.jit(self.jsteps.decode_step)

    def state(self):
        state = self.steps.init_state(torch.Generator().manual_seed(0))
        state["params"].load_state_dict(params_from_reference(
            jax.tree.map(np.asarray, self.jparams)))
        return state


@pytest.fixture(scope="module")
def pairs():
    """Each arch's pair, built once for the file (the reference's jits)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _Pair(arch)
        return cache[arch]

    return get


@pytest.fixture(params=ARCHS, ids=["qwen2-moe", "deepseek-v3"])
def pair(request, pairs):
    return pairs(request.param)


def test_families_build_and_kinds():
    for arch, kinds in (("qwen2-moe-a2.7b", ("dense", "moe", 0, 4)),
                        ("deepseek-v3-671b", ("mla_dense", "mla_moe", 1, 3))):
        cfg = get_config(arch).reduced()
        assert block_kinds(cfg) == kinds
        assert build_model(get_config(arch)).cfg.family == cfg.family


def test_param_tree_and_specs_equal_reference(pair):
    steps, jsteps = pair.steps, pair.jsteps
    assert steps.param_specs == jsteps.param_specs
    assert steps.state_specs == jsteps.state_specs
    sd = pair.state()["params"].state_dict()
    want = params_from_reference(jax.tree.map(np.asarray, pair.jparams))
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape) and sd[k].dtype == v.dtype, k
        assert torch.equal(sd[k], v), k  # carried bit for bit
    names = set(sd)
    if pair.cfg.family == "moe":
        assert "dense_blocks.attn.wq" not in names and "moe_blocks.moe.shared.w_up" in names
        assert sd["moe_blocks.moe.w_gate"].shape == (4, 16, 128, 64)
    else:
        assert {"dense_blocks.attn.wq_a", "moe_blocks.attn.wkv_a", "mtp.proj",
                "mtp.block.attn.wk_b", "mtp.block.ffn.w_gate", "mtp.norm"} <= names


def test_cache_and_batch_spec_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    for long_ctx in (False, True):
        sds, specs = steps.cache_spec(4, 64, long_ctx)
        jsds, jspecs = jsteps.cache_spec(4, 64, long_ctx)
        assert specs == jspecs and sorted(sds) == sorted(jsds)
        for k in jsds:
            assert sds[k].shape == jsds[k].shape and sds[k].dtype == torch.bfloat16
    b, s = steps.batch_spec("train", 64, 2)
    jb, js = jsteps.batch_spec("train", 64, 2)
    assert s == js and {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in jb.items()}


def test_prefill_and_decode_match_reference(pair):
    steps, jsteps, cfg = pair.steps, pair.jsteps, pair.cfg
    model = pair.state()["params"]
    B, S = 2, 12
    toks = _tokens(cfg, B, S)
    want = jsteps.prefill_step(pair.jparams, dict(tokens=jnp.asarray(toks)))
    got = steps.prefill_step(model, dict(tokens=torch.from_numpy(toks)))
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    _close(got, want, MATMUL_REL, "prefill")

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])
    cache = steps.init_cache(B, S)
    for t in range(S):
        jl, jcache = pair.jdecode(pair.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t))
        tl, cache = steps.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                      torch.tensor(t, dtype=torch.int32))
        _close(tl, jl, CACHE_REL, f"decode step {t}")
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        assert cache[name].shape[0] == cfg.n_layers
        _close(cache[name], jcache[name], 2**-7, f"cache {name}")


def test_greedy_generate_tokens_equal(pair):
    steps, jsteps = pair.steps, pair.jsteps
    model = pair.state()["params"]
    B, S = 3, 20
    prompt = _tokens(pair.cfg, B, 4, seed=5)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(B, S)[0])
    want, _ = jgreedy_generate(jsteps, pair.jparams, jcache, jnp.asarray(prompt), n_new=8,
                               start_pos=3)
    got, cache = greedy_generate(steps, model, steps.init_cache(B, S), torch.from_numpy(prompt),
                                 n_new=8, start_pos=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    first = next(iter(cache.values()))
    assert torch.all(first[:, :, :3] == 0) and torch.any(first[:, :, 3] != 0)


def test_loss_and_grads_match_value_and_grad(pair):
    steps, jsteps = pair.steps, pair.jsteps
    state = pair.state()
    toks = _tokens(pair.cfg, 2, 32, seed=7)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jsteps.bundle.loss(p, b, jsteps.rules, None)))
    jl, jg = vg(pair.jparams, dict(tokens=jnp.asarray(toks)))
    loss, grads = loss_and_grads(steps.bundle, state["params"], dict(tokens=torch.from_numpy(toks)))
    assert loss.dtype == torch.float32 and _rel(loss, jl) <= LOSS_REL
    jleaves, tleaves = jax.tree.leaves(jg), leaves(grads)
    assert len(jleaves) == len(tleaves) == len(leaves(state["params"]))
    for jgl, tgl in zip(jleaves, tleaves):
        assert _rel_leaf(tgl, jgl) <= GRAD_REL
    if pair.cfg.mtp_depth:  # the MTP term is in the loss: its block has gradients
        assert float(grads["mtp"]["proj"].abs().max()) > 0
        with torch.no_grad():
            plain = state["params"].loss(dict(tokens=torch.from_numpy(toks)))
            state["params"].mtp.proj.zero_()
            assert not torch.equal(plain, state["params"].loss(dict(tokens=torch.from_numpy(toks))))


def test_remat_full_equals_none_bit_for_bit():
    """The MoE family under ``torch.utils.checkpoint``: the recomputed
    forward routes as the first, so loss and gradients are the same bits.
    Repeated rows make the capacity bind on ties."""
    cfg, _ = _cfgs("qwen2-moe-a2.7b")
    toks = _tokens(cfg, 4, 24, seed=9)
    toks[1] = toks[0]
    batch = dict(tokens=torch.from_numpy(toks))
    out = {}
    for remat in ("none", "full"):
        steps = build_steps(dataclasses.replace(cfg, remat=remat), device="cpu")
        state = steps.init_state(torch.Generator().manual_seed(3))
        out[remat] = loss_and_grads(steps.bundle, state["params"], batch)
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(leaves(out["full"][1]), leaves(out["none"][1])):
        assert torch.equal(a, b)
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(4))
    x[1] = x[0]
    p = MOE.init_moe(torch.Generator().manual_seed(5), cfg)
    vals = {k: (v.value if not isinstance(v, dict) else {kk: vv.value for kk, vv in v.items()})
            for k, v in p.items()}
    assert torch.equal(MOE.moe_ffn_dense(vals, x, cfg), MOE.moe_ffn_dense(vals, x, cfg))


def test_three_adafactor_train_steps_match_reference(pairs):
    p = pairs("deepseek-v3-671b")
    assert p.cfg.optimizer == "adafactor"
    state = p.state()
    jstep = jax.jit(p.jsteps.train_step)
    jstate = p.jstate
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(p.cfg, 2, 32, seed=10 + i)
        jstate, jm = jstep(jstate, dict(tokens=jnp.asarray(toks)))
        state, m = p.steps.train_step(state, dict(tokens=torch.from_numpy(toks)))
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
    # the expert leaves are stacked 4-D and factored over their last two axes
    vr = state["opt"].vr["moe_blocks"]["moe"]["w_gate"]
    assert vr.shape == (3, 16, p.cfg.d_model)
    assert state["opt"].vc["moe_blocks"]["moe"]["w_gate"].shape == (3, 16, p.cfg.d_expert)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_update_with_fused_clip_equals_clip_then_update(name):
    """``update(..., scale=s)`` on the raw gradients (the streamed train
    step's form) gives the bits of ``clip_by_global_norm`` then ``update``."""
    from repro_torch.optim import optimizers as O

    r = np.random.default_rng(11)
    params = dict(w=torch.from_numpy(r.normal(size=(3, 8, 6)).astype(np.float32)),
                  b=torch.from_numpy(r.normal(size=(6,)).astype(np.float32)).to(torch.bfloat16))
    grads = {k: (torch.from_numpy(r.normal(size=v.shape).astype(np.float32)) * 4).to(v.dtype)
             for k, v in params.items()}
    init, update = O.get_optimizer(name)
    lr, step = torch.tensor(0.01), torch.tensor(2, dtype=torch.int32)
    clipped, norm = O.clip_by_global_norm(grads, 1.0)
    want, wstate = update(clipped, init(params), params, lr, step)
    got, gstate = update(grads, init(params), params, lr, step, scale=O.clip_scale(norm, 1.0))
    for a, b in zip(leaves((got, gstate)), leaves((want, wstate))):
        assert torch.equal(a, b)


def test_adafactor_row_blocks_match_one_pass(monkeypatch):
    """Adafactor's update (and the global norm) works ``CHUNK`` elements at
    a time: as one block and in blocks of 3 of 40 rows, two steps with the
    clip's ``scale`` fused in give the reference's updates, moments and
    norm on the clipped gradients, each leaf within ``STATE_REL`` of its
    largest magnitude."""
    from repro.optim import optimizers as JO
    from repro_torch.optim import optimizers as O

    r = np.random.default_rng(12)
    params = dict(w=r.normal(size=(2, 3, 40, 24)).astype(np.float32),
                  b=r.normal(size=(24,)).astype(np.float32))
    grads = {k: r.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    jinit, jupdate = JO.get_optimizer("adafactor")
    jstate, jgrads = jinit(params), {k: v * np.float32(0.5) for k, v in grads.items()}
    for i in range(2):
        ju, jstate = jupdate(jgrads, jstate, params, jnp.float32(0.01), jnp.int32(i))
    want = (JO.global_norm(grads), ju, jstate)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
    init, update = O.get_optimizer("adafactor")
    for chunk in (O.CHUNK, 500):  # one block; blocks of 3 of the 40 rows
        monkeypatch.setattr(O, "CHUNK", chunk)
        state = init(tparams)
        for i in range(2):
            u, state = update(tgrads, state, tparams, torch.tensor(0.01),
                              torch.tensor(i, dtype=torch.int32), scale=torch.tensor(0.5))
        got = (O.global_norm(tgrads), u, state)
        assert len(leaves(got)) == len(jax.tree.leaves(want))
        for a, b in zip(leaves(got), jax.tree.leaves(want)):
            assert _rel_leaf(a, b) <= STATE_REL, chunk
