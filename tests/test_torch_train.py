"""The port's LM training step (``repro_torch.models``' loss, ``optim``,
``train/step.py``) against the JAX package on the CPU.

Weights are the reference's, carried across with ``params_from_reference``;
batches are seeded numpy. Each reference function is jitted once per
fixture. Tolerances, each against the reference:

- loss and gradients (``value_and_grad``), reduced ``tinyllama-1.1b``
  (dense) and ``phi-3-vision-4.2b`` (vlm, with patches) in f32: the loss
  within ``1e-5`` relative, each gradient leaf within ``1e-5`` of its
  largest magnitude (measured up to 1.3e-6: XLA and PyTorch sum the
  products in other orders; the embedding's gradient is a scatter-add
  here, a one-hot product there). One bf16 case: ``1e-2`` and ``2e-2``
  (measured 1.9e-5 and 0.0163: bf16 gradients rounded in other places).
- ``remat="full"`` against ``"none"`` in the port: equal bit for bit.
- three ``train_step``s of each optimizer (``adamw``, ``adafactor``,
  ``sgd``), reduced dense f32: ``loss`` and ``grad_norm`` within ``1e-5``
  relative (measured up to 4.3e-7), ``lr`` within ``1e-6`` (measured
  equal), every optimizer-state leaf within ``1e-5`` of its largest
  magnitude (measured up to 1.8e-6), every parameter within
  ``0.02 * sum(lr)`` absolute (measured up to 0.0037 of it, AdamW: a
  normalized update moves an element by about ``lr`` whatever its
  gradient's size, so an element whose gradient is near zero moves by
  another normalized step where the two packages' gradients differ in
  their last bits).
- ``cosine_schedule``: within ``1e-6`` relative (a few f32 ulps of
  ``cos``); ``clip_by_global_norm``: norm and clipped leaves within
  ``1e-6`` relative, the leaves f32 on both sides.
- ``topk_with_error_feedback`` and ``int8_tree_roundtrip``: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import softmax_xent  # noqa: E402
from repro_torch.optim import compression as C  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.train.step import build_steps, loss_and_grads, opt_state_specs  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 1e-5
BF16_LOSS_REL = 1e-2
BF16_GRAD_REL = 2e-2
STATE_REL = 1e-5
LR_REL = 1e-6
PARAM_LR_FRAC = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the reduced models' ops are
    small, and the suite's parallel workers would otherwise oversubscribe
    the cores (each torch op spinning up a full thread team)."""
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


def _rel_leaf(got, want) -> float:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.all(np.isfinite(g))
    return float(np.max(np.abs(g - w), initial=0.0) / max(np.max(np.abs(w), initial=0.0), 1e-30))


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jget_config(arch).reduced(), **kw))


def _carried(steps, jstate):
    """The port's state with the reference's parameters carried in."""
    state = steps.init_state(torch.Generator().manual_seed(0))
    state["params"].load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, jstate["params"])))
    return state


def _batch(cfg, B=2, S=32, seed=0):
    r = np.random.default_rng(seed)
    b = dict(tokens=r.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.family == "vlm":
        b["patches"] = r.normal(size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


# ------------------------------------------------------------ the loss
def test_softmax_xent_gather_equals_one_hot():
    from repro.models.layers import softmax_xent as jsoftmax_xent

    r = np.random.default_rng(1)
    logits = r.normal(size=(3, 7, 97)).astype(np.float32) * 4
    labels = r.integers(0, 97, (3, 7)).astype(np.int32)
    want = jsoftmax_xent(logits, labels, {})
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got, want) <= LOSS_REL
    lb = jnp.asarray(logits, jnp.bfloat16)  # bf16 logits are widened first
    assert _rel(softmax_xent(_t(lb), torch.from_numpy(labels)),
                jsoftmax_xent(lb, labels, {})) <= LOSS_REL


LOSS_CASES = [("tinyllama-1.1b", {}), ("phi-3-vision-4.2b", {}),
              ("tinyllama-1.1b", dict(dtype="bfloat16"))]


@pytest.mark.parametrize("arch,kw", LOSS_CASES, ids=["dense", "vlm", "dense-bf16"])
def test_loss_and_grads_match_value_and_grad(arch, kw):
    cfg, jcfg = _cfgs(arch, **kw)
    jsteps, steps = jbuild_steps(jcfg), build_steps(cfg, device="cpu")
    jstate = jax.jit(jsteps.init_state)(jax.random.PRNGKey(1))
    state = _carried(steps, jstate)
    batch = _batch(cfg)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jsteps.bundle.loss(p, b, jsteps.rules, None)))
    jl, jg = vg(jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = loss_and_grads(steps.bundle, state["params"],
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    bf16 = cfg.dtype == "bfloat16"
    assert loss.dtype == torch.float32
    assert _rel(loss, jl) <= (BF16_LOSS_REL if bf16 else LOSS_REL)
    jleaves, tleaves = jax.tree.leaves(jg), leaves(grads)
    assert len(jleaves) == len(tleaves) == len(leaves(state["params"]))
    for jgl, tgl, p in zip(jleaves, tleaves, leaves(state["params"])):
        assert tgl.dtype == p.dtype
        assert _rel_leaf(tgl, jgl) <= (BF16_GRAD_REL if bf16 else GRAD_REL)


def test_vlm_loss_covers_the_text_region_only():
    from repro_torch.models.layers import lm_logits, rms_norm

    cfg, _ = _cfgs("phi-3-vision-4.2b")
    steps = build_steps(cfg, device="cpu")
    model = steps.init_state(torch.Generator().manual_seed(0))["params"]
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, S=12).items()}
    x, start = model.embed_inputs(batch)
    assert start == cfg.n_patches and x.shape[1] == cfg.n_patches + 12
    with torch.no_grad():
        h = rms_norm(model.backbone(x)[:, start:], model.final_norm)
        want = softmax_xent(lm_logits(dict(w=model.head.w), h)[:, :-1], batch["tokens"][:, 1:])
        got = model.loss(batch)
        # without patches the same family scores every position
        text = model.loss(dict(tokens=batch["tokens"]))
    assert torch.equal(got, want) and not torch.equal(got, text)


def test_remat_full_equals_none_bit_for_bit():
    cfg, _ = _cfgs("tinyllama-1.1b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for remat in ("none", "full"):
        steps = build_steps(dataclasses.replace(cfg, remat=remat), device="cpu")
        state = steps.init_state(torch.Generator().manual_seed(3))
        out[remat] = loss_and_grads(steps.bundle, state["params"], batch)
    assert torch.equal(out["full"][0], out["none"][0])
    for a, b in zip(leaves(out["full"][1]), leaves(out["none"][1])):
        assert torch.equal(a, b)


# -------------------------------------------------------- the train step
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_three_train_steps_match_reference(opt):
    cfg, jcfg = _cfgs("tinyllama-1.1b", optimizer=opt)
    # warmup 2: the schedule reaches its peak within the three steps
    jsteps = jbuild_steps(jcfg, warmup=2)
    steps = build_steps(cfg, device="cpu", warmup=2)
    jstate = jax.jit(jsteps.init_state)(jax.random.PRNGKey(1))
    state = _carried(steps, jstate)
    jstep = jax.jit(jsteps.train_step)
    lr_sum = 0.0
    for i in range(3):
        toks = _batch(cfg, seed=10 + i)["tokens"]
        jstate, jm = jstep(jstate, dict(tokens=jnp.asarray(toks)))
        state, m = steps.train_step(state, dict(tokens=torch.from_numpy(toks)))
        assert sorted(m) == sorted(jm)
        assert _rel(m["loss"], jm["loss"]) <= LOSS_REL, i
        assert _rel(m["grad_norm"], jm["grad_norm"]) <= LOSS_REL, i
        assert _rel(m["lr"], jm["lr"]) <= LR_REL, i
        lr_sum += float(jm["lr"])
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32
    jopt, topt = jax.tree.leaves(jstate["opt"]), leaves(state["opt"])
    assert len(jopt) == len(topt)
    for a, b in zip(topt, jopt):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert _rel_leaf(a, b) <= STATE_REL
    for a, b in zip(leaves(state["params"]), jax.tree.leaves(jstate["params"])):
        assert float(np.max(np.abs(_np(a) - _np(b)))) <= PARAM_LR_FRAC * lr_sum


def test_train_step_bf16_keeps_dtypes_and_f32_moments():
    cfg, _ = _cfgs("tinyllama-1.1b", dtype="bfloat16", remat="full")
    steps = build_steps(cfg, device="cpu")
    state = steps.init_state(torch.Generator().manual_seed(0))
    before = {k: v.detach().clone() for k, v in state["params"].state_dict().items()}
    state, m = steps.train_step(state, {k: torch.from_numpy(v) for k, v in _batch(cfg).items()})
    assert all(np.isfinite(float(v)) for v in m.values())
    assert m["lr"].dtype == m["grad_norm"].dtype == m["loss"].dtype == torch.float32
    after = state["params"].state_dict()
    assert all(after[k].dtype == before[k].dtype for k in before)
    assert all(p.requires_grad for p in state["params"].parameters())
    assert any(not torch.equal(after[k], before[k]) for k in before)
    assert all(x.dtype == torch.float32 for x in leaves(state["opt"]))
    assert float(leaves(state["opt"].v)[0].abs().sum()) > 0


@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_state_specs_equal_reference(opt):
    cfg, jcfg = _cfgs("starcoder2-7b", optimizer=opt)
    steps, jsteps = build_steps(cfg, device="cpu"), jbuild_steps(jcfg)
    assert steps.state_specs == jsteps.state_specs
    assert opt_state_specs(opt, steps.param_specs) == jsteps.state_specs["opt"]
    state = steps.init_state(torch.Generator().manual_seed(0))
    jshapes = jax.eval_shape(jsteps.init_state, jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in leaves(state)] == [x.shape for x in jax.tree.leaves(jshapes)]


# ---------------------------------------------------- optimizer pieces
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_minimizes_quadratic(name):
    init, update = O.get_optimizer(name)
    w = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 8)).astype(np.float32))
    params = dict(w=w.clone().requires_grad_(True))
    state = init(params)

    def loss(p):
        return torch.mean((p["w"] - 1.0) ** 2)

    l0 = float(loss(params).detach())
    for t in range(200):
        g = torch.autograd.grad(loss(params), [params["w"]])[0]
        upd, state = update(dict(w=g), state, params, torch.tensor(0.05),
                            torch.tensor(t, dtype=torch.int32))
        with torch.no_grad():
            params["w"] += upd["w"]
    assert float(loss(params).detach()) < l0 * 0.05


def test_cosine_schedule_matches_reference():
    f, jf = O.cosine_schedule(3e-4, 100, 10_000), JO.cosine_schedule(3e-4, 100, 10_000)
    for step in (0, 1, 50, 98, 99, 100, 101, 2500, 5000, 9999, 10_000, 12_000):
        got, want = f(torch.tensor(step, dtype=torch.int32)), jf(jnp.int32(step))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - float(want)) <= LR_REL * max(abs(float(want)), 1e-12), step
    g = O.cosine_schedule(1.0, warmup=10, total=100)
    assert abs(float(g(0)) - 0.1) < 1e-6 and abs(float(g(9)) - 1.0) < 1e-6 and float(g(100)) < 1e-6


@pytest.mark.parametrize("max_norm", [0.5, 1e3])  # clipped, and left as it is
def test_clip_by_global_norm_matches_reference(max_norm):
    r = np.random.default_rng(2)
    tree = dict(a=r.normal(size=(17, 5)).astype(np.float32),
                b=dict(c=jnp.asarray(r.normal(size=(3, 4, 6)), jnp.bfloat16),
                       d=r.normal(size=(9,)).astype(np.float32)))
    want, wnorm = JO.clip_by_global_norm(tree, max_norm)
    got, norm = O.clip_by_global_norm(jax.tree.map(_t, tree), max_norm)
    assert _rel(norm, wnorm) <= LR_REL
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert _rel_leaf(g, w) <= LR_REL


# ---------------------------------------------------------- compression
def _grad_tree(seed=4):
    r = np.random.default_rng(seed)
    ties = np.repeat(r.normal(size=(5,)), 8).astype(np.float32)  # tied magnitudes
    return dict(w=r.normal(size=(13, 11)).astype(np.float32),
                b=dict(t=ties.reshape(8, 5), h=jnp.asarray(r.normal(size=(6, 7)), jnp.bfloat16)),
                s=np.float32([3.0]))


def _bits(x) -> np.ndarray:
    """The raw bits, as integers of the element's width."""
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    a = np.asarray(x).reshape(-1)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(f"u{a.itemsize}")


@pytest.mark.parametrize("frac", [0.1, 0.35])
def test_topk_with_error_feedback_bit_for_bit(frac):
    tree = _grad_tree()
    jef, ef = JC.ef_init(tree), C.ef_init(jax.tree.map(_t, tree))
    for i in range(3):  # the residual carries over
        step_tree = jax.tree.map(lambda x: x * (i + 1), tree)
        jcomp, jef = JC.topk_with_error_feedback(step_tree, jef, frac)
        comp, ef = C.topk_with_error_feedback(jax.tree.map(_t, step_tree), ef, frac)
        for a, b in zip(leaves(comp), jax.tree.leaves(jcomp)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for a, b in zip(leaves(ef.residual), jax.tree.leaves(jef.residual)):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_int8_tree_roundtrip_bit_for_bit():
    tree = _grad_tree(5)
    tree["half"] = np.float32([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])  # round half to even
    want = JC.int8_tree_roundtrip(tree)
    got = C.int8_tree_roundtrip(jax.tree.map(_t, tree))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    q, s = C.int8_quantize(torch.from_numpy(tree["w"]))
    jq, js = JC.int8_quantize(tree["w"])
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
