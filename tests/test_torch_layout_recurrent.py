"""The enc-dec, xLSTM and hybrid families over a ``("data", "model")`` mesh
of gloo ranks on the CPU in the reference's rules layout (``inner`` over
``model`` with the Mamba state split with it, ``wembed`` over the data
axes, whisper's overrides keeping its heads and vocabulary whole, the
decode caches' slots over ``kv_seq`` or, under ``long_ctx``, over every
axis), against the port on one device and the JAX package's gradients on a
forced 4-device host platform.

One pool of four ranks (tests/test_torch_ranks.py, task
``layout_family``); the layouts ``(data, model)`` are (2, 2) for every
family and (1, 2) for jamba (the pool's first two ranks). The configs are
``reduced()`` (f32): whisper-base at 2 encoder and 2 decoder layers,
xlstm-125m at one mLSTM and one sLSTM layer, jamba at one superblock of 4
(three Mamba layers, the attention at position 1, MoE FFNs at 1 and 3).
The parameters are the port's seeded draw, whole, as numpy
(``initial_values``); each rank takes its blocks, one device loads them
whole, and the reference (a subprocess with
``--xla_force_host_platform_device_count=4``, started with the module's
first test) places them with its rules' shardings.

* the prefill logits of each rank's rows within ``F32_REL`` (1e-4) of the
  largest of one device's prefill of the rank's data shard alone (jamba's
  MoE capacity counts the shard's tokens, as the reference's);
* four decode steps into ``N_SLOTS`` slots (positions 0, 1, 2 cross
  the block boundary of the slots over ``model``; the last, ``N_SLOTS``,
  is past the end: the clamp writes the last slot), whisper's cross cache
  filled with each decoder layer's cross k / v of the encoder's output (as
  tests/test_torch_encdec.py's ``fill_cross``), and for xLSTM and jamba
  ``long_ctx`` steps of one row into ``N_LONG`` slots over every rank:
  each within ``F32_REL`` of one device's decode of the whole batch, and
  the final cache equal to one device's blocks. The caches are f32: a bf16
  cache rounds what each layout computes in f32 (the note of
  tests/test_torch_layout_serve.py);
* every gradient block after ``step_gradients`` within ``LEAF_REL`` (1e-4)
  of the largest value of the reference's ``jax.grad`` leaf, and the loss
  within ``METRIC_REL`` (1e-5): the leaves whole over ``model`` that every
  ``model`` rank reads -- whisper's attention, the norms, the mLSTM's
  ``b_if``, the sLSTM's gathered ``w_in`` / ``w_rec`` / ``b`` -- neither
  counted twice nor halved;
* each rank's census of the prefill, of each decode step, of the
  gradients and of a ``train_step`` equal to the abstract mesh's
  (``make_abstract_mesh``) integer for integer;
* each rank's state and batch bytes equal to the dry run's
  ``argument_bytes`` of ``train_4k`` at the same shapes, its parameter,
  cache and token bytes to ``decode_32k``'s (and xLSTM's and jamba's
  ``long_500k``'s), each equal to the cell's ``rules_argument_bytes``.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import collective_census, make_abstract_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.sharding.rules import named_sharding  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402
from test_torch_train_ranks import LEAF_REL, METRIC_REL, flat, nest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_REL = 1e-4
B, S = 4, 32  # prefill and training
N_SLOTS = 4  # decode: positions 0, 1, 2 (slot 2 is model rank 1's at model=2), then 4
POSITIONS = [0, 1, 2, N_SLOTS]
N_LONG = 8  # long-context decode: one row, slots over every rank
CASES = {
    "whisper-base-2x2": ("whisper-base", (2, 2)),
    "xlstm-125m-2x2": ("xlstm-125m", (2, 2)),
    "jamba-v0.1-52b-2x2": ("jamba-v0.1-52b", (2, 2)),
    "jamba-v0.1-52b-1x2": ("jamba-v0.1-52b", (1, 2)),
}
# a leaf of each family whole over model that every model rank reads
WHOLE_OVER_MODEL = {"whisper-base": "cross_attn.wk", "xlstm-125m": "core.b_if",
                    "jamba-v0.1-52b": "ln1"}
DEPTH = {"whisper-base": 2, "xlstm-125m": 2, "jamba-v0.1-52b": 4}


def config(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=DEPTH[arch])


def long_ctx_case(arch: str) -> bool:
    return get_config(arch).subquadratic


def initial_values(arch: str):
    """The port's whole draw of ``config(arch)``'s parameters from seed 0,
    as the reference's flat names to numpy."""
    model = build_steps(config(arch), device="cpu").init_state(
        torch.Generator().manual_seed(0))["params"]
    return {k: v.detach().numpy().copy() for k, v in flat(model.tree()).items()}


def batch(arch: str):
    """The prefill and training batch of the batch spec's shapes, seeded
    numpy; float entries (the frames, bf16 in the spec) as f32 of bf16
    values, taken in the model's dtype (the reference's encoder scan keeps
    its carry in the frames' dtype, and its weights are f32 here)."""
    cfg = config(arch)
    rng = np.random.default_rng(17)
    sds, _ = build_steps(cfg, device="meta").batch_spec("train", S, B)
    out = {}
    for k, s in sds.items():
        if s.dtype == torch.int32:
            out[k] = rng.integers(0, cfg.vocab, s.shape).astype(np.int32)
        else:
            x = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
            out[k] = x.to(s.dtype).float().numpy()
    return out


def torch_batch(arch: str):
    """``batch`` as the port takes it: the tokens int32, the frames in the
    model's dtype."""
    return {k: torch.from_numpy(v) for k, v in batch(arch).items()}


def batch_row_bytes(arch: str, layout) -> int:
    """The bytes of a rank's rows of the batch in the batch spec's dtypes
    (what the dry run counts)."""
    cfg = config(arch)
    mesh = make_abstract_mesh(data=layout[0], model=layout[1])
    steps = build_steps(cfg, mesh=mesh)
    sds, specs = steps.batch_spec("train", S, B)
    return sum(math.prod(named_sharding(mesh, specs[k], steps.rules).shard_shape(s.shape))
               * s.dtype.itemsize for k, s in sds.items())


def decode_tokens(arch: str):
    rng = np.random.default_rng(19)
    vocab = config(arch).vocab
    return (rng.integers(0, vocab, (B, len(POSITIONS))).astype(np.int32),
            rng.integers(0, vocab, (1, 4)).astype(np.int32))


_FORCED = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from test_torch_layout_recurrent import B, CASES, S, batch, config
from test_torch_train_ranks import nest
from repro.train.step import build_steps

assert len(jax.devices()) == 4, jax.devices()
src, dst = sys.argv[1], sys.argv[2]
out = {}
for key, (arch, (d, m)) in CASES.items():
    cfg = config(arch)
    mesh = Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))
    steps = build_steps(cfg, mesh)
    with np.load(f"{src}/{arch}.npz") as z:
        params = nest({k: jnp.asarray(z[k]) for k in z.files})
    params = jax.device_put(params, steps.shardings(steps.param_specs))
    b = {k: jnp.asarray(v) for k, v in batch(arch).items()}
    b = jax.device_put(b, steps.shardings(steps.batch_spec("train", S, B)[1]))
    loss_fn = lambda p, b: steps.bundle.loss(p, b, steps.rules, mesh)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, b)
    out[f"{key}/loss"] = np.asarray(loss)
    for j, g in enumerate(jax.tree.leaves(grads)):
        out[f"{key}/grad{j}"] = np.asarray(g)
np.savez(dst, **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def values(tmp_path_factory):
    d = tmp_path_factory.mktemp("values")
    made = {}
    for arch in dict.fromkeys(a for a, _ in CASES.values()):
        made[arch] = initial_values(arch)
        np.savez(d / f"{arch}.npz", **made[arch])
    return d, made


@pytest.fixture(scope="module")
def forced_reference(tmp_path_factory, values):
    out = tmp_path_factory.mktemp("forced") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _FORCED, str(values[0]), str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    p = RankPool(4, f"file://{d}/world4")
    yield p
    p.close()


def _reference(forced):
    proc, out = forced
    if proc.returncode is None:
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
    assert proc.returncode == 0
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def fill_cross(model, cache, enc_out):
    """Each decoder layer's cross-attention k and v of the encoder's
    output, written into the cross cache (tests/test_torch_encdec.py's)."""
    blocks = model.tree()["dec_blocks"]["cross_attn"]
    for i in range(cache["xk"].shape[0]):
        cache["xk"][i] = L._proj(enc_out, blocks["wk"][i]).to(cache["xk"].dtype)
        cache["xv"][i] = L._proj(enc_out, blocks["wv"][i]).to(cache["xv"].dtype)
    return cache


_ONE = {}


@torch.no_grad()
def one_device(arch: str, values):
    """One device's run at the carried weights: the prefill of each data
    shard (at 1 and 2 data ranks), and per decode kind its whole initial
    f32 cache, its tokens and positions, each step's logits and the final
    cache."""
    if arch not in _ONE:
        cfg = config(arch)
        one = build_steps(cfg, device="cpu")
        model = one.init_state(torch.Generator())["params"]
        model.load_state_dict(params_from_reference(nest(values[1][arch])))
        b = torch_batch(arch)
        out = {d: [one.prefill_step(model, {k: v[i * B // d:(i + 1) * B // d]
                                            for k, v in b.items()}).numpy()
                   for i in range(d)] for d in (1, 2)}
        dec, long = decode_tokens(arch)
        kinds = [("decode", dec, POSITIONS, N_SLOTS, False)]
        if long_ctx_case(arch):
            kinds.append(("long", long, list(range(long.shape[1])), N_LONG, True))
        out["decodes"] = []
        for name, toks, positions, n_slots, long_ctx in kinds:
            cache = {k: v.float() for k, v in one.init_cache(toks.shape[0], n_slots,
                                                             long_ctx).items()}
            if cfg.family == "encdec":
                fill_cross(model, cache, model.encode(b["frames"][:toks.shape[0]]))
            whole = {k: v.numpy().copy() for k, v in cache.items()}
            got = []
            for t, pos in enumerate(positions):
                lo, cache = one.decode_step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                                            torch.tensor(pos, dtype=torch.int32), long_ctx)
                got.append(lo.numpy())
            out["decodes"].append((name, whole, toks, positions, n_slots, long_ctx))
            out[name] = (got, {k: v.numpy() for k, v in cache.items()})
        _ONE[arch] = out
    return _ONE[arch]


_RUNS = {}


def _run(pool, values, key):
    if key not in _RUNS:
        arch, layout = CASES[key]
        got = pool.run("layout_family", layout, config(arch), nest(values[1][arch]),
                       torch_batch(arch), one_device(arch, values)["decodes"])
        n = layout[0] * layout[1]
        assert all(g is None for g in got[n:]) and all(g is not None for g in got[:n])
        _RUNS[key] = got[:n]
    return _RUNS[key]


def _close(got, want, what, rel=F32_REL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = float(np.max(np.abs(got - want), initial=0.0))
    scale = float(np.max(np.abs(want), initial=0.0))
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"


def _abstract_censuses(arch, layout):
    """The censuses of the prefill, a step of each decode, the gradients
    and a ``train_step`` at the same shapes on an abstract mesh."""
    from repro_torch.train.step import step_gradients

    cfg = config(arch)
    steps = build_steps(cfg, mesh=make_abstract_mesh(data=layout[0], model=layout[1]))
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in torch_batch(arch).items()}
    state = steps.init_state(torch.Generator())
    out = {}
    with collective_census() as c:
        steps.prefill_step(state["params"], meta)
    out["prefill"] = (c.bytes, c.counts)
    kinds = [("decode", B, N_SLOTS, False)] + ([("long", 1, N_LONG, True)]
                                               if long_ctx_case(arch) else [])
    for name, b, n, long_ctx in kinds:
        cache = {k: v.float() for k, v in steps.init_cache(b, n, long_ctx).items()}
        with collective_census() as c:
            steps.decode_step(state["params"], cache,
                              torch.empty((b, 1), dtype=torch.int32, device="meta"),
                              torch.zeros((), dtype=torch.int32, device="meta"), long_ctx)
        out[name] = (c.bytes, c.counts)
    with collective_census() as c:
        step_gradients(steps, state["params"], meta)
    out["grads"] = (c.bytes, c.counts)
    with collective_census() as c:
        steps.train_step(state, meta)
    out["train"] = (c.bytes, c.counts)
    return out


IDS = list(CASES)


@pytest.mark.parametrize("key", IDS)
def test_prefill_over_the_rules_layout_matches_one_device(pool, values, key):
    arch, layout = CASES[key]
    one = one_device(arch, values)[layout[0]]
    for r, g in enumerate(_run(pool, values, key)):
        _close(g["prefill"], one[r // layout[1]], f"{key} rank {r} prefill")


@pytest.mark.parametrize("key", IDS)
def test_decode_at_the_clamp_and_long_context_matches_one_device(pool, values, key):
    arch, layout = CASES[key]
    one = one_device(arch, values)
    names = [d[0] for d in one["decodes"]]
    assert names == (["decode", "long"] if long_ctx_case(arch) else ["decode"])
    for r, g in enumerate(_run(pool, values, key)):
        i = r // layout[1]
        n = g["rows"]
        steps = build_steps(config(arch), mesh=make_abstract_mesh(rank=r, data=layout[0],
                                                                  model=layout[1]))
        for name, _, toks, _, n_slots, long_ctx in one["decodes"]:
            want, want_cache = one[name]
            rows = slice(None) if long_ctx else slice(i * n, (i + 1) * n)
            for t, lo in enumerate(g[name]["logits"]):
                _close(lo, want[t][rows], f"{key} rank {r} {name} step {t}")
            _, specs = steps.cache_spec(toks.shape[0], n_slots, long_ctx)
            for k, block in g[name]["cache"].items():
                whole = want_cache[k]
                sh = named_sharding(steps.mesh, specs[k], steps.rules)
                _close(block, whole[sh.index(whole.shape)], f"{key} rank {r} {name} cache {k}")
                if sh.split and k in ("k", "h", "conv"):
                    assert block.shape != whole.shape, (key, k)  # the rank's block, not a copy


@pytest.mark.parametrize("key", IDS)
def test_gradients_over_the_rules_layout_match_jax_grad(pool, values, forced_reference, key):
    arch, _ = CASES[key]
    ref = _reference(forced_reference)
    want_loss = float(ref[f"{key}/loss"])
    for r, g in enumerate(_run(pool, values, key)):
        assert abs(g["loss"] - want_loss) <= METRIC_REL * abs(want_loss), (key, r, g["loss"])
        assert len(g["grads"]) == sum(k.startswith(f"{key}/grad") for k in ref)
        for j, (name, grad, index) in enumerate(g["grads"]):
            want = ref[f"{key}/grad{j}"]
            err = float(np.max(np.abs(grad - want[index]), initial=0.0))
            scale = float(np.max(np.abs(want), initial=0.0))
            assert np.all(np.isfinite(grad)) and err <= LEAF_REL * scale, (
                f"{key} rank {r} {name}: max |err| {err} > {LEAF_REL} x {scale}")
        names = [n for n, _, _ in g["grads"]]
        assert any(n.endswith(WHOLE_OVER_MODEL[arch]) for n in names), key
        if arch == "xlstm-125m":  # the gathered sLSTM weights: blocks of their gradients
            w = [(gr, ix) for n, gr, ix in g["grads"] if n.endswith("core.w_rec")]
            assert w and w[0][0].shape[1] < config(arch).d_model * 4, key


@pytest.mark.parametrize("key", IDS)
def test_censuses_equal_the_abstract_mesh(pool, values, key):
    arch, layout = CASES[key]
    want = _abstract_censuses(arch, layout)
    for r, g in enumerate(_run(pool, values, key)):
        assert g["prefill_census"] == want["prefill"], (key, r)
        for name in ("decode", "long"):
            if name in g:
                assert all(c == want[name] for c in g[name]["censuses"]), (key, r, name)
        assert g["grads_census"] == want["grads"], (key, r)
        assert g["train_census"] == want["train"], (key, r)
    ops = {op for by_op in want["prefill"][0].values() for op in by_op}
    assert {"all-gather", "all-reduce"} <= ops  # ZeRO-3 and fused-projection gathers, sums
    assert "model" in want["prefill"][0]


@pytest.mark.parametrize("key", IDS)
def test_bytes_equal_the_dry_run(pool, values, key):
    arch, layout = CASES[key]
    cfg = config(arch)
    mesh = f"data={layout[0]},model={layout[1]}"
    rec = dryrun.run_cell(arch, "train_4k", mesh, seq=S, batch=B, cfg=cfg)
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["rules_argument_bytes"]
    cells = {"decode": ("decode_32k", N_SLOTS, B), "long": ("long_500k", N_LONG, 1)}
    dec = {}
    for name, (shape, n_slots, b) in cells.items():
        if name == "long" and not long_ctx_case(arch):
            continue
        m = dryrun.run_cell(arch, shape, mesh, seq=n_slots, batch=b, cfg=cfg)["memory"]
        assert m["argument_bytes"] == m["rules_argument_bytes"], (key, shape)
        dec[name] = m["argument_bytes"]
    for r, g in enumerate(_run(pool, values, key)):
        assert g["state_bytes"] + batch_row_bytes(arch, layout) == mem["argument_bytes"], (key, r)
        for name, want in dec.items():
            params, cache, tokens = g[name]["bytes"]
            assert params + cache + tokens + 4 == want, (key, r, name)  # + the 0-d position
