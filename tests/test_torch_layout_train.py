"""The decoder-only families trained over a ``("data", "model")`` mesh of
gloo ranks on the CPU in the reference's rules layout, against the JAX
package's gradients on a forced 4-device host platform.

One pool of four ranks (tests/test_torch_ranks.py); the layouts ``(data,
model)`` are (2, 2) and (1, 2) (the pool's first two ranks). The configs
are ``reduced()`` (f32) at 2 layers; the initial parameters are the port's
seeded draw, whole, as numpy (tests/test_torch_train_ranks.py's
``initial_values``): the reference (a subprocess with
``--xla_force_host_platform_device_count=4``, started with the module's
first test) places them with its rules' shardings and takes ``jax.grad``
of its loss on the mesh; each rank takes its blocks.

* every parameter's gradient block after ``step_gradients`` within
  ``LEAF_REL`` (1e-4) of the largest value of the reference's gradient of
  the leaf, and the loss within ``METRIC_REL`` (1e-5). This holds the
  leaves the rules leave whole over ``model`` that the tensor-parallel
  layers read on every ``model`` rank for a part of their work -- ``wk`` /
  ``wv`` (``kv_heads`` unsplit: each rank reads the kv heads of its query
  heads), the norms, MLA's ``wkv_a`` / ``kv_norm`` and the router -- whose
  gradient must be neither counted twice nor halved;
* each rank's state and batch bytes equal to the dry run's
  ``argument_bytes`` of the ``train_4k`` cell at the same shapes and mesh,
  which equal its ``rules_argument_bytes``;
* a checkpoint written on (2, 2) (tinyllama, after a step) restored onto
  one device and onto ``plan_remesh(2)``'s (1, 2): every leaf bit-equal to
  the matching block of the saved state.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves, module_tree  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402
from test_torch_train_ranks import LEAF_REL, METRIC_REL, flat, nest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S = 4, 32
GRAD_CASES = {
    "tinyllama-1.1b-2x2": ("tinyllama-1.1b", (2, 2)),
    "phi-3-vision-4.2b-1x2": ("phi-3-vision-4.2b", (1, 2)),
    "qwen2-moe-a2.7b-2x2": ("qwen2-moe-a2.7b", (2, 2)),
    "deepseek-v3-671b-2x2": ("deepseek-v3-671b", (2, 2)),
}
CKPT_ARCH = "tinyllama-1.1b"


def config(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=2)


def initial_values(arch: str):
    """The port's whole draw of ``config(arch)``'s parameters from seed 0,
    as the reference's flat names to numpy."""
    steps = build_steps(config(arch), device="cpu")
    model = steps.init_state(torch.Generator().manual_seed(0))["params"]
    return {k: v.detach().numpy().copy() for k, v in flat(module_tree(model)).items()}


def batch(arch: str):
    """The training batch of the batch spec's shapes, seeded numpy; the
    patches (bf16 in the spec) as f32 of bf16 values."""
    cfg = config(arch)
    rng = np.random.default_rng(13)
    sds, _ = build_steps(cfg, device="meta").batch_spec("train", S, B)
    out = {}
    for k, s in sds.items():
        if s.dtype == torch.int32:
            out[k] = rng.integers(0, cfg.vocab, s.shape).astype(np.int32)
        else:
            x = torch.from_numpy(rng.standard_normal(s.shape).astype(np.float32))
            out[k] = x.to(s.dtype).float().numpy()
    return out


def _torch_batch(arch: str):
    """``batch`` as the ranks take it: each entry in its spec's dtype."""
    sds, _ = build_steps(config(arch), device="meta").batch_spec("train", S, B)
    return {k: torch.from_numpy(v).to(sds[k].dtype) for k, v in batch(arch).items()}


_FORCED = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from test_torch_layout_train import B, GRAD_CASES, S, batch, config
from test_torch_train_ranks import nest
from repro.train.step import build_steps

assert len(jax.devices()) == 4, jax.devices()
src, dst = sys.argv[1], sys.argv[2]
out = {}
for key, (arch, (d, m)) in GRAD_CASES.items():
    cfg = config(arch)
    mesh = Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))
    steps = build_steps(cfg, mesh)
    with np.load(f"{src}/{arch}.npz") as z:
        params = nest({k: jnp.asarray(z[k]) for k in z.files})
    params = jax.device_put(params, steps.shardings(steps.param_specs))
    b = {k: jnp.asarray(v, jnp.bfloat16 if v.dtype == np.float32 else v.dtype)
         for k, v in batch(arch).items()}
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
    for arch in dict.fromkeys(a for a, _ in GRAD_CASES.values()):
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


_GRADS = {}


def _grads(pool, values, key):
    if key not in _GRADS:
        arch, layout = GRAD_CASES[key]
        got = pool.run("layout_grads", layout, config(arch), nest(values[1][arch]),
                       _torch_batch(arch))
        n = layout[0] * layout[1]
        assert all(g is None for g in got[n:])
        _GRADS[key] = got[:n]
    return _GRADS[key]


@pytest.mark.parametrize("key", list(GRAD_CASES))
def test_gradients_over_the_rules_layout_match_jax_grad(pool, values, forced_reference, key):
    ref = _reference(forced_reference)
    want_loss = float(ref[f"{key}/loss"])
    for r, (loss, grads, _) in enumerate(_grads(pool, values, key)):
        assert abs(loss - want_loss) <= METRIC_REL * abs(want_loss), (key, r, loss, want_loss)
        assert len(grads) == sum(k.startswith(f"{key}/grad") for k in ref)
        for j, (name, g, index) in enumerate(grads):
            want = ref[f"{key}/grad{j}"]
            err = float(np.max(np.abs(g - want[index]), initial=0.0))
            scale = float(np.max(np.abs(want), initial=0.0))
            assert np.all(np.isfinite(g)) and err <= LEAF_REL * scale, (
                f"{key} rank {r} {name}: max |err| {err} > {LEAF_REL} x {scale}")
    # among them a leaf whole over model that each model rank reads in part
    assert any(n.endswith(("attn.wk", "attn.wkv_a")) for n, _, _ in grads), key


@pytest.mark.parametrize("key", list(GRAD_CASES))
def test_state_bytes_equal_the_dry_run(pool, values, key):
    arch, layout = GRAD_CASES[key]
    rec = dryrun.run_cell(arch, "train_4k", f"data={layout[0]},model={layout[1]}", seq=S,
                          batch=B, cfg=config(arch))
    mem = rec["memory"]
    assert mem["argument_bytes"] == mem["rules_argument_bytes"]
    for r, (_, _, nbytes) in enumerate(_grads(pool, values, key)):
        assert nbytes == mem["argument_bytes"], (key, r, nbytes, mem["argument_bytes"])


@pytest.fixture(scope="module")
def saved(pool, tmp_path_factory):
    """A (2, 2) tinyllama run's checkpoint after one step, the blocks it
    saved and the whole state they make."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = config(CKPT_ARCH)
    b = {k: v for k, v in batch(CKPT_ARCH).items()}
    got = pool.run("ckpt_save", (2, 2), cfg, nest(initial_values(CKPT_ARCH)), [b], str(d))
    whole = []
    for j, (name, block, _) in enumerate(got[0]):
        shape = tuple(max(r[j][2][k].stop for r in got) for k in range(block.ndim))
        w = np.empty(shape, block.dtype)
        for r in got:
            w[r[j][2]] = r[j][1]
        whole.append((name, w))
    return d, got, whole


@pytest.mark.parametrize("onto", ["one device", "1x2"])
def test_checkpoint_of_2x2_restores_onto_a_smaller_mesh(pool, saved, onto):
    d, got, whole = saved
    cfg = config(CKPT_ARCH)
    # the (2, 2) state had leaves split over both axes
    assert any(all(s.stop - s.start < n for s, n in zip(index, w.shape))
               for (_, w), (_, _, index) in zip(whole, got[3]))
    if onto == "one device":
        one = build_steps(cfg, device="cpu")
        state, step = restore(str(d), one.init_state(torch.Generator()))
        assert step == 1
        for (name, w), x in zip(whole, leaves(state)):
            assert np.array_equal(x.detach().numpy(), w), name
        return
    res = pool.run("ckpt_restore_remeshed", 2, cfg, str(d), batch(CKPT_ARCH))
    assert res[2] is None and res[3] is None
    for r in (0, 1):
        shape, step, restored, _, _ = res[r]
        assert shape == (1, 2) and step == 1
        for (name, w), (_, block, index) in zip(whole, restored):
            assert np.array_equal(block, w[index]), (r, name)
