"""Checkpoints and the training loop over a ``("data", "model")`` mesh of
gloo ranks on the CPU (tests/test_torch_ranks.py, a group of 4).

* a checkpoint written on ``(2, 2)`` (deepseek-v3 at ``reduced()``, f32,
  Adafactor, after a step: its factors are blocks too) holds whole leaves;
  restored on ``(1, 2)`` -- ``plan_remesh(2).make_mesh()`` over the first
  two ranks, the others dropped -- and on one device, every leaf is
  bit-equal to the matching block of the saved state; the restored ranks
  then take one more step, within tests/test_torch_train_ranks.py's bounds
  of one device's step from the restored state;
* ``train(cfg, tc, mesh=...)`` on ``(2, 2)`` interrupted by a checkpoint
  and restarted continues with the uninterrupted run's losses bit for bit;
* ``train(mesh=...)`` with ``grad_compression="topk"`` and ``"int8"``
  (qwen2-moe at ``reduced()``, whose expert stacks are blocks) gives the
  reference's ``train(mesh=...)`` losses within 1e-5 (the reference on a
  forced 4-device host platform, in a subprocess started with the
  module's first test, from the port's initial parameters), at the token
  stream of seed 1;
* at seed 0 the third step's batch repeats a token at the start of a row
  (tokens 16 and 17 of data shard 0 hold the same state, so their gates
  tie exactly), and an expert's capacity binds at that tie: the loop over
  ranks equals one device's port stepping each data shard's rows alone
  (the reference's one-device order, the lower token first), within 1e-5.
  The reference's own sharded run breaks that tie the other way (its
  ``(1, 2)`` loss on shard 0's rows 6.241887 against its one-device
  6.215463; equal within 2e-7 once the repeated token is changed), so the
  comparison with the reference runs at a stream where its sharded and
  one-device runs agree.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.ckpt.checkpoint import latest_step, restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402
from test_torch_train_ranks import (LEAF_REL, METRIC_REL, PARAM_LR_FRAC, batches,  # noqa: E402
                                    initial_values, nest)

ROOT = Path(__file__).resolve().parents[1]
CKPT_ARCH = "deepseek-v3-671b"
LOOP_ARCH = "qwen2-moe-a2.7b"
LOOP = dict(n_steps=3, batch=4, seq=16, log_every=0)
REF_SEED = 1  # the stream the reference's compressed loops run at (see the module)

_FORCED = r"""
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.train.loop import TrainConfig, train
from repro.train.step import build_steps
from test_torch_ckpt_ranks import LOOP, LOOP_ARCH, REF_SEED
from test_torch_train_ranks import nest

assert len(jax.devices()) == 4, jax.devices()
src, dst = sys.argv[1], sys.argv[2]
cfg = get_config(LOOP_ARCH).reduced()
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
steps = build_steps(cfg, mesh)
with np.load(src) as z:
    values = nest({k: jnp.asarray(z[k]) for k in z.files})


def init(key, _init=steps.init_state):
    state = _init(key)
    state["params"] = values
    return state


steps = dataclasses.replace(steps, init_state=init)
out = {}
for comp in ("topk", "int8"):
    r = train(cfg, TrainConfig(grad_compression=comp, seed=REF_SEED, **LOOP), mesh=mesh,
              steps=steps)
    out[comp] = np.array(r.losses)
np.savez(dst, **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forced_reference(tmp_path_factory):
    """The reference's compressed ``train(mesh=...)`` from the port's
    initial parameters, in a subprocess started with the module's first
    test."""
    d = tmp_path_factory.mktemp("forced")
    np.savez(d / "values.npz", **initial_values(LOOP_ARCH, REF_SEED))
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _FORCED, str(d / "values.npz"),
                             str(d / "ref.npz")], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, d / "ref.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    made = RankPool(4, f"file://{d}/world4")
    yield made
    made.close()


@pytest.fixture(scope="module")
def saved(pool, tmp_path_factory):
    """The (2, 2) run's checkpoint directory, the blocks it saved and the
    whole state they make."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = get_config(CKPT_ARCH).reduced()
    got = pool.run("ckpt_save", (2, 2), cfg, nest(initial_values(CKPT_ARCH)),
                   batches(cfg.vocab)[:1], str(d))
    whole = []
    for j, (name, block, _) in enumerate(got[0]):
        shape = tuple(max(r[j][2][k].stop for r in got) for k in range(block.ndim))
        w = np.empty(shape, block.dtype)
        for r in got:
            w[r[j][2]] = r[j][1]
        whole.append((name, w))
    return d, got, whole


def test_checkpoint_from_four_ranks_holds_whole_leaves(saved):
    d, got, whole = saved
    assert latest_step(str(d)) == 1
    cfg = get_config(CKPT_ARCH).reduced()
    one = build_steps(cfg, device="cpu")
    state, step = restore(str(d), one.init_state(torch.Generator()))
    assert step == 1
    for (name, w), x in zip(whole, leaves(state)):
        assert np.array_equal(x.detach().numpy(), w), name
    # the expert stacks and their Adafactor factors were blocks on the ranks
    split = [name for j, (name, block, _) in enumerate(got[0])
             if any(r[j][2] != got[0][j][2] for r in got)]
    assert any("moe.w_gate" in n for n in split) and any(n.startswith("opt.vr") for n in split)


def test_restore_onto_a_smaller_mesh_and_step_on(pool, saved):
    d, _, whole = saved
    cfg = get_config(CKPT_ARCH).reduced()
    batch = batches(cfg.vocab)[1]
    got = pool.run("ckpt_restore_remeshed", 2, cfg, str(d), batch)
    assert got[2] is None and got[3] is None  # ranks the plan dropped
    # one device from the same checkpoint, one step further
    one = build_steps(cfg, device="cpu")
    state, _ = restore(str(d), one.init_state(torch.Generator()))
    state, m = one.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    stepped = [x.detach().numpy() for x in leaves(state)]
    lr = float(m["lr"])
    for r in (0, 1):
        shape, step, restored, metrics, after = got[r]
        assert shape == (1, 2) and step == 1
        for (name, w), (_, block, index) in zip(whole, restored):
            assert np.array_equal(block, w[index]), (r, name)
        assert abs(metrics[0] - float(m["loss"])) <= METRIC_REL * abs(float(m["loss"]))
        assert abs(metrics[1] - float(m["grad_norm"])) <= METRIC_REL * float(m["grad_norm"])
        for (name, block, index), want in zip(after, stepped):
            err = float(np.max(np.abs(block - want[index]), initial=0.0))
            bound = max(LEAF_REL * float(np.max(np.abs(want), initial=0.0)),
                        PARAM_LR_FRAC * lr if name.startswith("params.") else 0.0)
            assert err <= bound, (r, name, err, bound)


def test_every_rank_submits_more_saves_than_the_queue_holds(pool, tmp_path):
    """Ranks other than 0 write nothing and queue nothing: three submits
    (the queue holds two) return on every rank, and rank 0 writes each."""
    cfg = get_config(CKPT_ARCH).reduced()
    d = str(tmp_path / "ckpt")
    assert pool.run("ckpt_submits", (2, 2), cfg, d, 3) == [0, 1, 2, 3]
    assert sorted(p.name for p in Path(d).iterdir()) == ["step_1", "step_2", "step_3"]
    one = build_steps(cfg, device="cpu")
    state = one.init_state(torch.Generator().manual_seed(0))
    got, step = restore(d, one.init_state(torch.Generator()))
    assert step == 3
    for x, y in zip(leaves(got), leaves(state)):
        assert np.array_equal(x.detach().numpy(), y.detach().numpy())


def test_restart_on_the_same_mesh_continues_bit_for_bit(pool, tmp_path):
    cfg = get_config(LOOP_ARCH).reduced()
    whole = pool.run("lm_loop", (2, 2), cfg, dict(LOOP, n_steps=4))
    d = str(tmp_path / "ckpt")
    first = pool.run("lm_loop", (2, 2), cfg, dict(LOOP, n_steps=2, ckpt_dir=d, ckpt_every=1))
    second = pool.run("lm_loop", (2, 2), cfg, dict(LOOP, n_steps=4, ckpt_dir=d, ckpt_every=1))
    for r in range(4):
        assert first[r][1] is None and second[r][1] == 2
        assert first[r][0] + second[r][0] == whole[r][0], (r, first[r][0], second[r][0])
        assert whole[r][0] == whole[0][0]  # the same loss on every rank
        assert len(whole[r][2]) == 4 and whole[r][2] == whole[0][2]  # the slowest rank's


@pytest.mark.parametrize("comp", ["topk", "int8"])
def test_compressed_loop_over_ranks_matches_reference(pool, forced_reference, comp):
    cfg = get_config(LOOP_ARCH).reduced()
    got = pool.run("lm_loop", (2, 2), cfg, dict(LOOP, grad_compression=comp, seed=REF_SEED))
    proc, out = forced_reference
    if proc.returncode is None:
        _, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-4000:]
    assert proc.returncode == 0
    want = np.load(out)[comp]
    for r, (losses, _, _) in enumerate(got):
        assert len(losses) == len(want)
        assert np.all(np.abs(np.array(losses) - want) <= METRIC_REL * np.abs(want)), (
            r, losses, want)


def test_loop_over_ranks_breaks_capacity_ties_as_one_device(pool):
    """Seed 0's third batch binds a capacity at an exact gate tie (see the
    module): the loop over ``(2, 2)`` equals one device's port stepping
    each data shard's rows alone, their gradients averaged (the smoke's
    ``shard_step``)."""
    from repro_torch.data.tokens import TokenPipeline

    cfg = get_config(LOOP_ARCH).reduced()
    got = pool.run("lm_loop", (2, 2), cfg, LOOP)
    one = build_steps(cfg, device="cpu")
    state = one.init_state(torch.Generator().manual_seed(0))
    pipe = TokenPipeline(cfg.vocab, LOOP["seq"], LOOP["batch"], seed=0)
    want = [_chip_smoke().shard_step(one, state, pipe.next_batch(cfg, "cpu"), 2, False)[0]
            for _ in range(LOOP["n_steps"])]
    for r, (losses, _, _) in enumerate(got):
        assert np.all(np.abs(np.array(losses) - want) <= METRIC_REL * np.abs(want)), (
            r, losses, want)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke
