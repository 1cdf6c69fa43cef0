"""The rest of the port's training loop against the JAX package on the
CPU: the token pipeline, checkpoints, straggler detection, elastic
re-meshing and ``train`` itself.

- ``TokenPipeline`` batches (dense and vlm, with ``skip_to``; enc-dec's
  frames): bit for bit.
- ``StragglerMonitor``, ``plan_remesh``, ``data_skip_offset``: equal
  outputs on the reference tests' cases.
- A checkpoint written by the reference restores in the port, and one
  written by the port restores in the reference, a bf16 leaf included: bit
  for bit, in each side's dtypes.
- The port's ``train`` against the reference's, loss for loss over 6 steps
  at B = 2, S = 32 from the reference's initial state carried across:
  within ``1e-5`` relative (measured up to 2.9e-7), also over 3 steps with
  each gradient compression (top-k with error feedback, the int8 round
  trip).
- A restart (6 steps with saves every 3, then ``n_steps=8``) gives
  ``restored_from == 6``, and the same 2 losses and final state as 8
  uninterrupted steps: bit for bit.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as JK  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.resilience.elastic import data_skip_offset as jdata_skip_offset  # noqa: E402
from repro.resilience.elastic import plan_remesh as jplan_remesh  # noqa: E402
from repro.resilience.straggler import StragglerConfig as JStragglerConfig  # noqa: E402
from repro.resilience.straggler import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro.train.loop import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.loop import train as jtrain  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.ckpt import checkpoint as K  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.resilience.elastic import RemeshPlan, data_skip_offset, plan_remesh  # noqa: E402
from repro_torch.resilience.straggler import (MitigationPlan, StragglerConfig,  # noqa: E402
                                              StragglerMonitor)
from repro_torch.train.loop import TrainConfig, train  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

LOSS_REL = 1e-5
ARCH = "tinyllama-1.1b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: the reduced models' ops are
    small, and the suite's parallel workers would otherwise oversubscribe
    the cores (each torch op spinning up a full thread team)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().reshape(-1)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    a = np.asarray(x).reshape(-1)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a.view(f"u{a.itemsize}")


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


# ---------------------------------------------------------- the pipeline
@pytest.mark.parametrize("arch", [ARCH, "phi-3-vision-4.2b"])
def test_token_pipeline_bit_for_bit_with_skip(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    for seq in (16, 96):
        pipe, jpipe = TokenPipeline(cfg.vocab, seq, 3, seed=7), JTokenPipeline(cfg.vocab, seq, 3, 7)
        for _ in range(3):
            b, jb = pipe.next_batch(cfg, "cpu"), jpipe.next_batch(jcfg)
            assert sorted(b) == sorted(jb)
            for k in jb:
                assert b[k].dtype == {"tokens": torch.int32, "patches": torch.float32}[k]
                np.testing.assert_array_equal(_bits(b[k]), _bits(jb[k]))
        skipped = TokenPipeline(cfg.vocab, seq, 3, seed=7)
        skipped.skip_to(3)
        jb = jpipe.next_batch(jcfg)
        for k, v in skipped.next_batch(cfg, "cpu").items():
            np.testing.assert_array_equal(_bits(v), _bits(jb[k]))


def test_token_pipeline_device_rule(monkeypatch):
    cfg = get_config(ARCH).reduced()
    # the enc-dec family's frames (f32, at least 8 of them) are the reference's
    wcfg, jwcfg = get_config("whisper-base").reduced(), jget_config("whisper-base").reduced()
    b, jb = TokenPipeline(64, 16, 2).next_batch(wcfg, "cpu"), JTokenPipeline(64, 16, 2).next_batch(
        jwcfg)
    assert sorted(b) == sorted(jb) == ["frames", "tokens"]
    assert b["frames"].dtype == torch.float32 and b["frames"].shape == (2, 8, wcfg.d_model)
    for k in jb:
        np.testing.assert_array_equal(_bits(b[k]), _bits(jb[k]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(cfg.vocab, 16, 2).next_batch(cfg)


# ------------------------------------------------------------ resilience
def test_straggler_monitor_equals_reference():
    cases = [(4, dict(min_steps=4, patience=2), lambda s, r: [0.1, 0.1, 0.5 if s >= 10 else 0.1,
                                                             0.1]),
             (4, {}, lambda s, r: 0.1 + r.normal(0, 0.001, 4)),
             (3, dict(k_sigma=1.0, patience=1, min_steps=2), lambda s, r: r.gamma(2.0, 0.05, 3))]
    for n, kw, times in cases:
        mon = StragglerMonitor(n, StragglerConfig(**kw) if kw else None)
        jmon = JStragglerMonitor(n, JStragglerConfig(**kw) if kw else None)
        r = np.random.default_rng(0)
        for step in range(40):
            t = np.asarray(times(step, r), dtype=float)
            assert mon.observe(t) == jmon.observe(t)
            assert mon.fleet_step_time() == jmon.fleet_step_time()
    assert MitigationPlan.decide([2], async_dp=True) == MitigationPlan([2], "drop_stale")
    assert MitigationPlan.decide([], async_dp=False).action == "none"


@pytest.mark.parametrize("n", [512, 256, 96, 24, 3, 1, 17])
def test_plan_remesh_equals_reference(n):
    plan, jplan = plan_remesh(n), jplan_remesh(n)
    assert (plan.shape, plan.axes, plan.dropped_devices) == (
        jplan.shape, jplan.axes, jplan.dropped_devices)
    assert data_skip_offset(n, 256) == jdata_skip_offset(n, 256)


def test_remesh_plan_makes_the_ports_host_mesh():
    mesh = RemeshPlan(shape=(1, 1), axes=("data", "model"), dropped_devices=0).make_mesh("cpu")
    assert mesh.axis_names == ("data", "model") and mesh.rank == 0


# ----------------------------------------------------------- checkpoints
def _jstate(optimizer="adamw"):
    """A reduced bf16 training state of the reference, one step in."""
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype="bfloat16",
                               optimizer=optimizer)
    jsteps = jbuild_steps(jcfg)
    state = jax.jit(jsteps.init_state)(jax.random.PRNGKey(2))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    state, _ = jax.jit(jsteps.train_step)(state, dict(tokens=jnp.asarray(toks)))
    return state


def _port_template(seed=5):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    return build_steps(cfg, device="cpu").init_state(torch.Generator().manual_seed(seed))


def test_checkpoints_cross_restore_bit_for_bit(tmp_path):
    jstate = _jstate()
    JK.save(str(tmp_path / "ref"), 7, jstate)
    got, step = K.restore(str(tmp_path / "ref"), _port_template())
    assert step == 7
    jl, tl = jax.tree.leaves(jstate), leaves(got)
    assert len(jl) == len(tl) and any(x.dtype == jnp.bfloat16 for x in jl)
    for a, b in zip(tl, jl):
        assert _dtype_name(a) == str(b.dtype) and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["params"].dense_blocks.attn.wq.requires_grad  # loaded in place

    # and back: the port's state written, the reference restores it
    state = _port_template(seed=9)
    K.save(str(tmp_path / "port"), 11, state)
    manifest = json.loads((tmp_path / "port" / "step_11" / "manifest.json").read_text())
    assert {x["dtype"] for x in manifest["leaves"]} == {"bfloat16", "float32", "int32"}
    back, jstep = JK.restore(str(tmp_path / "port"), jstate)
    assert jstep == 11
    for a, b in zip(jax.tree.leaves(back), leaves(state)):
        assert str(a.dtype) == _dtype_name(b)
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_checkpoint_gc_latest_and_async(tmp_path):
    for s in [1, 2, 3, 4, 5]:
        K.save(str(tmp_path / "gc"), s, {"a": torch.zeros(4)}, keep_n=2)
    assert K.latest_step(str(tmp_path / "gc")) == 5
    kept = sorted(int(p.name.split("_")[1]) for p in (tmp_path / "gc").glob("step_*"))
    assert kept == [4, 5] and K.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        K.restore(str(tmp_path / "none"), {"w": torch.zeros(4)})

    # submit copies to the host before returning: a later in-place update
    # of the tensor does not reach the pending save
    ck = K.AsyncCheckpointer(str(tmp_path / "async"))
    w = torch.full((4,), 10.0)
    ck.submit(10, {"w": w})
    w.add_(5.0)
    ck.submit(20, {"w": w})
    w.add_(5.0)
    ck.close()
    for step, val in ((10, 10.0), (20, 15.0)):
        got, s = K.restore(str(tmp_path / "async"), {"w": torch.zeros(4)}, step=step)
        assert s == step and torch.equal(got["w"], torch.full((4,), val))
    with pytest.raises(ValueError, match="leaves"):
        K.restore(str(tmp_path / "async"), {"w": torch.zeros(4), "x": torch.zeros(1)})


# ----------------------------------------------------------------- train
def _carried_steps(cfg, jstate):
    """Port steps whose ``init_state`` returns the reference's initial
    state carried across."""
    steps = build_steps(cfg, device="cpu")

    def init_state(gen):
        state = steps.init_state(gen)
        state["params"].load_state_dict(params_from_reference(
            jax.tree.map(np.asarray, jstate["params"])))
        return state

    return dataclasses.replace(steps, init_state=init_state)


@pytest.mark.parametrize("compression", [None, "topk", "int8"])
def test_train_matches_reference_loss_for_loss(compression):
    cfg, jcfg = get_config(ARCH).reduced(), jget_config(ARCH).reduced()
    n = 6 if compression is None else 3
    kw = dict(n_steps=n, batch=2, seq=32, log_every=0, grad_compression=compression)
    jres = jtrain(jcfg, JTrainConfig(**kw))
    jstate = jax.jit(jbuild_steps(jcfg).init_state)(jax.random.PRNGKey(0))  # jtrain's own
    res = train(cfg, TrainConfig(**kw), steps=_carried_steps(cfg, jstate))
    assert res.restored_from is None and res.final_step == n and len(res.step_times) == n
    assert len(res.losses) == len(jres.losses) == n
    for got, want in zip(res.losses, jres.losses):
        assert abs(got - want) <= LOSS_REL * abs(want)


def test_restart_resumes_bit_for_bit(tmp_path):
    cfg = get_config(ARCH).reduced()
    kw = dict(batch=2, seq=32, ckpt_every=3, log_every=0)
    whole = build_steps(cfg, device="cpu")
    final = {}

    def keep_state(steps):
        def train_step(state, batch):
            state, m = steps.train_step(state, batch)
            final[id(steps)] = state
            return state, m
        return dataclasses.replace(steps, train_step=train_step)

    ref = train(cfg, TrainConfig(n_steps=8, **kw), steps=keep_state(whole))
    r1 = train(cfg, TrainConfig(n_steps=6, ckpt_dir=str(tmp_path), **kw), device="cpu")
    assert r1.restored_from is None and len(r1.losses) == 6
    assert r1.losses == ref.losses[:6]
    resumed = build_steps(cfg, device="cpu")
    r2 = train(cfg, TrainConfig(n_steps=8, ckpt_dir=str(tmp_path), **kw),
               steps=keep_state(resumed))
    assert r2.restored_from == 6 and r2.final_step == 8
    assert r2.losses == ref.losses[6:]
    a, b = final[id(resumed)], final[id(whole)]
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
    assert K.latest_step(str(tmp_path)) == 8
