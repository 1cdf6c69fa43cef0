"""The port's expert-parallel MoE (``moe_ffn_sharded``, ``moe_ffn(...,
mesh)``) over gloo ranks on the CPU, against the JAX package's
``moe_ffn_sharded`` on a forced 4-device host platform.

Ranks are processes (tests/test_torch_ranks.py) in gloo groups of 2 and 4;
the layouts ``(data, model)`` are (1, 2) and (2, 2). Every input is seeded
numpy (``moe_case``): the same ``x`` and weights go to the reference (a
subprocess with ``--xla_force_host_platform_device_count=4``, started with
the module's first test) and to the ranks, which take their blocks (``x``'s
rows over ``data``, the expert stacks' experts over ``model`` and ``d`` over
``data``). Tolerances, of the output's largest magnitude (the bounds of
tests/test_torch_moe.py): ``MATMUL_REL``, 1e-4 in f32 (XLA's and PyTorch's
f32 products round differently); ``BF16_REL``, 5e-2 in bf16 (the
reference's bf16 test bound; the experts' bf16 sums, a rank's first and
then over ``model``, round in another order than one device's).

* qwen2-moe, deepseek-v3 and jamba at ``reduced()`` (f32), each layout,
  and qwen2-moe in bf16 at (2, 2): every rank's rows equal the
  reference's rows of its data shard;
* at (2, 2), a batch whose rows repeat one token, so that an expert's
  capacity binds in each data shard: the port equals the reference's
  sharded output and differs from ``moe_ffn_dense`` over the whole batch
  (the capacity comes from the data shard's ``t_loc`` tokens);
* the census of an abstract mesh (``make_abstract_mesh``, meta tensors)
  equals the gloo run's census integer for integer, for the layer and for
  a prefill and a decode step;
* ``prefill_step`` and ``decode_step`` of qwen2-moe over (1, 2) and (2, 2)
  equal the single-rank port's: prefill on each data shard's rows alone
  (the same ``t_loc``), decode on the whole batch (decode's MoE is
  ``moe_ffn_dense``, whose capacity counts the whole batch; the experts'
  ``d`` stays split over the data ranks, which ``(2, 2)`` runs).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import collective_census, make_abstract_mesh  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.sharding.rules import shard_tensor  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MATMUL_REL = 1e-4
BF16_REL = 5e-2
ARCHS = ("qwen2-moe-a2.7b", "deepseek-v3-671b", "jamba-v0.1-52b")
LAYOUTS = [(1, 2), (2, 2)]
SHAPE = (4, 8)  # (B, S) of the layer cases
BIND = ("qwen2-moe-a2.7b", (4, 32))  # the binding case: arch, (B, S)
LM_SHAPE = (4, 16, 2)  # prefill (B, S), then decode steps
EXPERT_NAMES = dict(w_gate=("experts", "wembed", "expert_mlp"),
                    w_up=("experts", "wembed", "expert_mlp"),
                    w_down=("experts", "expert_mlp", "wembed"))


def moe_case(arch: str, seed: int, B: int, S: int, bind: bool = False):
    """``(params, x)``: numpy f32 MoE weights of ``arch``'s ``reduced()``
    config (the padded experts, the shared experts where it has them) and
    an input batch; with ``bind``, the first three quarters of every row
    are one token, whose experts then take more tokens than their
    capacity."""
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_expert or cfg.d_ff, MOE.n_experts_padded(cfg)

    def w(shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)

    params = dict(w_router=w((d, E)), w_gate=w((E, d, f)), w_up=w((E, d, f)),
                  w_down=w((E, f, d)))
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        params["shared"] = dict(w_gate=w((d, fs)), w_up=w((d, fs)), w_down=w((fs, d)))
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    if bind:
        x[:, : 3 * S // 4] = x[0, 0]
    return params, x


def _cases():
    """Case name -> (arch, layout, (B, S), bind, dtype)."""
    out = {f"{a}-{d}x{m}": (a, (d, m), SHAPE, False, "float32") for a in ARCHS
           for d, m in LAYOUTS}
    out["bind-2x2"] = (BIND[0], (2, 2), BIND[1], True, "float32")
    out["bf16-2x2"] = (BIND[0], (2, 2), SHAPE, False, "bfloat16")
    return out


CASES = _cases()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    made = {w: RankPool(w, f"file://{d}/world{w}") for w in (2, 4)}
    yield made
    for p in made.values():
        p.close()


def _pool(pools, layout):
    return pools[layout[0] * layout[1]]


_FORCED = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_config
from repro.models.moe import moe_ffn_sharded
from repro.sharding.rules import default_rules
from test_torch_moe_sharded import CASES, moe_case

assert len(jax.devices()) == 4, jax.devices()
out = {}
for key, (arch, (d, m), (B, S), bind, dtype) in CASES.items():
    params, x = moe_case(arch, 0, B, S, bind)
    dt = getattr(jnp, dtype)
    params = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
    params["w_router"] = params["w_router"].astype(jnp.float32)
    mesh = Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))
    y = moe_ffn_sharded(params, jnp.asarray(x, dt), get_config(arch).reduced(),
                        default_rules(mesh), mesh)
    out[key] = np.asarray(y.astype(jnp.float32))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def forced_reference(tmp_path_factory):
    """The reference's ``moe_ffn_sharded`` on a forced 4-device host
    platform for every case, in a subprocess started with the module's
    first test."""
    out = tmp_path_factory.mktemp("forced") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"{env.get('XLA_FLAGS', '')} --xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                         env.get("PYTHONPATH", "")])
    proc = subprocess.Popen([sys.executable, "-c", _FORCED, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _reference(forced, key):
    proc, out = forced
    if proc.returncode is None:
        try:
            _, err = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, err[-4000:]
    assert proc.returncode == 0
    return np.load(out)[key]


def _close(got, want, what, rel=MATMUL_REL):
    assert got.shape == want.shape, what
    assert np.all(np.isfinite(got)), what
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= rel * scale, f"{what}: max |err| {err} > {rel} x {scale}"
    return err


def _rows(full, layout, rank):
    """Rank ``rank``'s rows of a whole batch on a ``(data, model)`` layout."""
    d, m = layout
    n = full.shape[0] // d
    i = rank // m
    return full[i * n:(i + 1) * n]


def _run_layer(pools, key):
    arch, layout, (B, S), bind, dtype = CASES[key]
    params, x = moe_case(arch, 0, B, S, bind)
    cfg = get_config(arch).reduced()
    return cfg, params, x, _pool(pools, layout).run("moe_layer", layout, cfg, params, x, dtype)


def _abstract_layer_census(cfg, params, x, layout):
    """The census of ``moe_ffn`` at the same shapes on an abstract mesh."""
    mesh = make_abstract_mesh(data=layout[0], model=layout[1])
    meta = lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta")  # noqa: E731
    p = {k: ({n: meta(a) for n, a in v.items()} if isinstance(v, dict) else meta(v))
         for k, v in params.items()}
    if MOE.ep_sharded(cfg, mesh):
        p.update({k: shard_tensor(p[k], n, mesh) for k, n in EXPERT_NAMES.items()})
    with torch.no_grad(), collective_census() as census:
        MOE.moe_ffn(p, shard_tensor(meta(x), ("batch", None, None), mesh), cfg, mesh)
    return census


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_moe_ffn_sharded_matches_reference(pools, forced_reference, arch, layout):
    key = f"{arch}-{layout[0]}x{layout[1]}"
    cfg, params, x, got = _run_layer(pools, key)
    assert MOE.ep_sharded(cfg, make_abstract_mesh(data=layout[0], model=layout[1]))
    want = _reference(forced_reference, key)
    for r, (y, _, _) in enumerate(got):
        _close(y, _rows(want, layout, r), f"{key} rank {r}")


def test_moe_ffn_sharded_matches_reference_in_bf16(pools, forced_reference):
    cfg, params, x, got = _run_layer(pools, "bf16-2x2")
    want = _reference(forced_reference, "bf16-2x2")
    for r, (y, _, _) in enumerate(got):
        _close(y, _rows(want, (2, 2), r), f"bf16 rank {r}", BF16_REL)


def test_capacity_binds_in_each_data_shard(pools, forced_reference):
    """At (2, 2) a repeated token fills its experts past their capacity in
    each data shard: the port equals the reference's sharded output, and
    ``moe_ffn_dense`` over the whole batch (capacity from every token)
    differs from both."""
    cfg, params, x, got = _run_layer(pools, "bind-2x2")
    layout = CASES["bind-2x2"][1]
    want = _reference(forced_reference, "bind-2x2")
    t = torch.from_numpy
    B, S, d = x.shape
    t_loc = B * S // layout[0]
    cap = MOE._capacity(t_loc, cfg, cfg.n_experts)
    for i in range(layout[0]):
        shard = t(x[i * B // layout[0]:(i + 1) * B // layout[0]]).reshape(-1, d)
        _, top_idx = MOE._route(shard, t(params["w_router"]), cfg)
        load = torch.bincount(top_idx.reshape(-1), minlength=MOE.n_experts_padded(cfg))
        assert int(load.max()) > cap, f"data shard {i}: no expert past capacity {cap}: {load}"
    for r, (y, _, _) in enumerate(got):
        _close(y, _rows(want, layout, r), f"bind rank {r}")
    p = {k: ({n: t(a) for n, a in v.items()} if isinstance(v, dict) else t(v))
         for k, v in params.items()}
    with torch.no_grad():
        dense = MOE.moe_ffn_dense(p, t(x), cfg).numpy()
    gap = float(np.max(np.abs(dense - want)))
    assert gap > 100 * MATMUL_REL * float(np.max(np.abs(want))), gap


@pytest.mark.parametrize("key", ["qwen2-moe-a2.7b-2x2", "deepseek-v3-671b-1x2", "bind-2x2"])
def test_abstract_census_equals_the_gloo_run(pools, key):
    arch, layout = CASES[key][:2]
    cfg, params, x, got = _run_layer(pools, key)
    census = _abstract_layer_census(cfg, params, x, layout)
    assert census.bytes and "model" in census.bytes
    for r, (_, nbytes, counts) in enumerate(got):
        assert nbytes == census.bytes, (r, nbytes, census.bytes)
        assert counts == census.counts, (r, counts, census.counts)


def _lm_tokens(cfg, B, S):
    return np.random.default_rng(3).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_lm_steps_over_ranks_match_single_rank(pools, layout):
    """qwen2-moe's ``prefill_step`` over the ranks equals the single-rank
    port's prefill of each data shard's rows alone; its decode steps equal
    the single-rank decode of the whole batch; the censuses equal the
    abstract mesh's."""
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    B, S, n_dec = LM_SHAPE
    toks = _lm_tokens(cfg, B, S)
    got = _pool(pools, layout).run("lm_steps", layout, cfg, 0, toks, n_dec)
    one = build_steps(cfg, device="cpu")
    params = one.init_state(torch.Generator().manual_seed(0))["params"]
    cache = one.init_cache(B, n_dec)
    dec = [one.decode_step(params, cache, torch.from_numpy(toks[:, t:t + 1]),
                           torch.tensor(t, dtype=torch.int32))[0].numpy() for t in range(n_dec)]
    d = layout[0]
    shards = [one.prefill_step(params, dict(tokens=torch.from_numpy(toks[i * B // d:
                                                                        (i + 1) * B // d])))
              for i in range(d)]
    mesh = make_abstract_mesh(data=layout[0], model=layout[1])
    steps = build_steps(cfg, mesh=mesh)
    meta = steps.init_state(torch.Generator())["params"]
    with collective_census() as pre:
        steps.prefill_step(meta, dict(tokens=torch.empty((B, S), dtype=torch.int32,
                                                         device="meta")))
    with collective_census() as step:
        steps.decode_step(meta, steps.init_cache(B, n_dec),
                          torch.empty((B, 1), dtype=torch.int32, device="meta"),
                          torch.zeros((), dtype=torch.int32, device="meta"))
    for r, (logits, dlog, pre_bytes, step_bytes) in enumerate(got):
        _close(logits, shards[r // layout[1]].numpy(), f"prefill rank {r}")
        for t in range(n_dec):
            _close(dlog[t], _rows(dec[t], layout, r), f"decode {t} rank {r}")
        assert pre_bytes == pre.bytes and step_bytes == step.bytes, (r, pre_bytes, pre.bytes)
