"""The port's LM training over a ``("data", "model")`` mesh of gloo ranks
on the CPU, against the JAX package's jitted ``train_step`` on a forced
4-device host platform.

Ranks are processes (tests/test_torch_ranks.py) in gloo groups of 2 and 4;
the layouts ``(data, model)`` are (1, 2) and (2, 2). The initial
parameters are the port's seeded draw (``build_steps(cfg,
device="cpu").init_state`` of seed 0), whole, as numpy: the reference (a
subprocess with ``--xla_force_host_platform_device_count=4``, started with
the module's first test) loads them into its state and places it with its
rules' shardings; each rank takes its blocks of them with
``params_from_reference(..., shardings=)``. The batches are seeded numpy,
the whole batch on every rank. Every arch runs at ``reduced()`` (f32).

* ``train_step`` of tinyllama, qwen2-moe (AdamW), deepseek-v3 (Adafactor,
  the MTP block) and jamba (Adafactor) at (2, 2), and qwen2-moe at (1, 2),
  two steps, every family in the rules' layout (``inner`` over ``model``
  for jamba's Mamba mixers): each step's loss and grad_norm within
  ``METRIC_REL`` (1e-5) of the reference's, and each rank's block of every
  optimizer-state leaf within ``LEAF_REL`` (1e-4) of the leaf's largest
  value (XLA's and PyTorch's f32 products and sums round differently);
  each rank's block of every parameter within ``LEAF_REL`` of the leaf's
  largest value or within ``PARAM_LR_FRAC`` (0.02) of the summed learning
  rate, tests/test_torch_train.py's bound for a parameter: Adafactor
  normalizes each update, so a leaf that starts at zero holds nothing but
  its updates (jamba's stacked ``conv_b`` and ``dt_bias``), whose relative
  rounding one device's port already shows at 4.3e-4 of the largest value
  after one step;
* every block of a leaf is bit-identical on every rank that holds it after
  the steps (a leaf every rank holds whole included: the norms; a leaf
  split over the data axes alone, such as a router, is held by each
  ``model`` rank of its data group);
* ``moe_ffn_sharded``'s gradients with respect to ``x``, the router and
  each expert block equal ``jax.grad`` of the reference's within 1e-4;
* each step's collective census on every rank equals the abstract mesh's
  (``make_abstract_mesh``, meta tensors) integer for integer, the
  backward's reduce-scatters and the gradients' all-reduces included.
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
from repro_torch.train.step import build_steps  # noqa: E402
from repro_torch.tree import module_tree  # noqa: E402

from test_torch_moe_sharded import moe_case  # noqa: E402
from test_torch_ranks import RankPool  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
METRIC_REL = 1e-5
LEAF_REL = 1e-4
PARAM_LR_FRAC = 0.02
B, S, N_STEPS = 4, 16, 2
TRAIN_CASES = {
    "tinyllama-1.1b-2x2": ("tinyllama-1.1b", (2, 2)),
    "qwen2-moe-a2.7b-1x2": ("qwen2-moe-a2.7b", (1, 2)),
    "qwen2-moe-a2.7b-2x2": ("qwen2-moe-a2.7b", (2, 2)),
    "deepseek-v3-671b-2x2": ("deepseek-v3-671b", (2, 2)),
    "jamba-v0.1-52b-2x2": ("jamba-v0.1-52b", (2, 2)),
}
GRAD_CASES = {"qwen2-moe-a2.7b-2x2": ("qwen2-moe-a2.7b", (2, 2)),
              "deepseek-v3-671b-1x2": ("deepseek-v3-671b", (1, 2))}


def batches(vocab: int):
    """The ``N_STEPS`` whole batches of every case (seeded numpy)."""
    rng = np.random.default_rng(11)
    return [dict(tokens=rng.integers(0, vocab, (B, S)).astype(np.int32))
            for _ in range(N_STEPS)]


def grad_case(arch: str):
    """``(params, x, c)``: ``moe_case``'s weights and input, and the
    cotangent ``c`` of the output."""
    params, x = moe_case(arch, 0, 4, 8)
    c = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    return params, x, c


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def nest(flat_dict):
    out = {}
    for name, v in flat_dict.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def initial_values(arch: str, seed: int = 0):
    """The port's draw of ``arch``'s ``reduced()`` parameters from
    ``seed`` (``train``'s own draw at ``TrainConfig.seed``), whole, as the
    reference's nested tree of numpy arrays."""
    steps = build_steps(get_config(arch).reduced(), device="cpu")
    model = steps.init_state(torch.Generator().manual_seed(seed))["params"]
    return {k: v.detach().numpy().copy() for k, v in flat(module_tree(model)).items()}


_FORCED = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models.moe import moe_ffn_sharded
from repro.sharding.rules import default_rules
from repro.train.step import build_steps
from test_torch_train_ranks import B, GRAD_CASES, S, TRAIN_CASES, batches, grad_case, nest

assert len(jax.devices()) == 4, jax.devices()
src, dst = sys.argv[1], sys.argv[2]
out = {}
for key, (arch, (d, m)) in TRAIN_CASES.items():
    cfg = get_config(arch).reduced()
    mesh = Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))
    steps = build_steps(cfg, mesh)
    state = jax.jit(steps.init_state)(jax.random.PRNGKey(0))
    with np.load(f"{src}/{arch}.npz") as z:
        state["params"] = nest({k: jnp.asarray(z[k]) for k in z.files})
    sh = steps.shardings(steps.state_specs)
    state = jax.device_put(state, sh)
    fn = jax.jit(steps.train_step, in_shardings=(sh, steps.shardings(steps.batch_spec(
        "train", S, B)[1])), out_shardings=(sh, NamedSharding(mesh, P())))
    for i, b in enumerate(batches(cfg.vocab)):
        state, met = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        out[f"{key}/metrics{i}"] = np.array([float(met["loss"]), float(met["grad_norm"]),
                                             float(met["lr"])])
    for j, leaf in enumerate(jax.tree.leaves(state)):
        out[f"{key}/leaf{j}"] = np.asarray(leaf)
for key, (arch, (d, m)) in GRAD_CASES.items():
    cfg = get_config(arch).reduced()
    mesh = Mesh(np.array(jax.devices()[: d * m]).reshape(d, m), ("data", "model"))
    params, x, c = grad_case(arch)
    params = jax.tree.map(jnp.asarray, params)
    f = lambda x, p: jnp.sum(moe_ffn_sharded(p, x, cfg, default_rules(mesh), mesh) * c)
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    out[f"{key}/x"] = np.asarray(gx)
    for k in ("w_router", "w_gate", "w_up", "w_down"):
        out[f"{key}/{k}"] = np.asarray(gp[k])
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
    """Each arch's initial parameters (whole numpy), also written for the
    reference, and the directory they are in."""
    d = tmp_path_factory.mktemp("values")
    made = {}
    for arch in dict.fromkeys(a for a, _ in TRAIN_CASES.values()):
        made[arch] = initial_values(arch)
        np.savez(d / f"{arch}.npz", **made[arch])
    return d, made


@pytest.fixture(scope="module")
def forced_reference(tmp_path_factory, values):
    """The reference on a forced 4-device host platform, every case, in a
    subprocess started with the module's first test."""
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
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("rendezvous")
    made = {w: RankPool(w, f"file://{d}/world{w}") for w in (2, 4)}
    yield made
    for p in made.values():
        p.close()


_RUNS = {}


def _run(pools, values, key):
    """Each rank's ``lm_train`` of the case (run once per module)."""
    if key not in _RUNS:
        arch, layout = TRAIN_CASES[key]
        cfg = get_config(arch).reduced()
        _RUNS[key] = pools[layout[0] * layout[1]].run(
            "lm_train", layout, cfg, nest(values[1][arch]), batches(cfg.vocab))
    return _RUNS[key]


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


def _close(got, want, what, rel=LEAF_REL, atol=0.0):
    """``got`` within ``rel`` of ``want``'s largest magnitude, or within
    ``atol``."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.all(np.isfinite(got)), what
    err = float(np.max(np.abs(got - want), initial=0.0))
    scale = float(np.max(np.abs(want), initial=0.0))
    assert err <= rel * scale or err <= atol, f"{what}: max |err| {err} > {rel} x {scale}"


@pytest.mark.parametrize("key", list(TRAIN_CASES))
def test_train_step_over_ranks_matches_reference(pools, values, forced_reference, key):
    got = _run(pools, values, key)
    ref = _reference(forced_reference)
    lr_sum = sum(float(ref[f"{key}/metrics{i}"][2]) for i in range(N_STEPS))
    for r, (metrics, _, blocks) in enumerate(got):
        for i, got_m in enumerate(metrics):
            want = ref[f"{key}/metrics{i}"]
            for k, (a, b) in enumerate(zip(got_m, want)):
                assert abs(a - b) <= METRIC_REL * abs(b), (key, r, i, k, got_m, want)
        assert len(blocks) == sum(k.startswith(f"{key}/leaf") for k in ref), key
        for j, (name, block, index) in enumerate(blocks):
            atol = PARAM_LR_FRAC * lr_sum if name.startswith("params.") else 0.0
            _close(block, ref[f"{key}/leaf{j}"][index], f"{key} rank {r} {name}", atol=atol)


@pytest.mark.parametrize("key", list(TRAIN_CASES))
def test_whole_leaves_are_bit_identical_across_ranks(pools, values, key):
    got = _run(pools, values, key)
    blocks = [b for _, _, b in got]
    whole = shared = 0
    for j, (name, _, _) in enumerate(blocks[0]):
        holders = {}
        for r, b in enumerate(blocks):
            holders.setdefault(tuple((s.start, s.stop) for s in b[j][2]), []).append(r)
        whole += len(holders) == 1
        for index, ranks in holders.items():
            shared += len(ranks) > 1
            first = blocks[ranks[0]][j][1]
            for r in ranks[1:]:
                assert np.array_equal(blocks[r][j][1], first), f"{key}: {name} differs on rank {r}"
    assert whole > 0
    _, (d, m) = TRAIN_CASES[key]
    if d > 1 and m > 1:
        assert shared > whole  # blocks over data alone, held by both model ranks


@pytest.mark.parametrize("key", list(GRAD_CASES))
def test_moe_ffn_sharded_gradients_match_jax_grad(pools, forced_reference, key):
    arch, layout = GRAD_CASES[key]
    cfg = get_config(arch).reduced()
    params, x, c = grad_case(arch)
    got = pools[layout[0] * layout[1]].run("moe_grads", layout, cfg, params, x, c)
    ref = _reference(forced_reference)
    d, m = layout
    E, dm = params["w_gate"].shape[:2]
    for r, g in enumerate(got):
        i, j = divmod(r, m)
        rows = slice(i * x.shape[0] // d, (i + 1) * x.shape[0] // d)
        e, k = slice(j * E // m, (j + 1) * E // m), slice(i * dm // d, (i + 1) * dm // d)
        _close(g["x"], ref[f"{key}/x"][rows], f"{key} rank {r} x")
        _close(g["w_router"], ref[f"{key}/w_router"], f"{key} rank {r} router")
        _close(g["w_gate"], ref[f"{key}/w_gate"][e, k], f"{key} rank {r} w_gate")
        _close(g["w_up"], ref[f"{key}/w_up"][e, k], f"{key} rank {r} w_up")
        _close(g["w_down"], ref[f"{key}/w_down"][e, :, k], f"{key} rank {r} w_down")


def _abstract_census(arch, layout):
    """Each step's census of ``train_step`` on an abstract mesh."""
    cfg = get_config(arch).reduced()
    steps = build_steps(cfg, mesh=make_abstract_mesh(data=layout[0], model=layout[1]))
    state = steps.init_state(torch.Generator())
    out = []
    for _ in range(N_STEPS):
        with collective_census() as census:
            state, m = steps.train_step(state, dict(tokens=torch.empty(
                (B, S), dtype=torch.int32, device="meta")))
        out.append((census.bytes, census.counts))
    assert m["loss"].device.type == "meta"
    return out


@pytest.mark.parametrize("key", ["tinyllama-1.1b-2x2", "qwen2-moe-a2.7b-2x2",
                                 "deepseek-v3-671b-2x2"])
def test_train_step_census_equals_the_abstract_mesh(pools, values, key):
    arch, layout = TRAIN_CASES[key]
    want = _abstract_census(arch, layout)
    ops = {op for by_op in want[0][0].values() for op in by_op}
    assert "all-reduce" in ops
    if arch != "tinyllama-1.1b":
        assert {"all-gather", "reduce-scatter"} <= ops, want[0]
    for r, (_, censuses, _) in enumerate(_run(pools, values, key)):
        assert censuses == want, (r, censuses, want)
