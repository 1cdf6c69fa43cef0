"""The port's sharding rules (``repro_torch.sharding.rules``) against the
JAX package's, on the CPU.

* ``default_rules`` equal the reference's for meshes of axes ``("data",
  "model")``, ``("pod", "data", "model")`` and ``("data", "index")``, and
  ``spec_for`` of every logical name equals the reference's
  ``PartitionSpec`` turned into a tuple;
* for every arch at ``reduced()``, every leaf of its parameters, its own
  optimizer's state (AdamW or Adafactor), its batch specs (train and
  prefill) and its cache specs (plain and long-context), with
  ``logical_overrides`` merged into the rules: the port's spec tree and
  shapes equal the reference's (``build_steps`` on no mesh, its state by
  ``jax.eval_shape``), and ``named_sharding(...).shard_shape`` equals
  ``NamedSharding(AbstractMesh((2, 4), ("data", "model")), spec)
  .shard_shape`` at the same global shape -- at batch 2 and at batch 3,
  which does not split over the two data ranks: where JAX raises, the
  port raises;
* ``shard_tensor``'s blocks over every rank of a mesh reassemble to the
  whole tensor, each element once, the two-axis ``kv_seq_all`` case
  included, and ``shard_rows`` is its first-dimension case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.tree import module_tree  # noqa: E402
from repro_torch.train.step import build_steps, mesh_rules  # noqa: E402

MESHES = {
    "data-model": dict(data=2, model=4),
    "pod-data-model": dict(pod=2, data=2, model=2),
    "data-index": dict(data=2, index=4),
}
SEQ = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


@pytest.mark.parametrize("name", list(MESHES))
def test_default_rules_equal_the_reference(name):
    sizes = MESHES[name]
    mesh = make_abstract_mesh(**sizes)
    want = jrules.default_rules(_abstract(sizes))
    got = rules.default_rules(mesh)
    assert got == want
    assert rules.dp_axes(mesh) == jrules.dp_axes(_abstract(sizes))
    for n in list(want) + [None, "unknown"]:
        assert rules.spec_for((n, None), got) == tuple(jrules.spec_for((n, None), want)), n


def _walk(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and named tuples."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _walk(getattr(tree, k), path + (k,))
    else:
        yield path, tree


def _spec_leaves(specs):
    """A spec tree's (path, names) pairs (a names tuple is a leaf)."""
    if rules._is_names(specs):
        return [((), specs)]
    if isinstance(specs, dict):
        return [((k,) + p, s) for k in sorted(specs) for p, s in _spec_leaves(specs[k])]
    return [((k,) + p, s) for k in specs._fields for p, s in _spec_leaves(getattr(specs, k))]


def _jshard(jmesh, spec, jr, shape):
    try:
        return NamedSharding(jmesh, P(*jrules.spec_for(spec, jr))).shard_shape(tuple(shape))
    except Exception as e:  # JAX's ValueError or DuplicateSpecError
        return type(e).__name__


def _pshard(pmesh, spec, pr, shape):
    try:
        return rules.named_sharding(pmesh, spec, pr).shard_shape(tuple(shape))
    except ValueError as e:
        return type(e).__name__


def _leaves(arch):
    """``(what, names, port shape, reference shape)`` of every leaf the
    arch's steps name, checked equal in names and shapes on the way."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    steps = build_steps(cfg, device="meta")
    jsteps = jbuild_steps(jcfg)
    state = steps.init_state(torch.Generator())
    state = dict(params=module_tree(state["params"]), opt=state["opt"], step=state["step"])
    jstate = jax.eval_shape(jsteps.init_state, jax.random.PRNGKey(0))
    specs = _spec_leaves(steps.state_specs)
    assert specs == _spec_leaves(jsteps.state_specs)
    got, want = dict(_walk(state)), dict(_walk(jstate))
    assert set(got) == set(want) == {p for p, _ in specs}
    out = [(p, s, tuple(got[p].shape), tuple(want[p].shape)) for p, s in specs]
    for batch in (2, 3):
        for kind in ("train", "prefill"):
            b, s = steps.batch_spec(kind, SEQ, batch)
            jb, js = jsteps.batch_spec(kind, SEQ, batch)
            assert s == js
            out += [((kind, batch, k), s[k], tuple(b[k].shape), tuple(jb[k].shape)) for k in b]
        for long_ctx in (False, True):
            c, s = steps.cache_spec(batch, SEQ, long_ctx)
            jc, js = jsteps.cache_spec(batch, SEQ, long_ctx)
            assert s == js
            out += [(("cache", batch, long_ctx, k), s[k], tuple(c[k].shape), tuple(jc[k].shape))
                    for k in c]
    return cfg, jcfg, out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_equal_named_sharding(arch):
    sizes = MESHES["data-model"]
    pmesh, jmesh = make_abstract_mesh(**sizes), _abstract(sizes)
    cfg, jcfg, leaves = _leaves(arch)
    pr = mesh_rules(cfg, pmesh)
    jr = dict(jrules.default_rules(jmesh))
    jr.update(jcfg.logical_overrides or {})
    assert pr == jr
    raised = split = 0
    for what, names, shape, jshape in leaves:
        assert shape == jshape, what
        got, want = _pshard(pmesh, names, pr, shape), _jshard(jmesh, names, jr, shape)
        assert (got == "ValueError") == isinstance(want, str), (what, names, shape, got, want)
        if isinstance(want, str):
            raised += 1
        else:
            assert got == tuple(want), (what, names, shape, got, want)
            split += got != shape
    assert raised and split, (raised, split)  # batch 3 raised; some leaves split


def test_tree_shardings_maps_a_spec_tree():
    """``tree_shardings`` maps the state's spec tree (dicts and the
    optimizer's named tuple) leaf for leaf to ``named_sharding``."""
    cfg = get_config("deepseek-v3-671b").reduced()
    mesh = make_abstract_mesh(**MESHES["pod-data-model"])
    specs = build_steps(cfg, device="meta").state_specs
    pr = mesh_rules(cfg, mesh)
    got = rules.tree_shardings(mesh, specs, pr)
    assert type(got["opt"]) is type(specs["opt"])
    leaves = _spec_leaves(specs)
    assert [p for p, _ in leaves] == [p for p, _ in _walk(got)]
    for (path, names), (_, sh) in zip(leaves, _walk(got)):
        assert sh == rules.named_sharding(mesh, names, pr), path


def _reassemble(x, names, sizes):
    """Every rank's ``shard_tensor`` block written back into a zero tensor,
    with a count of how often each element was written."""
    out, seen = torch.zeros_like(x), torch.zeros(x.shape, dtype=torch.int32)
    world = int(np.prod(list(sizes.values())))
    for r in range(world):
        mesh = make_abstract_mesh(rank=r, **sizes)
        block = rules.shard_tensor(x, names, mesh)
        idx = rules.named_sharding(mesh, names).index(x.shape)
        assert torch.equal(x[idx], block)
        out[idx] = block
        seen[idx] += 1
    return out, seen


@pytest.mark.parametrize("names", [("batch", "kv_seq", None), ("layers", None, "kv_seq_all", None),
                                   ("experts", "wembed", "expert_mlp"), ("vocab", "wembed")],
                         ids=lambda n: "-".join(str(x) for x in n))
@pytest.mark.parametrize("mesh", ["data-model", "pod-data-model"])
def test_shard_tensor_blocks_reassemble(names, mesh):
    sizes = MESHES[mesh]
    shape = [8 * (i + 2) for i in range(len(names))]
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    out, seen = _reassemble(x, names, sizes)
    assert torch.equal(out, x) and bool((seen == 1).all())


def test_shard_rows_is_the_first_dimension_case():
    x = np.arange(48).reshape(12, 4)
    for r in range(8):
        mesh = make_abstract_mesh(rank=r, data=2, index=4)
        i, j = mesh.axis("data").index, mesh.axis("index").index
        assert np.array_equal(rules.shard_rows(x, "leaf", mesh), x[3 * j:3 * j + 3])
        assert np.array_equal(rules.shard_rows(x, "query", mesh), x[6 * i:6 * i + 6])
        assert rules.shard_rows(x, "word", mesh).shape == x.shape
    with pytest.raises(ValueError):
        rules.shard_rows(np.arange(10), "leaf", make_abstract_mesh(data=2, index=4))
