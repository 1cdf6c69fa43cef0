"""Retrieval-augmented serving end to end on the CPU: the port's
``examples/torch_retrieval_augmented_serving.py`` path against the JAX
package's ``examples/retrieval_augmented_serving.py`` path.

Both packages build the same small grid index with ``assemble_index`` (as
``benchmarks/bench_serving.quick_snapshot`` does: no DQN), serve the
example's four MIX queries through ``retrieve_workload`` -- every output
key equal -- and prompt reduced ``tinyllama-1.1b``, its weights carried
across from the reference, with each query's first id modulo the
vocabulary. The greedy tokens are equal. The port's example also runs
whole, with its own build, on ``--device cpu``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.index import assemble_index as jassemble_index  # noqa: E402
from repro.core.packing import HierarchyResult as JHierarchy  # noqa: E402
from repro.core.types import ClusterSet as JClusterSet  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.models.layers import split_params as jsplit_params  # noqa: E402
from repro.serve.engine import IndexSnapshot as JSnapshot  # noqa: E402
from repro.serve.engine import retrieve_workload as jretrieve_workload  # noqa: E402
from repro.train.decode import greedy_generate as jgreedy_generate  # noqa: E402
from repro.train.step import build_steps as jbuild_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.index import HierarchyResult, assemble_index  # noqa: E402
from repro_torch.core.types import ClusterSet  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serve.snapshot import IndexSnapshot  # noqa: E402
from repro_torch.train.step import build_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_retrieval_augmented_serving",
        ROOT / "examples" / "torch_retrieval_augmented_serving.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(ds, clusters_cls, hier_cls, assemble, g=8, **hier_kw):
    """bench_serving.quick_snapshot's grid hierarchy over ``ds``."""
    cell = np.minimum((ds.locs * g).astype(np.int32), g - 1)
    _, assign = np.unique(cell[:, 0] * g + cell[:, 1], return_inverse=True)
    clusters = clusters_cls.from_assignment(ds, assign.astype(np.int32))
    cent = np.clip((clusters.mbrs[:, :2] + clusters.mbrs[:, 2:]) / 2, 0.0, 1.0)
    pc = np.minimum((cent * (g // 2)).astype(np.int32), g // 2 - 1)
    _, pid = np.unique(pc[:, 0] * (g // 2) + pc[:, 1], return_inverse=True)
    hier = hier_cls(parents=[pid.astype(np.int32)], **hier_kw)
    return assemble(ds, clusters, hier), clusters.k


@pytest.fixture(scope="module")
def retrieved():
    ex = _example()
    jds, ds = jmake_dataset("fs", n=3000, seed=0), make_dataset("fs", n=3000, seed=0)
    jindex, k = _grid(jds, JClusterSet, JHierarchy, jassemble_index, level_labels=[], packs=[])
    index, k2 = _grid(ds, ClusterSet, HierarchyResult, assemble_index)
    assert k == k2
    jq = jmake_workload(jds, m=ex.B, dist="MIX", seed=9)
    q = make_workload(ds, m=ex.B, dist="MIX", seed=9)
    jhits = jretrieve_workload(JSnapshot.build(jindex, jds), jq, max_leaves=k)
    snap = IndexSnapshot.build(index, ds, device="cpu")
    cfg = get_config(ARCH).reduced()
    hits, prompt = ex.retrieve_prompts(snap, q, k, cfg.vocab)
    return ex, jhits, hits, prompt


def test_retrieval_equals_reference(retrieved):
    _, jhits, hits, prompt = retrieved
    assert sorted(hits) == sorted(jhits)
    for key in jhits:
        got, want = np.asarray(hits[key]), np.asarray(jhits[key])
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert np.asarray(hits["counts"]).sum() > 0
    vocab = get_config(ARCH).reduced().vocab
    np.testing.assert_array_equal(prompt, np.asarray(jhits["ids"])[:, :1] % vocab)
    assert prompt.min() >= 0


@pytest.mark.parametrize("prompt_kind", ["example", "first_hit"])
def test_generated_tokens_equal_reference(retrieved, prompt_kind):
    ex, jhits, hits, prompt = retrieved
    jcfg = jget_config(ARCH).reduced()
    if prompt_kind == "first_hit":
        # each query's first retrieved id (not the first slot), so rows differ
        ids = np.asarray(hits["ids"])
        first = np.array([row[row >= 0][0] if (row >= 0).any() else -1 for row in ids])
        prompt = (first[:, None] % jcfg.vocab).astype(np.int32)
        assert len(set(prompt[:, 0].tolist())) > 1
    jsteps = jbuild_steps(jcfg)
    jparams = jsplit_params(jsteps.bundle.init(jax.random.PRNGKey(0)))[0]
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jsteps.cache_spec(ex.B, ex.S)[0])
    want, _ = jgreedy_generate(jsteps, jparams, jcache, jnp.asarray(prompt), n_new=ex.N_NEW,
                               start_pos=0)

    steps = build_steps(get_config(ARCH).reduced(), device="cpu")
    model = steps.init_state(torch.Generator().manual_seed(0))["params"]
    model.load_state_dict(params_from_reference(jax.tree.map(np.asarray, jparams)))
    got = ex.generate(steps, model, prompt)
    assert got.shape == (ex.B, ex.N_NEW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_example_runs_on_cpu(capsys):
    _example().main("cpu")
    out = capsys.readouterr().out
    assert "retrieved per query: [" in out
    assert "generated token ids: [[" in out
    assert "device: cpu" in out
