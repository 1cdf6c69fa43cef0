"""The port's ``build_wisk`` and ``warm_start_rebuild`` against the JAX package.

jax.random's streams cannot be reproduced in torch, so whole builds are held
by what they are for: each port build's Eq. 1 total on its training
workload (``exact_workload_cost``) is at most 1.10 times the highest of the
reference's builds at seeds 0, 1 and 2, its index serves exactly
(``retrieve`` in both modes equal to ``execute_serial``), and two builds at
one seed are equal. Where the randomness is carried across -- a reference
build's bank, partition, hierarchy and training workload
(``build.artifacts_from_reference``) -- the port's warm-start rebuild must
give the reference's index levels exactly. The configs are
tests/test_build_parity.py's tiny ones.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import build as jbuild  # noqa: E402
from repro.core.dqn import DQNConfig as JDQNConfig  # noqa: E402
from repro.core.packing import PackingConfig as JPackingConfig  # noqa: E402
from repro.core.partition import PartitionConfig as JPartitionConfig  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.core import build as tbuild  # noqa: E402
from repro_torch.core.cost import exact_query_results, exact_workload_cost  # noqa: E402
from repro_torch.core.dqn import DQNConfig  # noqa: E402
from repro_torch.core.packing import PackingConfig  # noqa: E402
from repro_torch.core.partition import PartitionConfig  # noqa: E402
from repro_torch.core.query import execute_serial  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve  # noqa: E402

SEEDS = (0, 1, 2)


def _config(mod, part, pack, dqn, seed, **over):
    cfg = mod.BuildConfig(
        partition=part(max_clusters=64, n_steps=20, n_restarts=2, min_objects=64,
                       query_pad=16, max_split_batch=8),
        packing=pack(epochs=2, max_label_queries=8, dqn=dqn()),
        cdf_train_steps=40, use_itemsets=False, seed=seed,
    )
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def port_config(seed=0, **over):
    return _config(tbuild, PartitionConfig, PackingConfig, DQNConfig, seed, **over)


def ref_config(seed=0, **over):
    return _config(jbuild, JPartitionConfig, JPackingConfig, JDQNConfig, seed, **over)


@pytest.fixture(scope="module")
def data():
    ds, jds = make_dataset("fs", n=600, seed=21), jmake_dataset("fs", n=600, seed=21)
    return ds, make_workload(ds, m=16, dist="MIX", seed=22), jds, jmake_workload(jds, m=16, dist="MIX", seed=22)


@pytest.fixture(scope="module")
def ref_builds(data):
    _, _, jds, jwl = data
    return {seed: jbuild.build_wisk(jds, jwl, ref_config(seed)) for seed in SEEDS}


def _eq1(ds, art, wl):
    return exact_workload_cost(ds, art.partition.clusters, wl).total


@pytest.mark.parametrize("seed", SEEDS)
def test_build_cost_within_bound_of_reference(data, ref_builds, seed):
    ds, wl, jds, jwl = data
    art = tbuild.build_wisk(ds, wl, port_config(seed), device="cpu")
    bound = 1.10 * max(_eq1(ds, ref_builds[s], wl) for s in SEEDS)
    assert _eq1(ds, art, wl) <= bound
    assert art.partition.clusters.k > 1 and art.hierarchy is not None
    assert set(art.timings) == set(ref_builds[seed].timings)
    assert set(art.counters) == set(ref_builds[seed].counters)
    assert art.counters["partition_problems"] >= art.counters["partition_rounds"] >= 1
    assert art.bank.device == torch.device("cpu")


@pytest.mark.parametrize("mode", ["frontier", "dense"])
def test_port_build_serves_exactly(data, mode):
    ds, wl, *_ = data
    art = tbuild.build_wisk(ds, wl, port_config(1), device="cpu")
    snap = IndexSnapshot.build(art.index, ds, device="cpu", dense=mode == "dense")
    out = retrieve(snap, wl.rects, wl.kw_bitmap, max_leaves=art.index.levels[-1].n, mode=mode)
    st = execute_serial(art.index, ds, wl)
    assert (out["overflow"] == 0).all()
    for q in range(wl.m):
        row = out["ids"][q]
        np.testing.assert_array_equal(np.sort(row[row >= 0]), np.sort(st.results[q]))
    np.testing.assert_array_equal(out["verified"], st.verified)
    np.testing.assert_array_equal(np.array([len(r) for r in st.results]), exact_query_results(ds, wl))
    if mode == "frontier":
        np.testing.assert_array_equal(out["nodes_checked"], st.nodes_accessed)


def test_builds_are_deterministic_and_modes_agree(data):
    ds, wl, *_ = data
    a, b = (tbuild.build_wisk(ds, wl, port_config(2), device="cpu") for _ in range(2))
    np.testing.assert_array_equal(a.partition.clusters.assign, b.partition.clusters.assign)
    assert len(a.hierarchy.parents) == len(b.hierarchy.parents) > 0
    for pa, pb in zip(a.hierarchy.parents, b.hierarchy.parents):
        np.testing.assert_array_equal(pa, pb)
    assert a.bank.train_loss == b.bank.train_loss
    for k in a.bank.nn_params:
        assert torch.equal(a.bank.nn_params[k], b.bank.nn_params[k])
    seq = tbuild.build_wisk(ds, wl, port_config(2, construction="sequential"), device="cpu")
    np.testing.assert_array_equal(seq.partition.clusters.assign, a.partition.clusters.assign)
    for pa, pb in zip(seq.hierarchy.parents, a.hierarchy.parents):
        np.testing.assert_array_equal(pa, pb)
    assert seq.counters["partition_problems"] == a.counters["partition_problems"]
    assert a.counters["construction_dispatches"] < seq.counters["construction_dispatches"]


def test_accelerated_build_samples_and_groups(data):
    ds, wl, *_ = data
    art = tbuild.build_wisk(ds, wl, port_config(0, accelerated=True), device="cpu")
    assert art.train_workload.m < wl.m
    assert art.hierarchy.packs[0].sum_rewards == 0.0  # the spectral grouping level
    st = execute_serial(art.index, ds, wl)
    np.testing.assert_array_equal(np.array([len(r) for r in st.results]), exact_query_results(ds, wl))


def _carried(ref, ds, wl):
    b = ref.bank
    bank = dict(cls=b.cls, count=b.count, gauss=b.gauss, nn_slot=b.nn_slot,
                nn_params=None if b.nn_params is None else {
                    k: np.asarray(v) for k, v in b.nn_params.items()},
                vocab_size=b.vocab_size, train_loss=b.train_loss)
    return tbuild.artifacts_from_reference(ds, bank, ref.itemsets, ref.partition.clusters.assign,
                                           ref.hierarchy.parents, wl, device="cpu")


@pytest.mark.parametrize("regressed", ["explicit", "detected"])
def test_warm_start_rebuild_from_reference_build_matches(data, ref_builds, regressed):
    ds, wl, jds, jwl = data
    ref = ref_builds[0]
    wl2, jwl2 = make_workload(ds, m=16, dist="GAU", seed=4), jmake_workload(jds, m=16, dist="GAU", seed=4)
    mask = None
    if regressed == "explicit":
        mask = np.zeros(ref.partition.clusters.k, bool)
        mask[[0, ref.partition.clusters.k // 2]] = True
    want = jbuild.warm_start_rebuild(jds, jwl2, ref, ref_config(0), regressed=mask)
    prev = _carried(ref, ds, wl)
    assert len(prev.index.levels) == len(ref.index.levels)
    got = tbuild.warm_start_rebuild(ds, wl2, prev, port_config(0), regressed=mask, device="cpu")
    assert got.counters == want.counters
    assert got.counters["refined_leaves"] > 0
    np.testing.assert_array_equal(got.partition.clusters.assign, want.partition.clusters.assign)
    assert len(got.index.levels) == len(want.index.levels)
    for a, b in zip(got.index.levels, want.index.levels):
        for f in ("mbrs", "bitmaps", "child_ptr", "child"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert got.train_workload is wl2 and got.itemsets == want.itemsets
    st = execute_serial(got.index, ds, wl2)
    np.testing.assert_array_equal(np.array([len(r) for r in st.results]), exact_query_results(ds, wl2))
    with pytest.raises(ValueError, match="assignment covers"):
        tbuild.warm_start_rebuild(ds, wl2, prev, port_config(0), assign=np.zeros(3, np.int32),
                                  device="cpu")


def test_entry_points_run_on_cuda_by_default(data):
    ds, wl, *_ = data
    prev = tbuild.build_wisk(ds, wl, port_config(0), device="cpu")
    if torch.cuda.is_available():
        assert tbuild.build_wisk(ds, wl, port_config(0)).bank.device.type == "cuda"
        assert tbuild.warm_start_rebuild(ds, wl, prev, port_config(0)).bank.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.build_wisk(ds, wl, port_config(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbuild.warm_start_rebuild(ds, wl, prev, port_config(0))
