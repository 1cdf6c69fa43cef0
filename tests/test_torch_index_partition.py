"""The index-parallel layouts of the port against the JAX package's, on the host.

One grid index (``fs``, n = 1200, seed 1; and a three-level one, n = 2500)
built by both packages. Held equal field for field:

* ``partition_index`` for S in (1, 2, 3, 4): the greedy LPT cut, its
  per-level node lists, inverse maps and pads;
* every stacked tensor of ``PartitionedSnapshot.build`` -- level planes,
  shard-local child tables, leaf blocks, the gid maps, the per-shard narrow
  planes and the compact bank -- its bytes per shard, and a reference
  partition carried across with ``from_reference_arrays``;
* ``partition_delta`` of a delta log on its leaves' own terms (log A,
  compact insert slots) and of one with foreign terms (log B);
* ``PlanCache.seeded_plan`` / ``seeded_shard_plan`` / ``observe_shards``
  through the same observations;
* ``pad_queries_to_bucket`` / ``pad_knn_queries_to_bucket`` with
  ``shards=``.

The rejections (``n_shards < 1``, fewer roots than shards) raise as the
reference's do. A one-rank mesh (no process group) places the whole slab
and serves as the snapshot does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import plan as jplan, snapshot as jsnapshot  # noqa: E402
from repro.serve.delta import partition_delta as jpartition_delta  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.launch.wisk_serve import serve_index_sharded, serve_knn_index_sharded  # noqa: E402
from repro_torch.serve import delta, plan  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402
from repro_torch.serve.snapshot import (  # noqa: E402
    PARTITION_FIELDS, IndexPartition, PartitionedSnapshot, partition_index,
)

from test_torch_delta import Pair, _buffers_equal  # noqa: E402
from test_torch_knn import _points  # noqa: E402
from test_torch_serving import _pair  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    return Pair(seed=1)


@pytest.fixture(scope="module")
def deep():
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    return IndexSnapshot.build(index, ds, device="cpu"), jsnapshot.IndexSnapshot.build(jindex, jds)


def _as(t, like):
    a = t.numpy()
    return a.view(np.uint32) if np.asarray(like).dtype == np.uint32 else a


def _parts_equal(part, jpart):
    assert part.n_shards == jpart.n_shards and part.n_leaves == jpart.n_leaves
    assert part.level_pads == jpart.level_pads
    np.testing.assert_array_equal(part.root_to_shard, jpart.root_to_shard)
    for name in ("shard_of", "local_of"):
        for a, b in zip(getattr(part, name), getattr(jpart, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for row, jrow in zip(part.nodes, jpart.nodes):
        for a, b in zip(row, jrow):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _psnaps_equal(psnap, jpsnap):
    assert (psnap.n_shards, psnap.obj_per_leaf) == (jpsnap.n_shards, jpsnap.obj_per_leaf)
    _parts_equal(psnap.part, jpsnap.part)
    for name in PARTITION_FIELDS:
        got, want = getattr(psnap, name), getattr(jpsnap, name)
        if want is None:
            assert got is None, name
            continue
        pairs = zip(got, want) if isinstance(want, list) else [(got, want)]
        assert not isinstance(want, list) or len(got) == len(want), name
        for g, w in pairs:
            w = np.asarray(w)
            np.testing.assert_array_equal(_as(g, w), w, err_msg=name)
            assert _as(g, w).dtype == w.dtype, name
    assert psnap.per_shard_bytes() == jsnapshot.tree_nbytes(jpsnap) // jpsnap.n_shards
    assert psnap.local_root_width() == jpsnap.local_root_width()
    assert psnap.n_leaves_global == jpsnap.n_leaves_global
    assert psnap.has_narrow_planes == jpsnap.has_narrow_planes
    assert psnap.has_compact_bank == jpsnap.has_compact_bank


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_partition_index_matches_reference(pair, deep, n_shards):
    for snap, jsnap in ((pair.snap, pair.jsnap), deep):
        _parts_equal(partition_index(snap, n_shards), jsnapshot.partition_index(jsnap, n_shards))


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_partitioned_snapshot_matches_reference(pair, deep, n_shards):
    for snap, jsnap in ((pair.snap, pair.jsnap), deep):
        psnap = PartitionedSnapshot.build(snap, n_shards)
        jpsnap = jsnapshot.PartitionedSnapshot.build(jsnap, n_shards)
        assert psnap.has_narrow_planes and psnap.has_compact_bank
        _psnaps_equal(psnap, jpsnap)


def test_reference_partition_carried_across(deep):
    snap, jsnap = deep
    jpsnap = jsnapshot.PartitionedSnapshot.build(jsnap, 2)
    fields = {}
    for name in PARTITION_FIELDS:
        v = getattr(jpsnap, name)
        fields[name] = None if v is None else (
            [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v))
    jp = jpsnap.part
    part = IndexPartition(n_shards=jp.n_shards, root_to_shard=jp.root_to_shard, nodes=jp.nodes,
                          shard_of=jp.shard_of, local_of=jp.local_of, level_pads=jp.level_pads,
                          n_leaves=jp.n_leaves)
    carried = PartitionedSnapshot.from_reference_arrays(fields, jpsnap.obj_per_leaf, part)
    _psnaps_equal(carried, jpsnap)
    _psnaps_equal(PartitionedSnapshot.build(snap, 2), jpsnap)


def test_partition_rejects_bad_shard_counts(pair):
    with pytest.raises(ValueError, match="n_shards"):
        partition_index(pair.snap, 0)
    n_root = int(pair.snap.level_mbrs[0].shape[0])
    with pytest.raises(ValueError, match="root subtrees"):
        partition_index(pair.snap, n_root + 1)
    with pytest.raises(ValueError, match="root subtrees"):
        jsnapshot.partition_index(pair.jsnap, n_root + 1)


@pytest.mark.parametrize("own_leaf_terms", [True, False])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_partition_delta_matches_reference(own_leaf_terms, n_shards):
    P = Pair(seed=2)
    P.churn(40, 30, own_leaf_terms)
    assert P.log.compact_ok == own_leaf_terms
    part = partition_index(P.snap, n_shards)
    jpart = jsnapshot.partition_index(P.jsnap, n_shards)
    got = delta.partition_delta(P.log.buffer, part)
    _buffers_equal(got, jpartition_delta(P.jlog.buffer, jpart))
    assert got.device == torch.device("cpu")


def test_seeded_shard_plans_match_reference():
    cache, jcache = PlanCache(), jplan.PlanCache()
    rng = np.random.default_rng(3)
    for step in range(6):
        assert cache.seeded_plan("skr", 3).widths == jcache.seeded_plan("skr", 3).widths
        assert (cache.seeded_shard_plan("skr_ix", 3, 2).widths
                == jcache.seeded_shard_plan("skr_ix", 3, 2).widths)
        maxima = rng.integers(0, 40 * (step + 1), (3, 2))
        cache.observe_shards("skr_ix", maxima)
        jcache.observe_shards("skr_ix", maxima)
        cache.observe("skr", maxima[0])
        jcache.observe("skr", maxima[0])
        assert cache.widths == jcache.widths
    assert cache.seeded_plan("knn", 2, minimum=4).widths == (4, 4)


@pytest.mark.parametrize("m", [1, 5, 13, 16, 33])
@pytest.mark.parametrize("shards", [1, 2, 3, 8])
def test_pad_to_bucket_with_shards_matches_reference(m, shards):
    rng = np.random.default_rng(m * 10 + shards)
    rects = rng.uniform(0, 1, (m, 4)).astype(np.float32)
    bms = rng.integers(0, 2 ** 32, (m, 3), dtype=np.uint32)
    for a, b in zip(plan.pad_queries_to_bucket(rects, bms, 4, shards=shards),
                    jplan.pad_queries_to_bucket(rects, bms, 4, shards=shards)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(plan.pad_knn_queries_to_bucket(rects[:, :2], bms, 8, shards=shards),
                    jplan.pad_knn_queries_to_bucket(rects[:, :2], bms, 8, shards=shards)):
        np.testing.assert_array_equal(a, b)


def test_one_rank_mesh_places_the_whole_slab_and_serves(pair):
    """No process group: a 1 x 1 mesh, one shard, serving equal to the
    snapshot's own on every counter and id set (kNN on every key)."""
    mesh = make_serving_mesh(1, 1, device="cpu")
    psnap = PartitionedSnapshot.build(pair.snap, 1)
    slab = psnap.shard(mesh)
    for name in ("level_mbrs", "leaf_obj_id", "leaf_obj_cbm"):
        want = getattr(psnap, name)
        got = getattr(slab, name)
        for g, w in (zip(got, want) if isinstance(want, list) else [(got, want)]):
            assert torch.equal(g, w)
    wl, _ = pair.workload(m=12)
    K = pair.index.levels[-1].n
    want = retrieve(pair.snap, wl.rects, wl.kw_bitmap, K, plan_cache=PlanCache())
    got = serve_index_sharded(psnap, wl.rects, wl.kw_bitmap, K, mesh=mesh, plan_cache=PlanCache())
    for key in ("counts", "nodes_checked", "verified", "overflow", "nodes_scanned"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for a, b in zip(got["ids"], want["ids"]):
        np.testing.assert_array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0]))
    kwant = retrieve_knn(pair.snap, _points(wl), wl.kw_bitmap, 5, plan_cache=PlanCache())
    kgot = serve_knn_index_sharded(psnap, _points(wl), wl.kw_bitmap, 5, mesh=mesh,
                                   plan_cache=PlanCache())
    for key in kwant:
        np.testing.assert_array_equal(kgot[key], kwant[key], err_msg=key)
    with pytest.raises(ValueError, match="index axis"):
        serve_index_sharded(PartitionedSnapshot.build(pair.snap, 2), wl.rects, wl.kw_bitmap, K,
                            mesh=mesh)
    with pytest.raises(ValueError, match="ranks"):
        make_serving_mesh(2, 1, device="cpu")
