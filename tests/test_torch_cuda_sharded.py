"""Multi-rank serving on the card against the plain versions.

Two gloo ranks share ``cuda:0`` (NCCL takes one card a rank). Each of the
four multi-rank front doors serves one batch there -- its descents and
verifies on the CUDA kernels, its collectives on CUDA tensors -- and is
held against the single-device path on the CPU (the kernels' plain
versions): the query-parallel regime on every key, the index-parallel SKR
on its counters and id sets, the index-parallel kNN on ids, ``dist2`` and
every counter. Every test here needs an NVIDIA GPU with ``nvcc`` and skips
elsewhere. The file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_sharded.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.baselines.conventional import build_str_rtree  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402
from repro_torch.serve.snapshot import PartitionedSnapshot  # noqa: E402

from test_torch_ranks import RankPool  # noqa: E402

pytestmark = pytest.mark.cuda

KNN_KEYS = ("ids", "dist2", "nodes_checked", "verified", "leaves_verified", "pruned")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; the kernels have no CPU mode")
    d = tmp_path_factory.mktemp("rendezvous")
    p = RankPool(2, f"file://{d}/world2", device="cuda:0")
    yield p
    p.close()


@pytest.fixture(scope="module")
def case():
    ds = make_dataset("osm", n=20000, seed=3)
    index = build_str_rtree(ds, leaf_size=64, fanout=8)
    wl = make_workload(ds, m=64, dist="MIX", seed=4)
    points = np.stack([(wl.rects[:, 0] + wl.rects[:, 2]) / 2,
                       (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1).astype(np.float32)
    snap = IndexSnapshot.build(index, ds, device="cpu")
    return dict(snap=snap, psnap=PartitionedSnapshot.build(snap, 2), rects=wl.rects,
                bms=wl.kw_bitmap, points=points, K=index.levels[-1].n)


def _serve(pool, layout, front_door, args):
    outs = pool.run("serve", layout, front_door, args, {})
    (first,), _ = outs[0]
    for (other,), _ in outs[1:]:
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    return first


def _equal(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_query_parallel_on_the_card_matches_the_plain_path(pool, case):
    c = case
    want = retrieve(c["snap"], c["rects"], c["bms"], 32, plan_cache=PlanCache())
    got = _serve(pool, (2, 1), "serve_sharded", (c["snap"], c["rects"], c["bms"], 32))
    _equal(got, want, want)
    want = retrieve_knn(c["snap"], c["points"], c["bms"], 10, plan_cache=PlanCache())
    got = _serve(pool, (2, 1), "serve_knn_sharded", (c["snap"], c["points"], c["bms"], 10))
    _equal(got, want, want)


def test_index_parallel_on_the_card_matches_the_plain_path(pool, case):
    c = case
    want = retrieve(c["snap"], c["rects"], c["bms"], 32, plan_cache=PlanCache())
    got = _serve(pool, (1, 2), "serve_index_sharded", (c["psnap"], c["rects"], c["bms"], 32))
    _equal(got, want, ("counts", "nodes_checked", "verified", "overflow"))
    for a, b in zip(got["ids"], want["ids"]):
        np.testing.assert_array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0]))
    want = retrieve_knn(c["snap"], c["points"], c["bms"], 10, plan_cache=PlanCache())
    got = _serve(pool, (1, 2), "serve_knn_index_sharded",
                 (c["psnap"], c["points"], c["bms"], 10))
    _equal(got, want, KNN_KEYS)
