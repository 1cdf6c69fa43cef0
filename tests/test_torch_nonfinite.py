"""The port's serving paths against the JAX package at non-finite queries.

Twenty MIX queries on a three-level grid layout, six of them with NaN or
infinite coordinates (``with_nonfinite``: a NaN edge, an all-NaN
rectangle, the whole plane, an infinite edge, a rectangle at +inf, a -inf
edge; points with NaN or infinite coordinates). On the CPU the port runs its
plain versions; the reference runs its Pallas kernels in interpret mode.
SKR (``retrieve``, both modes and both leaf banks) equals the reference on
every output key, dtype and shape; kNN (``retrieve_knn``, both descents and
both banks) equals it on ids and counters, and on ``dist2`` to 1 ulp where
finite (XLA contracts ``dx*dx + dy*dy`` into an FMA on the CPU) and exactly
where not. ``tests/test_torch_cuda.py`` holds the card's kernels to the
plain versions at the same rows.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import with_nonfinite  # noqa: E402
from test_torch_serving import _pair  # noqa: E402

_KNN_COUNTERS = ("nodes_checked", "verified", "leaves_verified", "pruned", "frontier_widths")


def _points(rects):
    return np.stack([(rects[:, 0] + rects[:, 2]) / 2, (rects[:, 1] + rects[:, 3]) / 2],
                    1).astype(np.float32)


@pytest.fixture(scope="module")
def layout():
    """ROADMAP C.2's probe: the 3-level grid layout of ``test_torch_knn``,
    20 MIX queries, rectangles and points with non-finite rows, snapshots
    with the dense child matrices."""
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    wl = make_workload(ds, m=20, dist="MIX", seed=6)
    jwl = jmake_workload(jds, m=20, dist="MIX", seed=6)
    np.testing.assert_array_equal(wl.rects, jwl.rects)
    np.testing.assert_array_equal(wl.kw_bitmap, jwl.kw_bitmap)
    rects = with_nonfinite(wl.rects)
    return dict(index=index, rects=rects, points=with_nonfinite(_points(wl.rects)),
                bms=wl.kw_bitmap, snap=IndexSnapshot.build(index, ds, device="cpu", dense=True),
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds, dense=True))


def test_nonfinite_rows_are_written(layout):
    rects, points = layout["rects"], layout["points"]
    bad_r = ~np.isfinite(rects).all(1)
    bad_p = ~np.isfinite(points).all(1)
    assert bad_r.sum() == bad_p.sum() == 6 and np.isnan(rects).any() and np.isinf(points).any()


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("mode", ["frontier", "dense"])
def test_retrieve_at_nonfinite_rects_matches_reference(layout, mode, compact):
    L = layout
    n_leaves = L["index"].levels[-1].n
    got = retrieve(L["snap"], L["rects"], L["bms"], n_leaves, mode=mode, plan_cache=PlanCache(),
                   compact=compact)
    want = jengine.retrieve(L["jsnap"], L["rects"], L["bms"], n_leaves, mode=mode,
                            plan_cache=JPlanCache(), compact=compact)
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    bad = ~np.isfinite(L["rects"]).all(1)
    nan = np.isnan(L["rects"]).any(1)
    assert not (got["ids"][nan] >= 0).any()  # a NaN edge meets nothing
    assert (got["ids"][bad & ~nan] >= 0).any()  # the whole plane meets the keyword matches


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("quantized", [None, False])
def test_retrieve_knn_at_nonfinite_points_matches_reference(layout, quantized, compact):
    L = layout
    got = retrieve_knn(L["snap"], L["points"], L["bms"], 4, plan_cache=PlanCache(),
                       quantized=quantized, compact=compact)
    want = jengine.retrieve_knn(L["jsnap"], L["points"], L["bms"], 4, plan_cache=JPlanCache(),
                                quantized=quantized, compact=compact)
    assert set(got) == set(want)
    for k in ("ids",) + _KNN_COUNTERS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    g, w = np.asarray(got["dist2"]), np.asarray(want["dist2"])
    assert g.dtype == w.dtype and g.shape == w.shape
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), fin)
    np.testing.assert_array_equal(g[~fin], w[~fin])  # NaN equal to NaN, infinities equal
    np.testing.assert_array_max_ulp(g[fin], w[fin], maxulp=1)
