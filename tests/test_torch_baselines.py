"""The port's baselines against the JAX package's, bit for bit.

Flood-T, LSTI, TFI (``baselines/learned.py``) and the CDIR packing
(``baselines/conventional.py``) are host numpy in both packages, so every
array they make is equal: the index levels (``mbrs``, ``bitmaps``,
``child_ptr``, ``child``), the inverted file, the ``meta`` names and the
cluster assignments, and ``execute_serial``'s (or ``tfi_query``'s)
``QueryStats`` on a served workload -- ``nodes_accessed``, ``verified``,
``results`` and ``cost``. Each case runs at two seeds.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.baselines import conventional as jconv  # noqa: E402
from repro.baselines import learned as jlearned  # noqa: E402
from repro.core.query import execute_serial as jexecute_serial  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro_torch.baselines import conventional as tconv  # noqa: E402
from repro_torch.baselines import learned as tlearned  # noqa: E402
from repro_torch.core.query import execute_serial  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402

SEEDS = (0, 1)


@pytest.fixture(scope="module", params=SEEDS)
def data(request):
    seed = request.param
    ds, jds = make_dataset("fs", n=1200, seed=seed), jmake_dataset("fs", n=1200, seed=seed)
    wl = make_workload(ds, m=24, dist="MIX", seed=seed + 10)
    jwl = jmake_workload(jds, m=24, dist="MIX", seed=seed + 10)
    return ds, wl, jds, jwl


def assert_stats_equal(got, want):
    for f in ("nodes_accessed", "verified", "cost"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got.results) == len(want.results)
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a, b)


def assert_index_equal(got, want, ds, wl, jds, jwl):
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.clusters.assign, want.clusters.assign)
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        for f in ("mbrs", "bitmaps", "child_ptr", "child"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    for f in ("kw_ptr", "kw", "obj_ptr", "obj"):
        np.testing.assert_array_equal(getattr(got.inv, f), getattr(want.inv, f), err_msg=f)
    assert_stats_equal(execute_serial(got, ds, wl), jexecute_serial(want, jds, jwl))


def test_floodt_matches_reference(data):
    ds, wl, jds, jwl = data
    got, want = tlearned.build_floodt(ds, wl), jlearned.build_floodt(jds, jwl)
    assert got.meta["name"].startswith("flood-t")
    assert_index_equal(got, want, ds, wl, jds, jwl)


@pytest.mark.parametrize("max_error", [64, 256])
def test_lsti_matches_reference(data, max_error):
    ds, wl, jds, jwl = data
    got, want = tlearned.build_lsti(ds, max_error), jlearned.build_lsti(jds, max_error)
    assert got.clusters.k == -(-ds.n // max_error)
    assert_index_equal(got, want, ds, wl, jds, jwl)


def test_zorder_matches_reference(data):
    ds, wl, *_ = data
    for pts in (ds.locs, wl.rects[:, :2], wl.rects[:, 2:],
                np.array([[0, 0], [1, 1], [0.5, 0.25]], np.float32)):
        got, want = tlearned._zorder(pts), jlearned._zorder(pts)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


def test_tfi_matches_reference(data):
    ds, wl, jds, jwl = data
    got, want = tlearned.build_tfi(ds), jlearned.build_tfi(jds)
    for f in ("kw_ptr", "obj", "code"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.dataset_n == want.dataset_n and got.nbytes() == want.nbytes()
    stats = tlearned.tfi_query(got, ds, wl)
    assert_stats_equal(stats, jlearned.tfi_query(want, jds, jwl))
    assert sum(r.size for r in stats.results) > 0


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_cdir_packing_matches_reference(data, alpha):
    ds, wl, jds, jwl = data
    clusters = tlearned.build_lsti(ds, 12).clusters  # 100 bottom clusters: two packed levels
    jclusters = jlearned.build_lsti(jds, 12).clusters
    got = tconv.cdir_pack_hierarchy(clusters, alpha=alpha)
    want = jconv.cdir_pack_hierarchy(jclusters, alpha=alpha)
    assert len(got.parents) == len(want.parents) == 2
    for a, b in zip(got.parents, want.parents):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert_index_equal(tconv.build_cdir_over_clusters(ds, clusters, alpha),
                       jconv.build_cdir_over_clusters(jds, jclusters, alpha), ds, wl, jds, jwl)
