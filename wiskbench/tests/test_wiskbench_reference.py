"""The plain reference against the port's plain path on the CPU, for both
configurations, the leaf count behind ``max_leaves`` against the port's
overflow flags, and the control judged wrong by the harness's check."""
import numpy as np
import pytest

from repro_torch.launch.wisk_serve import serve_batch, serve_knn_batch
from repro_torch.serve.plan import PlanCache
from repro_torch.serve.snapshot import IndexSnapshot
from wiskbench import harness
from wiskbench.gen.pool import make_pool
from wiskbench.reference.knn import KnnReference
from wiskbench.reference.skr import SkrReference
from wiskbench.tools.control import readings
from wiskbench.tools.max_leaves import leaf_keyword_table, leaves_needed

CONFIGS = ["osm1m-str.skr-mix", "osm1m-wisk.skr-mix"]


def _served(cell, seed=123):
    data = harness.make_objects(cell.config, seed)
    ds = harness.to_port_dataset(data)
    index = harness.load_module("indexes", cell.config["index"]["kind"]).build(
        ds, data, cell.config["index"], "cpu")
    return data, index, IndexSnapshot.build(index, ds, device="cpu"), make_pool(cell.traffic, data, seed)


@pytest.mark.parametrize("name", CONFIGS)
def test_skr_reference_equals_the_port(small_cell, name):
    data, _, snap, pool = _served(small_cell(name, n=12_000, batch=96, pool=2))
    ref = SkrReference(data.locs, data.kw_ids)
    cache = PlanCache()
    for q in pool:
        out = serve_batch(snap, q.rects, q.kw_bitmap, 256, plan_cache=cache)
        assert not out["overflow"].any()
        for i, want in enumerate(ref.answers(q.rects, q.kw_ids)):
            got = np.sort(out["ids"][i][out["ids"][i] >= 0])
            assert np.array_equal(got, want) and out["counts"][i] == want.size, i


@pytest.mark.parametrize("name", CONFIGS)
def test_knn_reference_equals_the_port(small_cell, name):
    from wiskbench.drivers.knn_closed import centres

    data, _, snap, pool = _served(small_cell(name, n=12_000, batch=96, pool=2))
    ref = KnnReference(data.locs, data.kw_ids, grid=64)
    cache = PlanCache()
    for q in pool:
        pts = centres(q.rects)
        out = serve_knn_batch(snap, pts, q.kw_bitmap, 10, plan_cache=cache)
        for i in range(q.m):
            ids, d2 = ref.answer(pts[i], q.kw_ids[i], 10)
            n = ids.size
            assert np.array_equal(out["ids"][i][:n], ids) and (out["ids"][i][n:] == -1).all(), i
            assert np.array_equal(out["dist2"][i][:n].view(np.int32), d2.view(np.int32)), i


def test_knn_reference_equals_a_full_scan():
    rng = np.random.default_rng(4)
    locs = rng.uniform(0, 1, (3000, 2)).astype(np.float32)
    locs[:500] = np.round(locs[:500] * 64) / 64  # objects at equal distances
    kw = rng.integers(-1, 20, (3000, 3)).astype(np.int32)
    ref = KnnReference(locs, kw, grid=16)
    for i in range(200):
        p = rng.uniform(0, 1, 2).astype(np.float32) if i % 2 else locs[i]
        q = rng.integers(0, 20, 2)
        hit = np.flatnonzero(np.isin(kw, q).any(1))
        dx, dy = locs[hit, 0] - p[0], locs[hit, 1] - p[1]
        d2 = dx * dx + dy * dy
        order = np.lexsort((hit, d2))[:7]
        ids, got = ref.answer(p, q, 7)
        assert np.array_equal(ids, hit[order]) and np.array_equal(got, d2[order]), i


@pytest.mark.parametrize("name", CONFIGS)
def test_leaf_count_matches_the_ports_overflow(small_cell, name):
    data, index, snap, pool = _served(small_cell(name, n=12_000, batch=128, pool=2))
    table = leaf_keyword_table(index.levels[-1].bitmaps)
    for q in pool:
        need = leaves_needed(index.levels[-1].mbrs, table, q.rects, q.kw_ids)
        cap = max(int(np.median(need)), 1)
        out = serve_batch(snap, q.rects, q.kw_bitmap, cap, plan_cache=PlanCache())
        assert np.array_equal(out["overflow"] > 0, need > cap)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
@pytest.mark.parametrize("name", ["osm1m-str.skr-mix", "osm1m-str.knn-mix"])
def test_the_control_is_judged_wrong(small_cell, name, precision):
    cell = small_cell(name, n=20_000, batch=128, pool=2)
    for seed in (1, 2, 3):
        v = readings(cell, seed, precision)
        assert not v["correct"], v["checks"]
    # the reference in its own precision passes the same check
    assert readings(cell, 1, "f32")["correct"]
