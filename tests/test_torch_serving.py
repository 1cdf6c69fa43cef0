"""The port's serving path against the JAX engine and front door.

``repro_torch.serve.engine.retrieve`` (plain versions on the CPU) must equal
``repro.serve.engine.retrieve`` (Pallas kernels in interpret mode) on every
output key and dtype: grid-built and STR indexes, one to three levels,
``max_leaves`` small enough that ``overflow > 0``, cached-width batches and
a poisoned ``PlanCache`` that forces the exact retry. Result id sets and
the Eq. 1 counters are also held against the host oracle
``execute_serial``. The single-device front door (``serve_batch``,
``serve_batch_cached``, ``MicroBatcher``, ``HotQueryCache``) follows the
spec of tests/test_serve_frontdoor.py and matches the JAX front door.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.query import execute_serial as jexecute_serial  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.baselines.conventional import build_str_rtree as jbuild_str_rtree  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro.serve.engine import IndexSnapshot as JSnapshot, retrieve_workload as jretrieve_workload  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.baselines.conventional import build_str_rtree  # noqa: E402
from repro_torch.core.index import HierarchyResult, assemble_index, flat_index  # noqa: E402
from repro_torch.core.query import execute_serial  # noqa: E402
from repro_torch.core.types import ClusterSet  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch.wisk_serve import (  # noqa: E402
    HotQueryCache, MicroBatcher, serve_batch, serve_batch_cached,
)
from repro_torch.serve.engine import IndexSnapshot, retrieve, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache, pad_queries_to_bucket  # noqa: E402

from test_query_parity import _build_index as _jbuild_index  # noqa: E402

_KEYS = ("ids", "counts", "nodes_checked", "nodes_scanned", "verified", "overflow",
         "frontier_widths")


def _port_index(ds, g=6, levels=2):
    """The port-side twin of test_query_parity._build_index: grid leaves
    grouped spatially, bottom-up, built with the port's own containers."""
    cell = np.minimum((ds.locs * g).astype(np.int32), g - 1)
    _, assign = np.unique(cell[:, 0] * g + cell[:, 1], return_inverse=True)
    clusters = ClusterSet.from_assignment(ds, assign.astype(np.int32))
    if levels == 1:
        return flat_index(ds, clusters)
    parents, mbrs, gg = [], clusters.mbrs, max(2, g // 2)
    for _ in range(levels - 1):
        cent = np.clip((mbrs[:, :2] + mbrs[:, 2:]) / 2, 0.0, 1.0)
        pc = np.minimum((cent * gg).astype(np.int32), gg - 1)
        _, p = np.unique(pc[:, 0] * gg + pc[:, 1], return_inverse=True)
        p = p.astype(np.int32)
        if p.max() + 1 >= mbrs.shape[0]:
            break
        parents.append(p)
        up = np.zeros((int(p.max()) + 1, 4), np.float32)
        for u in range(up.shape[0]):
            mb = mbrs[p == u]
            up[u] = (mb[:, 0].min(), mb[:, 1].min(), mb[:, 2].max(), mb[:, 3].max())
        mbrs, gg = up, max(2, gg // 2)
    return assemble_index(ds, clusters, HierarchyResult(parents=parents) if parents else None)


def _pair(kind, profile, n, seed, **kw):
    """(port index, port dataset, JAX index, JAX dataset) of one layout."""
    ds, jds = make_dataset(profile, n=n, seed=seed), jmake_dataset(profile, n=n, seed=seed)
    if kind == "str":
        return build_str_rtree(ds, **kw), ds, jbuild_str_rtree(jds, **kw), jds
    levels = kw.get("levels", 2)
    if levels == 1:
        from repro.core.index import flat_index as jflat
        from test_query_parity import _grid_clusters

        return _port_index(ds, kw.get("g", 6), 1), ds, jflat(jds, _grid_clusters(jds, kw.get("g", 6))), jds
    return _port_index(ds, kw.get("g", 6), levels), ds, _jbuild_index(jds, kw.get("g", 6), levels)[0], jds


def _assert_same_output(got, want):
    assert set(got) == set(want)
    for k in _KEYS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_matches_oracle(out, st):
    ok = out["overflow"] == 0
    assert ok.any()
    for q in np.flatnonzero(ok):
        row = out["ids"][q]
        np.testing.assert_array_equal(np.sort(row[row >= 0]), np.sort(st.results[q]))
    np.testing.assert_array_equal(out["nodes_checked"][ok], st.nodes_accessed[ok])
    np.testing.assert_array_equal(out["verified"][ok], st.verified[ok])


_CASES = {
    # name: (layout kind, profile, n, seed, layout kwargs, workload kwargs, max_leaves)
    "grid-flat": ("grid", "fs", 1500, 3, dict(g=5, levels=1), dict(m=20), None),
    "grid-2": ("grid", "fs", 1500, 0, dict(g=6, levels=2), dict(m=20), None),
    "grid-3": ("grid", "fs", 2500, 2, dict(g=8, levels=3), dict(m=24), None),
    "str-3": ("str", "sp", 2500, 4, dict(leaf_size=32, fanout=4), dict(m=24), 64),
    "str-overflow": ("str", "osm", 3000, 5, dict(leaf_size=16, fanout=8),
                     dict(m=16, dist="UNI", region_frac=0.05), 3),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_retrieve_matches_reference_and_oracle(name):
    kind, profile, n, seed, lkw, wkw, max_leaves = _CASES[name]
    index, ds, jindex, jds = _pair(kind, profile, n, seed, **lkw)
    wl = make_workload(ds, seed=seed + 10, **wkw)
    jwl = jmake_workload(jds, seed=seed + 10, **wkw)
    max_leaves = max_leaves or index.levels[-1].n
    snap = IndexSnapshot.build(index, ds, device="cpu")
    got = retrieve_workload(snap, wl, max_leaves=max_leaves, plan_cache=PlanCache())
    want = jretrieve_workload(JSnapshot.build(jindex, jds), jwl, max_leaves=max_leaves,
                              plan_cache=JPlanCache())
    _assert_same_output(got, want)
    assert got["frontier_widths"].shape == (index.height,)
    st = execute_serial(index, ds, wl)
    np.testing.assert_array_equal(got["nodes_checked"], st.nodes_accessed)
    if name == "str-overflow":
        assert got["overflow"].min() > 0
        for q, row in enumerate(got["ids"]):  # a spilled query returns a subset
            assert np.isin(row[row >= 0], st.results[q]).all()
    else:
        _assert_matches_oracle(got, st)


def test_execute_serial_matches_reference():
    index, ds, jindex, jds = _pair("str", "osm", 2000, 6, leaf_size=16, fanout=4)
    wl, jwl = make_workload(ds, m=30, seed=1), jmake_workload(jds, m=30, seed=1)
    got, want = execute_serial(index, ds, wl), jexecute_serial(jindex, jds, jwl)
    for f in ("nodes_accessed", "verified", "cost"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a, b)


def test_cached_widths_and_poisoned_cache_retry_match_reference():
    """Second batch in cached mode, then every width poisoned to 1: the port
    and the reference both run the exact retry, return identical outputs
    and re-learn the same widths."""
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    wl = make_workload(ds, m=16, dist="UNI", region_frac=0.2, n_keywords=4, seed=9)
    jwl = jmake_workload(jds, m=16, dist="UNI", region_frac=0.2, n_keywords=4, seed=9)
    k = index.levels[-1].n
    snap, jsnap = IndexSnapshot.build(index, ds, device="cpu"), JSnapshot.build(jindex, jds)
    cache, jcache = PlanCache(), JPlanCache()
    retrieve_workload(snap, wl, max_leaves=k, plan_cache=cache)
    learned = dict(cache.widths)
    assert cache.plan("skr", snap.n_levels - 1).widths is not None
    cached = retrieve_workload(snap, wl, max_leaves=k, plan_cache=cache)
    jretrieve_workload(jsnap, jwl, max_leaves=k, plan_cache=jcache)
    assert dict(jcache.widths) == learned
    _assert_same_output(cached, jretrieve_workload(jsnap, jwl, max_leaves=k, plan_cache=jcache))
    for c in (cache, jcache):
        for key in list(c.widths):
            c.widths[key] = 1
    retried = retrieve_workload(snap, wl, max_leaves=k, plan_cache=cache)
    _assert_same_output(retried, jretrieve_workload(jsnap, jwl, max_leaves=k, plan_cache=jcache))
    assert dict(cache.widths) == learned == dict(jcache.widths)
    _assert_matches_oracle(retried, execute_serial(index, ds, wl))


@pytest.fixture(scope="module")
def served():
    index, ds, jindex, jds = _pair("str", "sp", 2000, 7, leaf_size=32, fanout=4)
    wl = make_workload(ds, m=6, dist="MIX", seed=4)
    jwl = jmake_workload(jds, m=6, dist="MIX", seed=4)
    return (IndexSnapshot.build(index, ds, device="cpu"), JSnapshot.build(jindex, jds),
            wl, jwl, index.levels[-1].n)


def test_variants_give_identical_outputs(served):
    snap, _, wl, _, k = served
    outs = [retrieve_workload(snap, wl, max_leaves=k, plan_cache=PlanCache(), fused_variant=v)
            for v in (None, "auto", "vmem", "prefetch")]
    for out in outs[1:]:
        _assert_same_output(out, outs[0])
    with pytest.raises(ValueError, match="variant"):
        retrieve_workload(snap, wl, max_leaves=k, fused_variant="tiled")


# -------------------------------------------------------------- front door
def test_serve_batch_matches_reference(served):
    """6 queries pad to the 8-bucket and slice back, like the reference."""
    snap, jsnap, wl, jwl, k = served
    got = serve_batch(snap, wl.rects, wl.kw_bitmap, max_leaves=k, plan_cache=PlanCache())
    want = jserve.serve_batch(jsnap, jwl.rects, jwl.kw_bitmap, max_leaves=k, plan_cache=JPlanCache())
    _assert_same_output(got, want)
    assert got["ids"].shape[0] == 6


def test_serve_batch_cached_matches_reference(served):
    snap, jsnap, wl, jwl, k = served
    order = np.array([0, 1, 0, 2, 1, 3])
    outs = []
    for serve_cached, rects, bms, cache, plans in (
        (serve_batch_cached, wl.rects, wl.kw_bitmap, HotQueryCache(8), PlanCache()),
        (jserve.serve_batch_cached, jwl.rects, jwl.kw_bitmap, jserve.HotQueryCache(8), JPlanCache()),
    ):
        first = serve_cached(snap if serve_cached is serve_batch_cached else jsnap,
                             rects[:2], bms[:2], cache, max_leaves=k, plan_cache=plans)
        again = serve_cached(snap if serve_cached is serve_batch_cached else jsnap,
                             rects[order], bms[order], cache, max_leaves=k, plan_cache=plans)
        outs.append((first, again, cache.hits, cache.misses))
    (f, a, hits, misses), (jf, ja, jhits, jmisses) = outs
    for got, want in ((f, jf), (a, ja)):
        for key in _KEYS[:-1] + ("cached",):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    assert (hits, misses) == (jhits, jmisses)
    np.testing.assert_array_equal(a["cached"], [True, True, True, False, True, False])


def _bm(*words):
    b = np.zeros(2, np.uint32)
    for w in words:
        b[w // 32] |= np.uint32(1 << (w % 32))
    return b


def test_hot_query_cache_evicts_lru_not_mru():
    c = HotQueryCache(maxsize=2)
    ra, rb, rc = ([0.1, 0.1, 0.2, 0.2], [0.3, 0.3, 0.4, 0.4], [0.5, 0.5, 0.6, 0.6])
    bm = _bm(3)
    c.put(ra, bm, {"row": "A"})
    c.put(rb, bm, {"row": "B"})
    assert c.get(ra, bm) == {"row": "A"}  # refresh A; B is now LRU
    c.put(rc, bm, {"row": "C"})  # evicts B
    assert len(c) == 2
    assert c.get(rb, bm) is None
    assert c.get(ra, bm) == {"row": "A"} and c.get(rc, bm) == {"row": "C"}
    assert c.hits == 3 and c.misses == 1


def test_hot_query_cache_keys_match_reference():
    """Jitter inside the 1/quant grid folds onto one key, a full cell does
    not, and the port's keys are byte-identical to the reference's."""
    c, jc = HotQueryCache(maxsize=8, quant=4096.0), jserve.HotQueryCache(maxsize=8, quant=4096.0)
    rect = np.array([0.25, 0.25, 0.5, 0.5], np.float32)
    bm = _bm(1, 7)
    for r in (rect, rect + 1e-5, rect + 1.0 / 4096.0):
        assert c.key(r, bm) == jc.key(r, bm)
    assert c.key(rect + 1e-5, bm) == c.key(rect, bm)
    assert c.key(rect + 1.0 / 4096.0, bm) != c.key(rect, bm)
    c.put(rect, bm, {"row": "first"})
    assert c.get(rect, _bm(2)) is None
    c.invalidate()
    assert len(c) == 0 and c.invalidations == 1


def test_micro_batcher_lifecycle(served):
    """Bad flush_at, empty and double flushes, unknown tickets, auto-flush,
    and row parity with one batched call."""
    snap, _, wl, _, k = served
    with pytest.raises(ValueError, match="flush_at"):
        MicroBatcher(snap, max_leaves=k, flush_at=0)
    mb = MicroBatcher(snap, max_leaves=k, flush_at=3, plan_cache=PlanCache())
    assert mb.flush() == 0 and mb.flushes == 0
    tickets = []
    for i in range(6):
        tickets.append(mb.submit(wl.rects[i], wl.kw_bitmap[i]))
        assert mb.pending == (i + 1) % 3
    assert mb.flushes == 2 and mb.served == 6 and mb.flush() == 0
    ref = serve_batch(snap, wl.rects, wl.kw_bitmap, max_leaves=k, plan_cache=PlanCache())
    for i, t in enumerate(tickets):
        row = mb.result(t)
        for key in _KEYS[:-1]:
            np.testing.assert_array_equal(row[key], ref[key][i], err_msg=key)
    with pytest.raises(KeyError):
        mb.result(tickets[0])
    with pytest.raises(KeyError):
        mb.result(10_000)


def test_micro_batcher_with_cache_matches_reference(served):
    snap, jsnap, wl, jwl, k = served
    rows = []
    for snap_, w, Batcher, Cache, Plans in (
        (snap, wl, MicroBatcher, HotQueryCache, PlanCache),
        (jsnap, jwl, jserve.MicroBatcher, jserve.HotQueryCache, JPlanCache),
    ):
        cache = Cache(maxsize=16)
        mb = Batcher(snap_, max_leaves=k, flush_at=64, cache=cache, plan_cache=Plans())
        t1 = mb.submit(w.rects[0], w.kw_bitmap[0])
        mb.flush()
        first = mb.result(t1)
        t2, t3 = mb.submit(w.rects[0], w.kw_bitmap[0]), mb.submit(w.rects[1], w.kw_bitmap[1])
        mb.flush()
        rows.append((first, mb.result(t2), mb.result(t3), cache.hits))
    for got, want in zip(rows[0][:3], rows[1][:3]):
        for key in _KEYS[:-1] + ("cached",):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert bool(rows[0][1]["cached"]) and not bool(rows[0][2]["cached"])
    assert rows[0][3] == rows[1][3] == 1


# ------------------------------------------------------ unported knobs
@pytest.mark.parametrize("knob,match", [(dict(mode="dense"), "dense=True")])
def test_unported_knobs_raise(served, knob, match):
    """Every knob is ported now. The dense A/B scan on a snapshot built
    without ``dense=True`` raises the reference's ``ValueError``, and an
    unknown mode raises too. (The dense scan is held against the reference
    in tests/test_torch_dense.py, the verify knobs and live deltas in
    tests/test_torch_verify.py and tests/test_torch_delta.py.)"""
    snap, jsnap, wl, jwl, k = served
    with pytest.raises(ValueError, match=match):
        retrieve_workload(snap, wl, max_leaves=k, **knob)
    with pytest.raises(ValueError, match=match):
        jretrieve_workload(jsnap, jwl, max_leaves=k, **knob)
    with pytest.raises(ValueError, match="mode"):
        retrieve_workload(snap, wl, mode="sparse")


@pytest.mark.parametrize("strip", [
    dict(level_mbr_codes=[], level_dict_x=[], level_dict_y=[],
         leaf_terms=None, leaf_obj_cbm=None, leaf_obj_sig=None),
    dict(leaf_terms=None, leaf_obj_cbm=None, leaf_obj_sig=None),
])
def test_snapshot_without_narrow_planes_or_compact_bank_raises(served, strip):
    """A snapshot whose leaf dictionaries overflowed (and, in the first case,
    whose coordinate dictionaries did too) no longer raises: it serves
    through the full-width fused verify, to the reference's outputs and
    the full snapshot's, and never launches a kernel on the CPU."""
    snap, jsnap, wl, jwl, k = served
    stripped = dataclasses.replace(snap, **strip)
    jstripped = dataclasses.replace(jsnap, **strip)
    assert not stripped.has_compact_bank and not jstripped.has_compact_bank
    _build.reset_launch_counts()
    got = serve_batch(stripped, wl.rects, wl.kw_bitmap, max_leaves=k, plan_cache=PlanCache())
    assert not any(_build.launch_counts().values())
    _assert_same_output(got, serve_batch(snap, wl.rects, wl.kw_bitmap, max_leaves=k,
                                         plan_cache=PlanCache()))
    _assert_same_output(got, jserve.serve_batch(jstripped, jwl.rects, jwl.kw_bitmap, max_leaves=k,
                                                plan_cache=JPlanCache()))


def test_pad_queries_to_bucket_matches_reference():
    rng = np.random.default_rng(0)
    rects, bms = rng.uniform(0, 1, (5, 4)).astype(np.float32), rng.integers(0, 9, (5, 3)).astype(np.uint32)
    from repro.serve.plan import pad_queries_to_bucket as jpad

    for got, want in zip(pad_queries_to_bucket(rects, bms), jpad(rects, bms)):
        np.testing.assert_array_equal(got, want)


def test_retrieve_takes_int32_bitmap_tensors(served):
    """Bitmaps given as tensors are read as the int32 bit views they are."""
    snap, _, wl, _, k = served
    a = retrieve(snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache())
    b = retrieve(snap, torch.from_numpy(wl.rects), torch.from_numpy(wl.kw_bitmap.view(np.int32)),
                 k, plan_cache=PlanCache())
    _assert_same_output(a, b)
    with pytest.raises(TypeError, match="int32"):
        retrieve(snap, wl.rects, torch.from_numpy(wl.kw_bitmap.astype(np.int64)), k)
