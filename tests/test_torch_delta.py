"""The port's live-update layer (``serve/delta.py``) against the JAX package.

The same inserts and deletes go to the port's ``DeltaLog`` and the
reference's, over the same grid index (numpy inputs from a seed; u32 words
to JAX, int32 views to the port). What each comparison holds:

* the buffers are equal field for field -- ``slots_per_leaf``,
  ``compact_ok``, every tensor, ``merged_dataset()`` -- and a reference
  buffer carried across with ``DeltaBuffer.from_reference_arrays`` equals
  the port's own;
* SKR and kNN served with the delta equal the reference on every key and
  dtype (kNN ``dist2`` to 1 ulp: the reference's jitted distances are
  FMA-contracted on the CPU, ROADMAP §C), before and after ``compact_ok``
  flips, under growth by doubling and churn, with a leaf whose objects are
  all deleted, in bf16, and through ``serve_batch_cached``;
* SKR ids equal a cold rebuild over ``merged_dataset()``, and kNN ids and
  distances equal the host oracle ``knn_query`` over that rebuild, exactly;
* an empty delta is inert, and a buffer handed out keeps its answer after
  later updates.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro.serve import delta as jdelta, engine as jengine  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro.serve.snapshot import IndexSnapshot as JSnapshot  # noqa: E402
from repro_torch.core.query import execute_serial, knn_query  # noqa: E402
from repro_torch.data.workloads import make_update_stream, make_workload  # noqa: E402
from repro_torch.launch.wisk_serve import (  # noqa: E402
    HotQueryCache, serve_batch, serve_batch_cached, serve_knn_batch,
)
from repro_torch.serve import delta  # noqa: E402
from repro_torch.serve.delta import DeltaBuffer, DeltaLog  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_knn import _KNN_KEYS, _SKR_KEYS, _points, _same, _same_knn  # noqa: E402
from test_torch_serving import _pair, _port_index  # noqa: E402


class Pair:
    """One index served by both packages, with a ``DeltaLog`` on each side
    that every update goes to."""

    def __init__(self, n=1200, seed=0, g=6, slots_per_leaf=delta.MIN_SLOTS_PER_LEAF):
        self.index, self.ds, jindex, self.jds = _pair("grid", "fs", n, seed, g=g, levels=2)
        self.g = g
        self.snap = IndexSnapshot.build(self.index, self.ds, device="cpu")
        self.jsnap = JSnapshot.build(jindex, self.jds)
        self.log = DeltaLog(self.index, self.ds, self.snap, slots_per_leaf)
        self.jlog = jdelta.DeltaLog(jindex, self.jds, self.jsnap, slots_per_leaf)
        self.rng = np.random.default_rng(seed + 100)

    def insert(self, n, own_leaf_terms, jitter=0.02, locs=None):
        if locs is None:
            locs, kw = make_update_stream(self.ds, n, self.rng, jitter,
                                          *self._leaf_vocab(own_leaf_terms))
        else:
            kw = self.ds.kw_ids[self.rng.choice(self.ds.n, len(locs))]
        ids = self.log.insert(locs, kw)
        np.testing.assert_array_equal(ids, self.jlog.insert(locs, kw))
        return ids

    def _leaf_vocab(self, own_leaf_terms):
        return (self.index.levels[-1].mbrs, self.snap.leaf_terms.numpy()) if own_leaf_terms else ()

    def delete(self, ids):
        assert self.log.delete(ids) == self.jlog.delete(ids)

    def churn(self, n_ins, n_del, own_leaf_terms):
        """Inserts, then base deletes and the first and last new ids."""
        new = self.insert(n_ins, own_leaf_terms)
        self.delete(list(self.rng.choice(self.ds.n, n_del, replace=False))
                    + [int(new[0]), int(new[-1])])

    def workload(self, m=20, seed=7):
        return (make_workload(self.ds, m=m, dist="MIX", seed=seed),
                jmake_workload(self.jds, m=m, dist="MIX", seed=seed))

    def skr(self, wl, jwl, **kw):
        k = self.index.levels[-1].n
        got = retrieve(self.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(),
                       delta=self.log.buffer, **kw)
        want = jengine.retrieve(self.jsnap, jwl.rects, jwl.kw_bitmap, k, plan_cache=JPlanCache(),
                                delta=self.jlog.buffer, **kw)
        _same(got, want, _SKR_KEYS)
        return got

    def knn(self, wl, jwl, k=7, **kw):
        got = retrieve_knn(self.snap, _points(wl), wl.kw_bitmap, k, plan_cache=PlanCache(),
                           delta=self.log.buffer, **kw)
        want = jengine.retrieve_knn(self.jsnap, _points(jwl), jwl.kw_bitmap, k,
                                    plan_cache=JPlanCache(), delta=self.jlog.buffer, **kw)
        _same_knn(got, want)
        return got

    def cold(self):
        """(index, dataset, snapshot) of a from-scratch build over the merged data."""
        merged = self.log.merged_dataset()
        index = _port_index(merged, self.g, 2)
        return index, merged, IndexSnapshot.build(index, merged, device="cpu")


def _as_numpy(t, like):
    a = t.numpy()
    return a.view(np.uint32) if np.asarray(like).dtype == np.uint32 else a


def _buffers_equal(buf, jbuf):
    assert buf.slots_per_leaf == jbuf.slots_per_leaf
    for name in delta.ARRAY_FIELDS:
        got, want = getattr(buf, name), getattr(jbuf, name)
        if want is None:
            assert got is None, name
            continue
        pairs = zip(got, want) if isinstance(want, list) else [(got, want)]
        for g, w in pairs:
            w = np.asarray(w)
            np.testing.assert_array_equal(_as_numpy(g, w), w, err_msg=name)
            assert _as_numpy(g, w).dtype == w.dtype, name


def _reference_fields(jbuf):
    out = {}
    for name in delta.ARRAY_FIELDS:
        v = getattr(jbuf, name)
        out[name] = None if v is None else (
            [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v))
    return out


def _sorted_rows(ids):
    return [np.sort(r[r >= 0]) for r in ids]


# ---------------------------------------------------------------- the log
@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_delta_log_matches_reference(own_leaf_terms):
    P = Pair(seed=1)
    P.churn(40, 30, own_leaf_terms)
    P.delete([10 ** 9, -5, 3])  # unknown ids are ignored
    assert P.log.compact_ok == P.jlog.compact_ok == own_leaf_terms
    _buffers_equal(P.log.buffer, P.jlog.buffer)
    assert P.log.n_updates() == P.jlog.n_updates()
    assert P.log.buffer.n_buffered() == P.jlog.buffer.n_buffered() == 38
    assert P.log.buffer.n_deleted() == P.jlog.buffer.n_deleted() == 31
    merged, jmerged = P.log.merged_dataset(), P.jlog.merged_dataset()
    for f in ("locs", "kw_ids", "kw_bitmap"):
        np.testing.assert_array_equal(getattr(merged, f), getattr(jmerged, f), err_msg=f)
    assert merged.vocab_size == jmerged.vocab_size
    np.testing.assert_array_equal(P.log.merged_assignment(), P.jlog.merged_assignment())
    carried = DeltaBuffer.from_reference_arrays(
        _reference_fields(P.jlog.buffer), P.jlog.buffer.slots_per_leaf, device="cpu")
    _buffers_equal(carried, P.jlog.buffer)
    wl, jwl = P.workload()
    got = P.skr(wl, jwl)
    _same(retrieve(P.snap, wl.rects, wl.kw_bitmap, P.index.levels[-1].n, plan_cache=PlanCache(),
                   delta=carried), got, _SKR_KEYS)


def test_parent_chains_and_insert_remap_match_reference():
    P = Pair(seed=2)
    for a, b in zip(delta.parent_chains(P.index), jdelta.parent_chains(P.jlog.index)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    terms = P.snap.leaf_terms.numpy()
    for i in range(12):
        bm = P.ds.kw_bitmap[rng.integers(P.ds.n)]
        lt = terms[rng.integers(terms.shape[0])]
        for x, y in zip(delta._remap_insert_bitmap(bm, lt), jdelta._remap_insert_bitmap(bm, lt)):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------- serving
_SKR_KNOBS = [dict(), dict(fused=False), dict(compact=False),
              dict(compact=False, fused_variant="vmem"), dict(fused=False, compact=False)]


@pytest.mark.parametrize("own_leaf_terms", [True, False])
@pytest.mark.parametrize("knob", range(len(_SKR_KNOBS)))
def test_skr_with_delta_matches_reference_and_cold_rebuild(own_leaf_terms, knob):
    P = Pair(seed=0)
    P.churn(40, 30, own_leaf_terms)
    assert P.log.compact_ok == own_leaf_terms
    wl, jwl = P.workload(m=24)
    got = P.skr(wl, jwl, **_SKR_KNOBS[knob])
    T = min(P.index.levels[-1].n, int(got["frontier_widths"][-1]))  # leaf slots selected
    assert got["ids"].shape == (24, T * (P.snap.obj_per_leaf + P.log.buffer.slots_per_leaf))
    index, merged, cold = P.cold()
    want = retrieve(cold, wl.rects, wl.kw_bitmap, index.levels[-1].n, plan_cache=PlanCache())
    st = execute_serial(index, merged, wl)
    for q, (a, b) in enumerate(zip(_sorted_rows(got["ids"]), _sorted_rows(want["ids"]))):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.sort(st.results[q]))


def test_compact_ok_flip_matches_reference():
    """Inserts whose terms lie in their leaves' dictionaries keep the compact
    insert slots; the first foreign term drops them for good, and both
    packages serve identically on either side of the flip."""
    P = Pair(seed=3)
    P.churn(30, 10, own_leaf_terms=True)
    wl, jwl = P.workload(seed=9)
    assert P.log.compact_ok and P.log.buffer.ins_cbm is not None
    before = P.skr(wl, jwl)
    P.knn(wl, jwl)
    P.churn(30, 10, own_leaf_terms=False)
    assert not P.log.compact_ok and P.log.buffer.ins_cbm is None
    assert not P.jlog.compact_ok
    after = P.skr(wl, jwl)
    P.knn(wl, jwl)
    P.insert(5, own_leaf_terms=True)  # sticky: stays off
    assert not P.log.compact_ok and P.log.buffer.ins_cbm is None
    assert before["ids"].shape == after["ids"].shape


@pytest.mark.parametrize("own_leaf_terms", [True, False])
@pytest.mark.parametrize("compact", [None, False])
def test_knn_with_delta_matches_reference_and_oracle(own_leaf_terms, compact):
    P = Pair(seed=4)
    P.churn(40, 30, own_leaf_terms)
    wl, jwl = P.workload(m=16, seed=5)
    for k in (1, 10):
        got = P.knn(wl, jwl, k=k, compact=compact)
        index, merged, _ = P.cold()
        pts = _points(wl)
        for q in range(wl.m):
            r = knn_query(index, merged, pts[q], wl.kw_bitmap[q], k)
            row = got["ids"][q]
            np.testing.assert_array_equal(row[row >= 0], r.ids)
            np.testing.assert_array_equal(got["dist2"][q][: r.ids.size], r.dist2)


def test_growth_by_doubling_under_churn_matches_reference():
    """Inserts aimed at one spot overflow a leaf's slots more than once,
    with deletes freeing slots in between: buffers and results equal the
    reference after every round, and every round matches a cold rebuild."""
    P = Pair(n=1000, seed=6, g=5, slots_per_leaf=4)
    spot = P.ds.locs[P.rng.integers(P.ds.n)]
    grown, alive = [P.log.buffer.slots_per_leaf], []
    for rnd in range(4):
        locs = np.clip(spot[None, :] + P.rng.normal(0, 1e-3, (12, 2)), 0, 1).astype(np.float32)
        alive += [int(i) for i in P.insert(12, False, locs=locs)]
        if rnd:
            dels = [int(d) for d in P.rng.choice(alive, 4, replace=False)]
            P.delete(dels)
            alive = [i for i in alive if i not in dels]
        _buffers_equal(P.log.buffer, P.jlog.buffer)
        if P.log.buffer.slots_per_leaf != grown[-1]:
            grown.append(P.log.buffer.slots_per_leaf)
        wl, jwl = P.workload(m=8, seed=13 + rnd)
        got = P.skr(wl, jwl)
        P.knn(wl, jwl, k=5)
        index, merged, cold = P.cold()
        want = retrieve(cold, wl.rects, wl.kw_bitmap, index.levels[-1].n, plan_cache=PlanCache())
        for a, b in zip(_sorted_rows(got["ids"]), _sorted_rows(want["ids"])):
            np.testing.assert_array_equal(a, b)
    assert len(grown) >= 3, grown


def test_leaf_with_every_object_deleted_matches_reference():
    P = Pair(n=800, seed=4, g=4)
    members = P.index.clusters.order[P.index.clusters.offsets[0]: P.index.clusters.offsets[1]]
    P.delete(members)
    assert int(P.log.buffer.base_alive[0, : members.size].sum()) == 0
    wl, jwl = P.workload(m=16, seed=11)
    for knob in ({}, dict(fused=False), dict(compact=False, fused=False)):
        got = P.skr(wl, jwl, **knob)
        assert not np.isin(got["ids"], members).any()
    got = P.knn(wl, jwl, k=20)
    assert not np.isin(got["ids"], members).any()


def test_empty_delta_is_inert():
    """An all-empty buffer gives the plain results: equal rows, counters and
    kNN outputs, and the reference's outputs on every key."""
    P = Pair(n=1000, seed=2, g=5)
    wl, jwl = P.workload(m=16, seed=5)
    empty = DeltaBuffer.empty(P.snap)
    assert empty.n_buffered() == empty.n_deleted() == 0
    assert all(a is b for a, b in zip(empty.aug_mbrs, P.snap.level_mbrs))
    k = P.index.levels[-1].n
    base = retrieve(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache())
    with_d = P.skr(wl, jwl)  # the log's buffer is still empty
    for a, b in zip(_sorted_rows(base["ids"]), _sorted_rows(with_d["ids"])):
        np.testing.assert_array_equal(a, b)
    for key in ("counts", "nodes_checked", "verified", "overflow", "frontier_widths"):
        np.testing.assert_array_equal(base[key], with_d[key], err_msg=key)
    pts = _points(wl)
    _same(retrieve_knn(P.snap, pts, wl.kw_bitmap, 6, plan_cache=PlanCache(), delta=empty),
          retrieve_knn(P.snap, pts, wl.kw_bitmap, 6, plan_cache=PlanCache()), _KNN_KEYS)


def test_bf16_with_delta_matches_reference_and_f32():
    P = Pair(seed=5)
    P.churn(40, 20, own_leaf_terms=False)
    wl, jwl = P.workload(m=16, seed=3)
    for k in (1, 8):
        got = P.knn(wl, jwl, k=k, knn_dtype="bf16")
        f32 = P.knn(wl, jwl, k=k)
        np.testing.assert_array_equal(got["ids"], f32["ids"])
        np.testing.assert_array_equal(got["dist2"], f32["dist2"])


def test_front_doors_with_delta_match_reference():
    """``serve_batch`` (pads to the bucket), ``serve_knn_batch`` and
    ``serve_batch_cached`` take the delta and equal the reference's front
    doors."""
    P = Pair(seed=6)
    P.churn(40, 30, own_leaf_terms=True)
    wl, jwl = P.workload(m=13, seed=2)
    k = P.index.levels[-1].n
    got = serve_batch(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(),
                      delta=P.log.buffer)
    want = jserve.serve_batch(P.jsnap, jwl.rects, jwl.kw_bitmap, k, plan_cache=JPlanCache(),
                              delta=P.jlog.buffer)
    _same(got, want, _SKR_KEYS)
    got = serve_knn_batch(P.snap, _points(wl), wl.kw_bitmap, 9, plan_cache=PlanCache(),
                          delta=P.log.buffer)
    _same_knn(got, jserve.serve_knn_batch(P.jsnap, _points(jwl), jwl.kw_bitmap, 9,
                                          plan_cache=JPlanCache(), delta=P.jlog.buffer))
    order = np.array([0, 1, 0, 2, 1, 3])
    outs = []
    for serve, snap, buf, w, cache, plans in (
        (serve_batch_cached, P.snap, P.log.buffer, wl, HotQueryCache(8), PlanCache()),
        (jserve.serve_batch_cached, P.jsnap, P.jlog.buffer, jwl, jserve.HotQueryCache(8),
         JPlanCache()),
    ):
        serve(snap, w.rects[:2], w.kw_bitmap[:2], cache, max_leaves=k, plan_cache=plans,
              delta=buf)
        outs.append(serve(snap, w.rects[order], w.kw_bitmap[order], cache, max_leaves=k,
                          plan_cache=plans, delta=buf))
    for key in _SKR_KEYS[:-1] + ("cached",):
        np.testing.assert_array_equal(outs[0][key], outs[1][key], err_msg=key)
        assert outs[0][key].dtype == outs[1][key].dtype


def test_old_buffer_keeps_its_answer():
    """A buffer handed out before later updates is never written to: it
    still gives its earlier answer, while the new buffer sees the insert."""
    P = Pair(seed=7)
    P.churn(30, 20, own_leaf_terms=True)
    old = P.log.buffer
    frozen = {name: [t.clone() for t in getattr(old, name)] if name.startswith("aug") else
              getattr(old, name).clone() for name in delta.ARRAY_FIELDS}
    wl, _ = P.workload(m=12, seed=4)
    k = P.index.levels[-1].n
    before = retrieve(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(), delta=old)
    # a new object inside query 0's rectangle carrying its keywords, and a delete
    q = wl.rects[0]
    loc = np.array([[(q[0] + q[2]) / 2, (q[1] + q[3]) / 2]], np.float32)
    kw = np.full((1, P.ds.kw_ids.shape[1]), -1, np.int32)
    kw[0, 0] = np.flatnonzero(np.unpackbits(wl.kw_bitmap[0].view(np.uint8), bitorder="little"))[0]
    new_id = int(P.log.insert(loc, kw)[0])
    P.log.delete([int(before["ids"][0][before["ids"][0] >= 0][0])]
                 if (before["ids"][0] >= 0).any() else [0])
    assert P.log.buffer is not old
    for name, want in frozen.items():
        got = getattr(old, name)
        for g, w in zip(got, want) if isinstance(want, list) else [(got, want)]:
            assert torch.equal(g, w), name
    again = retrieve(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(), delta=old)
    _same(again, before, _SKR_KEYS)
    now = retrieve(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(), delta=P.log.buffer)
    assert new_id in now["ids"][0] and new_id not in again["ids"][0]


def test_delta_operands_are_checked():
    P = Pair(n=600, seed=8, g=4)
    wl, _ = P.workload(m=4, seed=1)
    with pytest.raises(TypeError, match="DeltaBuffer"):
        retrieve(P.snap, wl.rects, wl.kw_bitmap, 4, delta=object())
    other = IndexSnapshot.build(_port_index(P.ds, 3, 2), P.ds, device="cpu")
    with pytest.raises(ValueError, match="snapshot"):
        retrieve(other, wl.rects, wl.kw_bitmap, 4, delta=P.log.buffer)
    with pytest.raises(ValueError, match="snapshot"):
        retrieve_knn(other, _points(wl), wl.kw_bitmap, 3, delta=P.log.buffer)
