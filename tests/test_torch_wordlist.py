"""The port's packed-word kernels against the JAX package.

Two kernels read full-width bitmap rows only at each query's nonzero words,
packed by ``ops.pack_query_words`` into ``(wids, bits)``:

* ``ops.knn_level_dist``, the f32 kNN descent's filter, which takes one
  level's arrays and the frontier and gathers for itself. It is held against
  the reference's ``knn_frontier_dist`` (interpret mode) on the gathered
  operands to 1 ulp -- the reference's jitted distances are FMA-contracted on
  the CPU, ROADMAP §C -- and against its oracle ``knn_filter_ref`` bit for bit.
* ``ops.fused_gather_verify(..., variant="vmem", q_words=...)``, the
  full-width fused verify's query-tile launch, held against the reference's
  ``fused_gather_verify(variant="vmem")`` and the port's call without
  ``q_words`` exactly.

Cases: padded frontiers, a live delta's widened level arrays, W = 1, a query
with no nonzero word, batches whose nonzero-word count passes the packing's
4-word bucket, and dirty node and leaf ids. Packing is exact by a property
test, and the engine's f32 kNN descent (``quantized=False``, and under a
delta) runs on ``knn_level_dist`` with every output key equal to the
reference's. Inputs come from numpy with a seed (u32 words to JAX, their
int32 views to the port); on the CPU the wrappers run their plain versions.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.query import knn_query  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve_knn  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FUSED_SWEEP, LEVEL_ARGS, LEVEL_SWEEP, fused_case, fused_wide_args, gathered_level, level_case,
    packed_words, term_bitmaps, to_numpy, to_torch, words,
)
from test_torch_delta import Pair  # noqa: E402
from test_torch_knn import _points, _same_knn  # noqa: E402
from test_torch_serving import _pair  # noqa: E402

_FUSED_ARGS = ("q_rects", "q_bm", "top_leaf", "leaf_ok", "obj_x", "obj_y", "obj_bm", "obj_id")


def _check_level_dist(case):
    """``knn_level_dist`` on a level case: equal to the port's and the
    reference's oracle on the gathered operands bit for bit, and to the
    reference's interpret-mode kernel to 1 ulp."""
    got = ops.knn_level_dist(*(to_torch(case[k]) for k in LEVEL_ARGS))
    m, f = case["frontier"].shape
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, f)
    got = to_numpy(got)
    wide = gathered_level(case)
    np.testing.assert_array_equal(got, to_numpy(ops.knn_frontier_dist(*map(to_torch, wide))))
    np.testing.assert_array_equal(got, np.asarray(jref.knn_filter_ref(*map(jnp.asarray, wide))))
    np.testing.assert_array_max_ulp(got, np.asarray(jops.knn_frontier_dist(*wide)), maxulp=1)
    return got


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,f,n,w,q_terms", LEVEL_SWEEP)
def test_knn_level_dist_matches_reference(m, f, n, w, q_terms):
    case = level_case(np.random.default_rng(m * 7919 + f * 31 + n + w), m, f, n, w, q_terms)
    got = _check_level_dist(case)
    fr = case["frontier"]
    assert np.isinf(got[fr < 0]).all()  # padding slots
    if m > 1:
        assert np.isinf(got[0]).all()  # the query with no nonzero word
        assert np.isfinite(got[1:-1]).any()  # and others that hit
    if w > 4 and q_terms is None:
        assert case["q_wids"].shape[1] > 4  # past the packing's 4-word bucket


@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_knn_level_dist_on_a_deltas_widened_levels(own_leaf_terms):
    """Every level of a live delta's insert-widened arrays, at a frontier of
    all its nodes with padding and dirty ids."""
    P = Pair(seed=9)
    P.churn(40, 20, own_leaf_terms)
    buf = P.log.buffer
    rng = np.random.default_rng(12)
    wl = make_workload(P.ds, m=6, dist="MIX", seed=3)
    assert any(not torch.equal(a, b) for a, b in zip(
        buf.aug_mbrs + buf.aug_bms, P.snap.level_mbrs + P.snap.level_bms))  # widened
    for li in range(buf.n_levels):
        mbrs = buf.aug_mbrs[li].numpy()
        bms = buf.aug_bms[li].numpy().view(np.uint32)
        n = mbrs.shape[0]
        frontier = np.tile(np.arange(n + 2, dtype=np.int32), (wl.m, 1))
        frontier[rng.uniform(0, 1, frontier.shape) < 0.25] = -1
        wids, bits = ops.pack_query_words(wl.kw_bitmap)
        _check_level_dist(dict(q_pts=_points(wl), q_bm=wl.kw_bitmap, q_wids=wids, q_bits=bits,
                               level_mbrs=mbrs, level_bms=bms, frontier=frontier))


def _sparse_queries(rng, case, m, terms=3):
    """MIX-like query bitmaps: up to ``terms`` terms each, drawn from the
    terms the leaf bank holds, so hits are common while Wp stays small; the
    first query (of several) has no nonzero word."""
    held = np.flatnonzero(np.unpackbits(
        np.bitwise_or.reduce(case["obj_bm"].reshape(-1, case["obj_bm"].shape[-1]), axis=0)
        .view(np.uint8), bitorder="little"))
    q_bm = term_bitmaps(rng, m, case["obj_bm"].shape[-1], held, 1, terms + 1)
    if m > 1:
        q_bm[0] = 0
    return q_bm


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", FUSED_SWEEP + [(13, 5, 11, 37, 40, 6)])
def test_fused_verify_on_packed_words_matches_reference(m, t, k, obj, w, max_kw, sparse):
    """The query-tile launch's packed words: the same ids and counts as the
    reference's vmem kernel, its oracle, and the port's call on q_bm."""
    rng = np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 11)
    case = fused_case(rng, m, t, k, obj, w, max_kw)
    if sparse:
        case["q_bm"] = _sparse_queries(rng, case, m)
    elif m > 1:
        case["q_bm"][0] = 0
    args = fused_wide_args(case)
    q_words = packed_words(case["q_bm"])
    ids, kwv = ops.fused_gather_verify(*args, variant="vmem", q_words=q_words)
    assert ids.dtype == kwv.dtype == torch.int32
    assert tuple(ids.shape) == (m, t * obj) and tuple(kwv.shape) == (m, t)
    for want in (ops.fused_gather_verify(*args, variant="vmem"), ref.fused_verify_ref(*args)):
        assert torch.equal(ids, want[0]) and torch.equal(kwv, want[1])
    jargs = [case[a] for a in _FUSED_ARGS]
    for eids, ekwv in (jops.fused_gather_verify(*jargs, variant="vmem"),
                       jref.fused_verify_ref(*map(jnp.asarray, jargs))):
        np.testing.assert_array_equal(to_numpy(ids), np.asarray(eids))
        np.testing.assert_array_equal(to_numpy(kwv), np.asarray(ekwv))
    if m > 1:
        assert not kwv[0].any() and (ids[0] < 0).all()  # no nonzero word, no hit
    if w > 4 and not sparse:
        assert q_words[0].shape[1] > 4


def test_cpu_tensors_never_launch_the_packed_word_kernels():
    _build.reset_launch_counts()
    rng = np.random.default_rng(21)
    case = level_case(rng, 4, 9, 5, 2)
    args = [to_torch(case[k]) for k in LEVEL_ARGS]
    assert torch.equal(ops.knn_level_dist(*args), ref.knn_level_dist_ref(*args))
    fcase = fused_case(rng, 3, 2, 4, 8, 2)
    fargs = fused_wide_args(fcase)
    qw = packed_words(fcase["q_bm"])
    got = ops.fused_gather_verify(*fargs, variant="vmem", q_words=qw)
    want = ref.fused_verify_packed_ref(fargs[0], *qw, *fargs[2:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(_build.launch_counts().values())


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), m=st.integers(1, 9), n=st.integers(1, 12),
       w=st.integers(1, 70), zero_share=st.floats(0.0, 1.0), min_bucket=st.sampled_from([1, 2, 4, 8]))
def test_any_over_all_words_equals_any_over_packed_words(seed, m, n, w, zero_share, min_bucket):
    """``OR_w (bm & q) == OR_p (bits & bm[wids])`` for any bitmaps, and the
    packing's shape: Wp a power-of-two bucket of the largest nonzero count,
    at least ``min_bucket`` and at most W, with zero values past each
    query's own count; the reference packs identically."""
    rng = np.random.default_rng(seed)
    q = words(rng, m, w) * (rng.uniform(0, 1, (m, w)) >= zero_share)
    bm = words(rng, n, w)
    wids, bits = ops.pack_query_words(q, min_bucket)
    jwids, jbits = jops.pack_query_words(q, min_bucket)
    np.testing.assert_array_equal(wids, np.asarray(jwids))
    np.testing.assert_array_equal(bits, np.asarray(jbits))
    nnz = (q != 0).sum(axis=1)
    wp = wids.shape[1]
    assert wp <= w and (wp == w or (wp >= max(nnz.max(), 1) and wp >= max(min_bucket, 1)))
    assert (wp & (wp - 1)) == 0 or wp == w
    assert ((bits != 0).sum(axis=1) == nnz).all()
    full = ((bm[None, :, :] & q[:, None, :]) != 0).any(-1)  # (m, n)
    packed = ((bm[:, wids].transpose(1, 0, 2) & bits[:, None, :]) != 0).any(-1)
    np.testing.assert_array_equal(full, packed)
    tq, tbm = to_torch(q), to_torch(bm)
    twids, tbits = to_torch(wids), to_torch(bits)
    assert torch.equal((tbm[None] & tq[:, None]).ne(0).any(-1),
                       (tbm[:, twids.long()].transpose(0, 1) & tbits[:, None]).ne(0).any(-1))


# --------------------------------------------------- the smoke's bound helper
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_helper_counts_only_the_words_a_test_needs():
    """``chip_smoke.needed_words`` on a hand-built query with two nonzero
    words (1 and 3) and three slots: a hit needs its first hit word, a miss
    the query's two nonzero words, an invalid slot none; ``level_bound``
    counts the same words in its bytes."""
    cs = _chip_smoke()
    q = torch.tensor([[0, 0b101, 0, 0b10]], dtype=torch.int32)
    rows = torch.tensor([[5, 4, 0, 2],    # hits at words 1 and 3
                         [7, 2, 9, 1],    # misses: no bit shared
                         [1, 1, 1, 1]],   # would hit, but the slot is invalid
                        dtype=torch.int32)
    live = torch.tensor([[True, True, False]])
    need = cs.needed_words((rows[None] & q[:, None, :]) != 0, live, (q != 0)[:, None, :])
    assert need.tolist() == [[[False, True, False, False], [False, True, False, True],
                              [False, False, False, False]]]
    wids, bits = packed_words(q.numpy().view(np.uint32))
    mbrs = torch.tensor([[0.0, 0.0, 0.5, 0.5]] * 3)
    frontier = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    nbytes, n_ops = cs.level_bound((torch.zeros((1, 2)), wids, bits, mbrs, rows, frontier))
    # point 8, word pairs 1 and 3 (8 each), frontier 12, one MBR 16, three
    # node words 12, out 12
    assert nbytes == 8 + 16 + 12 + 16 + 12 + 12
    assert n_ops == 3 + 11 + 3 * 2


# ----------------------------------------------------------------- engine
def _spy_level_dist(monkeypatch):
    """Route ``ops.knn_level_dist`` through operand checks a CUDA launch
    would make (dtype, shape, contiguity), counting the calls, and make the
    gathered and narrow kNN filters fail if the engine calls them."""
    calls = []
    real = ops.knn_level_dist

    def spy(q_pts, q_wids, q_bits, level_mbrs, level_bms, frontier):
        M, F = frontier.shape
        Wp = q_wids.shape[1]
        N, W = level_bms.shape
        dev = q_pts.device
        for name, t, dtype, shape in (
            ("q_pts", q_pts, torch.float32, (M, 2)), ("q_wids", q_wids, torch.int32, (M, Wp)),
            ("q_bits", q_bits, torch.int32, (M, Wp)),
            ("level_mbrs", level_mbrs, torch.float32, (N, 4)),
            ("level_bms", level_bms, torch.int32, (N, W)),
            ("frontier", frontier, torch.int32, (M, F)),
        ):
            ops._check(name, t, dtype, shape, dev)
        calls.append((M, F, Wp, W))
        return real(q_pts, q_wids, q_bits, level_mbrs, level_bms, frontier)

    def refuse(*a, **kw):
        raise AssertionError("the f32 kNN descent gathered a word plane")

    monkeypatch.setattr(ops, "knn_level_dist", spy)
    monkeypatch.setattr(ops, "knn_frontier_dist", refuse)
    monkeypatch.setattr(ops, "knn_frontier_dist_narrow", refuse)
    return calls


@pytest.mark.parametrize("k", [1, 10])
def test_knn_f32_descent_runs_on_the_level_kernel(monkeypatch, k):
    """``quantized=False``: every level of the probe and the sweep goes
    through ``knn_level_dist``; ids, ``dist2`` (1 ulp) and every counter
    equal the reference's ``retrieve_knn``, and ids and ``dist2`` equal the
    host oracle ``knn_query`` bit for bit."""
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    wl = make_workload(ds, m=20, dist="MIX", seed=6)
    jwl = jmake_workload(jds, m=20, dist="MIX", seed=6)
    snap = IndexSnapshot.build(index, ds, device="cpu")
    calls = _spy_level_dist(monkeypatch)
    got = retrieve_knn(snap, _points(wl), wl.kw_bitmap, k, plan_cache=PlanCache(),
                       quantized=False)
    assert len(calls) >= 2 * index.height
    want = jengine.retrieve_knn(jsnapshot.IndexSnapshot.build(jindex, jds), _points(jwl),
                                jwl.kw_bitmap, k, plan_cache=JPlanCache(), quantized=False)
    _same_knn(got, want)
    pts = _points(wl)
    for q in range(wl.m):
        r = knn_query(index, ds, pts[q], wl.kw_bitmap[q], k)
        row = got["ids"][q]
        np.testing.assert_array_equal(row[row >= 0], r.ids)
        np.testing.assert_array_equal(got["dist2"][q][: r.ids.size], r.dist2)


@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_knn_under_a_delta_runs_on_the_level_kernel(monkeypatch, own_leaf_terms):
    """A live delta (the widened level arrays): kNN through
    ``knn_level_dist`` equals the reference on ids, ``dist2`` (1 ulp) and
    every counter."""
    P = Pair(seed=4)
    P.churn(40, 30, own_leaf_terms)
    wl, jwl = P.workload(m=16, seed=5)
    calls = _spy_level_dist(monkeypatch)
    P.knn(wl, jwl, k=10)
    assert len(calls) >= 2 * P.index.height
