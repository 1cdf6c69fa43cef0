"""The port's Boolean kNN path and f32 full-width descent against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions. Inputs come
from numpy with a seed and go to both packages (u32 words to JAX, their
int32 views to the port).

What each comparison holds:

* Kernel layer: ``knn_frontier_dist(_narrow)`` equal the reference oracles
  ``knn_filter(_narrow)_ref`` and the host ``_mbr_dist2_f32`` bit for bit;
  ``filter_frontier`` equals ``frontier_filter_ref`` and the reference's
  interpret-mode kernel exactly.
* The reference's jitted code runs on XLA's CPU backend, which contracts
  ``dx*dx + dy*dy`` into a fused multiply-add; the port, like the
  reference's op-by-op oracles, does not. So distances out of the
  reference's interpret-mode kNN kernels and its ``retrieve_knn`` are held
  to 1 ulp (``assert_array_max_ulp(..., maxulp=1)``); ids and every
  counter are held exactly.
* ``retrieve_knn`` / ``serve_knn_batch``: the port's ids and distances equal
  the port's host oracles ``knn_query`` and ``knn_level_sync`` exactly.
* SKR with ``quantized=False``, and SKR and kNN on a snapshot without narrow
  planes, equal the default runs and the reference on every key.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.query import (  # noqa: E402
    _mbr_dist2_f32 as j_mbr_dist2_f32, knn_level_sync as jknn_level_sync, knn_query as jknn_query,
)
from repro.core.types import GeoTextDataset as JGeoTextDataset  # noqa: E402
from repro.data.synth import make_dataset as jmake_dataset  # noqa: E402
from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro.serve.plan import pad_knn_queries_to_bucket as jpad_knn  # noqa: E402
from repro_torch.core.query import _mbr_dist2_f32, knn_level_sync, knn_query  # noqa: E402
from repro_torch.core.types import GeoTextDataset  # noqa: E402
from repro_torch.data.synth import make_dataset  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.wisk_serve import serve_knn_batch  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve_knn, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache, pad_knn_queries_to_bucket  # noqa: E402

from test_query_parity import _build_index as _jbuild_index  # noqa: E402
from test_torch_cases import (  # noqa: E402
    FRONTIER_ARGS, FRONTIER_SWEEP, KNN_ARGS, knn_case, to_numpy, to_torch, wide_args,
)
from test_torch_serving import _pair, _port_index  # noqa: E402

_KNN_KEYS = ("ids", "dist2", "nodes_checked", "verified", "leaves_verified", "pruned",
             "frontier_widths")
_SKR_KEYS = ("ids", "counts", "nodes_checked", "nodes_scanned", "verified", "overflow",
             "frontier_widths")
_NARROW = ("level_mbr_codes", "level_dict_x", "level_dict_y")
_COMPACT = ("leaf_terms", "leaf_obj_cbm", "leaf_obj_sig")


def _points(wl) -> np.ndarray:
    """Query points: the centres of the workload's rectangles."""
    return np.stack(
        [(wl.rects[:, 0] + wl.rects[:, 2]) / 2, (wl.rects[:, 1] + wl.rects[:, 3]) / 2], 1
    ).astype(np.float32)


def _same(got, want, keys, ulp_keys=()):
    """Every key equal in dtype and shape; values exact, or within 1 ulp for
    ``ulp_keys`` (XLA's CPU backend fuses dx*dx + dy*dy into an FMA)."""
    assert set(got) == set(want), (set(got), set(want))
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        if k in ulp_keys:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _same_knn(got, want):
    keys = _KNN_KEYS + (("knn_dtype_retried",) if "knn_dtype_retried" in want else ())
    _same(got, want, keys, ulp_keys=("dist2",))


def _matches_oracles(out, index, ds, points, bms, k):
    """Port ids and distances equal the port's host oracles bit for bit."""
    sync = knn_level_sync(index, ds, points, bms, k)
    np.testing.assert_array_equal(out["ids"], sync["ids"])
    for q in range(points.shape[0]):
        r = knn_query(index, ds, points[q], bms[q], k)
        row = out["ids"][q]
        np.testing.assert_array_equal(row[row >= 0], r.ids)
        np.testing.assert_array_equal(out["dist2"][q][: r.ids.size], r.dist2)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP)
def test_knn_dist_matches_reference(m, f, w):
    """Port (plain) narrow and f32 distances: bit-exact against the
    reference oracles and the host distance; 1 ulp against the reference's
    interpret-mode kernels (jitted, so FMA-contracted on the CPU)."""
    case, wide = knn_case(np.random.default_rng(m * 7919 + f * 31 + w + 1), m, f, w)
    nargs = [case[k] for k in KNN_ARGS]
    wargs = wide_args(case, wide, "q_pts")
    narrow = ops.knn_frontier_dist_narrow(*map(to_torch, nargs))
    full = ops.knn_frontier_dist(*map(to_torch, wargs))
    assert narrow.dtype == full.dtype == torch.float32 and tuple(narrow.shape) == (m, f)
    narrow, full = to_numpy(narrow), to_numpy(full)
    np.testing.assert_array_equal(narrow, full)
    np.testing.assert_array_equal(narrow, np.asarray(jref.knn_filter_narrow_ref(*map(jnp.asarray, nargs))))
    np.testing.assert_array_equal(full, np.asarray(jref.knn_filter_ref(*map(jnp.asarray, wargs))))
    host = _mbr_dist2_f32(wide[1], case["q_pts"][:, None, :])
    np.testing.assert_array_equal(host, j_mbr_dist2_f32(wide[1], case["q_pts"][:, None, :]))
    fin = np.isfinite(full)
    np.testing.assert_array_equal(full[fin], host[fin])
    if m > 1:
        assert not fin[-1].any()  # the all-invalid row
    np.testing.assert_array_max_ulp(narrow, np.asarray(jops.knn_frontier_dist_narrow(*nargs)), maxulp=1)
    np.testing.assert_array_max_ulp(full, np.asarray(jops.knn_frontier_dist(*wargs)), maxulp=1)


@pytest.mark.parametrize("m,f,w", FRONTIER_SWEEP)
def test_filter_frontier_matches_reference(m, f, w):
    """The f32 full-width frontier filter (plain): exact against the
    reference oracle, its interpret-mode kernel and the port's narrow
    filter on the same planes."""
    case, wide = knn_case(np.random.default_rng(m * 7919 + f * 31 + w + 2), m, f, w)
    wargs = wide_args(case, wide)
    got = ops.filter_frontier(*map(to_torch, wargs))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, f)
    got = to_numpy(got)
    np.testing.assert_array_equal(got, np.asarray(jref.frontier_filter_ref(*map(jnp.asarray, wargs))))
    np.testing.assert_array_equal(got, np.asarray(jops.filter_frontier(*wargs)))
    narrow = ops.filter_frontier_narrow(*[to_torch(case[k]) for k in FRONTIER_ARGS])
    np.testing.assert_array_equal(got, to_numpy(narrow))


def test_cpu_tensors_never_launch_the_new_kernels():
    _build.reset_launch_counts()
    case, wide = knn_case(np.random.default_rng(4), 4, 9, 2)
    nargs = [to_torch(case[k]) for k in KNN_ARGS]
    wargs = [to_torch(a) for a in wide_args(case, wide, "q_pts")]
    assert torch.equal(ops.knn_frontier_dist_narrow(*nargs), ref.knn_filter_narrow_ref(*nargs))
    assert torch.equal(ops.knn_frontier_dist(*wargs), ref.knn_filter_ref(*wargs))
    wargs[0] = to_torch(case["q_rects"])
    assert torch.equal(ops.filter_frontier(*wargs), ref.frontier_filter_ref(*wargs))
    assert not any(_build.launch_counts().values())


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def layout():
    """A 3-level grid layout served by both packages, 20 MIX queries."""
    index, ds, jindex, jds = _pair("grid", "fs", 2500, 5, g=8, levels=3)
    wl = make_workload(ds, m=20, dist="MIX", seed=6)
    jwl = jmake_workload(jds, m=20, dist="MIX", seed=6)
    return dict(index=index, ds=ds, jindex=jindex, jds=jds, points=_points(wl),
                bms=wl.kw_bitmap, jpoints=_points(jwl), jbms=jwl.kw_bitmap,
                snap=IndexSnapshot.build(index, ds, device="cpu"),
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds))


@pytest.mark.parametrize("compact", [None, False])
@pytest.mark.parametrize("k", [1, 4, 100])
def test_retrieve_knn_matches_reference_and_oracles(layout, k, compact):
    L = layout
    got = retrieve_knn(L["snap"], L["points"], L["bms"], k, plan_cache=PlanCache(), compact=compact)
    want = jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], k, plan_cache=JPlanCache(),
                                compact=compact)
    _same_knn(got, want)
    assert got["frontier_widths"].shape == (L["index"].height,)
    _matches_oracles(got, L["index"], L["ds"], L["points"], L["bms"], k)
    if k == 4:
        assert got["pruned"].sum() > 0  # the bound fires on this layout


def test_host_knn_oracles_match_reference(layout):
    L = layout
    got = knn_level_sync(L["index"], L["ds"], L["points"], L["bms"], 7)
    want = jknn_level_sync(L["jindex"], L["jds"], L["jpoints"], L["jbms"], 7)
    _same(got, want, list(want))
    for q in range(6):
        a = knn_query(L["index"], L["ds"], L["points"][q], L["bms"][q], 7)
        b = jknn_query(L["jindex"], L["jds"], L["jpoints"][q], L["jbms"][q], 7)
        for f in ("ids", "dist2", "nodes_accessed", "verified"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_knn_cached_widths_and_poisoned_cache_retry_match_reference(layout):
    """Cached-width batches and an exact retry after every width is
    poisoned to 1 give the reference's outputs and re-learn its widths."""
    L = layout
    cache, jcache = PlanCache(), JPlanCache()
    for _ in range(2):
        got = retrieve_knn(L["snap"], L["points"], L["bms"], 5, plan_cache=cache)
        want = jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], 5, plan_cache=jcache)
        _same_knn(got, want)
    learned = dict(cache.widths)
    assert learned == dict(jcache.widths) and cache.plan("knn", 2).widths is not None
    for c in (cache, jcache):
        for key in list(c.widths):
            c.widths[key] = 1
    got = retrieve_knn(L["snap"], L["points"], L["bms"], 5, plan_cache=cache)
    _same_knn(got, jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], 5, plan_cache=jcache))
    assert dict(cache.widths) == learned == dict(jcache.widths)


def test_knn_bf16_sweep_matches_reference_and_f32(layout):
    L = layout
    for k in (1, 10):
        f32 = retrieve_knn(L["snap"], L["points"], L["bms"], k, plan_cache=PlanCache())
        got = retrieve_knn(L["snap"], L["points"], L["bms"], k, plan_cache=PlanCache(),
                           knn_dtype="bf16")
        want = jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], k,
                                    plan_cache=JPlanCache(), knn_dtype="bf16")
        _same_knn(got, want)
        np.testing.assert_array_equal(got["ids"], f32["ids"])
        np.testing.assert_array_equal(got["dist2"], f32["dist2"])
        assert "knn_dtype_retried" not in f32
    with pytest.raises(ValueError, match="knn_dtype"):
        retrieve_knn(L["snap"], L["points"], L["bms"], 5, knn_dtype="f16")


def test_knn_bf16_forced_retry_matches_reference(layout, monkeypatch):
    """A risk tolerance of 100 % makes every prune risky, so both packages
    must retry the batch in exact f32 and flag it."""
    L = layout
    f32 = retrieve_knn(L["snap"], L["points"], L["bms"], 3, plan_cache=PlanCache())
    assert f32["pruned"].sum() > 0
    monkeypatch.setattr(engine, "_BF16_RISK_TOL", 1.0)
    monkeypatch.setattr(jengine, "_BF16_RISK_TOL", 1.0)
    got = retrieve_knn(L["snap"], L["points"], L["bms"], 3, plan_cache=PlanCache(),
                       knn_dtype="bf16")
    want = jengine.retrieve_knn(L["jsnap"], L["jpoints"], L["jbms"], 3,
                                plan_cache=JPlanCache(), knn_dtype="bf16")
    assert got["knn_dtype_retried"] is True and want["knn_dtype_retried"] is True
    _same_knn(got, want)
    np.testing.assert_array_equal(got["ids"], f32["ids"])
    np.testing.assert_array_equal(got["dist2"], f32["dist2"])


def test_knn_distance_ties_break_by_smallest_id():
    """Objects at identical coordinates straddle the k boundary: the port
    keeps the smallest ids, like the reference and the host oracle."""
    ds0, jds0 = make_dataset("fs", n=1200, seed=7), jmake_dataset("fs", n=1200, seed=7)
    locs = ds0.locs.copy()
    locs[100:140] = locs[100]  # 40 objects, one exact location
    locs[300:310] = locs[300]
    ds = GeoTextDataset.from_ids(locs, ds0.kw_ids, ds0.vocab_size)
    jds = JGeoTextDataset.from_ids(locs, jds0.kw_ids, jds0.vocab_size)
    index = _port_index(ds, g=6, levels=2)
    snap = IndexSnapshot.build(index, ds, device="cpu")
    jsnap = jsnapshot.IndexSnapshot.build(_jbuild_index(jds, 6, 2)[0], jds)
    pts = locs[100:101].astype(np.float32)
    kw_bm = np.bitwise_or.reduce(ds.kw_bitmap[100:140], axis=0)[None, :]
    for k in (3, 10, 39):
        got = retrieve_knn(snap, pts, kw_bm, k, plan_cache=PlanCache())
        _same_knn(got, jengine.retrieve_knn(jsnap, pts, kw_bm, k, plan_cache=JPlanCache()))
        _matches_oracles(got, index, ds, pts, kw_bm, k)
        row = got["ids"][0]
        assert np.array_equal(np.sort(row[row >= 0]), row[row >= 0])


def test_serve_knn_batch_pads_and_empty_keywords_match_reference(layout):
    """13 queries pad to the 16-bucket and slice back; an empty-keyword
    query and the pads verify nothing and return all -1."""
    L = layout
    pts, bms = L["points"][:13], L["bms"][:13].copy()
    bms[4] = 0
    for got, want in zip(pad_knn_queries_to_bucket(pts, bms), jpad_knn(pts, bms)):
        np.testing.assert_array_equal(got, want)
    got = serve_knn_batch(L["snap"], pts, bms, k=7, plan_cache=PlanCache())
    want = jserve.serve_knn_batch(L["jsnap"], pts, bms, k=7, plan_cache=JPlanCache())
    _same_knn(got, want)
    assert got["ids"].shape == (13, 7)
    assert (got["ids"][4] == -1).all() and got["verified"][4] == 0
    assert got["leaves_verified"][4] == 0
    _matches_oracles(got, L["index"], L["ds"], pts, bms, 7)
    none = retrieve_knn(L["snap"], pts, bms, 0)
    _same(none, jengine.retrieve_knn(L["jsnap"], pts, bms, 0), _KNN_KEYS)


def test_knn_live_delta_raises(layout):
    """Live deltas are served (tests/test_torch_delta.py); a delta that is
    not a ``DeltaBuffer`` raises."""
    L = layout
    with pytest.raises(TypeError, match="DeltaBuffer"):
        retrieve_knn(L["snap"], L["points"], L["bms"], 3, delta=object())
    with pytest.raises(TypeError, match="DeltaBuffer"):
        serve_knn_batch(L["snap"], L["points"], L["bms"], 3, delta=object())


# ------------------------------------------------------- the f32 descent
def _stripped(jsnap, names):
    """The port's and the reference's snapshot without the ``names`` fields
    (narrow planes: empty lists; compact bank: None), carried across with
    ``from_reference_arrays``."""
    js = dataclasses.replace(
        jsnap, **{n: ([] if n in _NARROW else None) for n in names})
    fields = {}
    for name in jsnapshot._ARRAY_FIELDS:
        v = getattr(js, name)
        fields[name] = [np.asarray(a) for a in v] if isinstance(v, list) else (
            None if v is None else np.asarray(v))
    return IndexSnapshot.from_reference_arrays(fields, js.obj_per_leaf, device="cpu"), js


@pytest.mark.parametrize("how", ["quantized=False", "no narrow planes"])
def test_skr_f32_descent_matches_default_and_reference(layout, how):
    L = layout
    wl = make_workload(L["ds"], m=16, dist="MIX", seed=3)
    jwl = jmake_workload(L["jds"], m=16, dist="MIX", seed=3)
    k = L["index"].levels[-1].n
    default = retrieve_workload(L["snap"], wl, max_leaves=k, plan_cache=PlanCache())
    if how == "quantized=False":
        snap, jsnap, kw = L["snap"], L["jsnap"], dict(quantized=False)
    else:
        (snap, jsnap), kw = _stripped(L["jsnap"], _NARROW), {}
        assert not snap.has_narrow_planes
    _build.reset_launch_counts()
    got = retrieve_workload(snap, wl, max_leaves=k, plan_cache=PlanCache(), **kw)
    assert not any(_build.launch_counts().values())
    _same(got, default, _SKR_KEYS)
    _same(got, jengine.retrieve_workload(jsnap, jwl, max_leaves=k, plan_cache=JPlanCache(), **kw),
          _SKR_KEYS)


@pytest.mark.parametrize("how", ["quantized=False", "no narrow planes", "no compact bank"])
def test_knn_f32_descent_and_full_width_bank_match_default_and_reference(layout, how):
    L = layout
    default = retrieve_knn(L["snap"], L["points"], L["bms"], 6, plan_cache=PlanCache())
    if how == "quantized=False":
        snap, jsnap, kw = L["snap"], L["jsnap"], dict(quantized=False)
    else:
        (snap, jsnap), kw = _stripped(L["jsnap"], _NARROW if how == "no narrow planes"
                                      else _COMPACT), {}
    got = retrieve_knn(snap, L["points"], L["bms"], 6, plan_cache=PlanCache(), **kw)
    _same(got, default, _KNN_KEYS)
    _same_knn(got, jengine.retrieve_knn(jsnap, L["jpoints"], L["jbms"], 6,
                                        plan_cache=JPlanCache(), **kw))
