"""The port's dense A/B scan (``retrieve(mode="dense")``) against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions. Inputs come
from numpy with a seed and go to both packages (u32 words to JAX, their
int32 views to the port). Every comparison is exact: the dense path only
compares floats and ANDs words.

* Kernel layer: ``filter_pairs`` equals the reference's Pallas wrapper
  (interpret mode) and its oracle ``skr_filter_ref`` over ragged sweeps
  with ``NEVER_RECT`` nodes, empty bitmaps and zero-area rectangles, in one
  chunk and in many, and at the CUDA kernel's edges (node runs and strips,
  W of 1 and 2,100, sparse words); ``padded_tile_len`` equals the
  reference's.
* Snapshot: ``IndexSnapshot.build(..., dense=True)`` equals the JAX
  snapshot's ``child_matrix`` field for field, and
  ``from_reference_arrays`` carries it across.
* Engine: dense ``retrieve`` and ``serve_batch(mode="dense")`` equal the
  reference on every key and dtype, with and without a live delta, under
  ``fused`` and ``compact``, and with a ``max_leaves`` that overflows; the
  result sets and ``overflow`` equal the frontier run's, and ids equal
  ``execute_serial``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro.serve import delta as jdelta, engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.core.query import execute_serial  # noqa: E402
from repro_torch.data.workloads import make_update_stream, make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.wisk_serve import serve_batch  # noqa: E402
from repro_torch.serve.delta import DeltaLog  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FILTER_ARGS, FILTER_RAGGED, FILTER_SWEEP, filter_case, to_numpy, to_torch,
)
from test_torch_knn import _same  # noqa: E402
from test_torch_serving import _assert_matches_oracle, _pair  # noqa: E402

_DENSE_KEYS = ("ids", "counts", "nodes_checked", "nodes_scanned", "verified", "overflow")


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("m,k,w", FILTER_SWEEP)
def test_filter_pairs_matches_reference(m, k, w):
    case = filter_case(np.random.default_rng(m * 7919 + k * 31 + w), m, k, w)
    args = [case[a] for a in FILTER_ARGS]
    got = ops.filter_pairs(*map(to_torch, args))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, k)
    got = to_numpy(got)
    np.testing.assert_array_equal(got, np.asarray(jref.skr_filter_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(got, np.asarray(jops.filter_pairs(*args)))
    if k > 1:
        assert not got[:, 0].any() and not got[:, -1].any()  # NEVER_RECT, empty node bitmap
    if m > 1:
        assert not got[-1].any()  # the empty query bitmap


@pytest.mark.parametrize("m,k,w,sparse", FILTER_RAGGED)
def test_filter_pairs_ragged_matches_reference(m, k, w, sparse):
    """The redesigned kernel's edges -- node counts off its 16-node runs
    and 512-node strips, W = 1 and W past a compaction round, sparse words,
    ``NEVER_RECT`` nodes and queries with no word -- on the plain version
    against the reference's Pallas wrapper and oracle."""
    case = filter_case(np.random.default_rng(m * 7919 + k * 31 + w), m, k, w, sparse)
    args = [case[a] for a in FILTER_ARGS]
    got = ops.filter_pairs(*map(to_torch, args))
    assert got.dtype == torch.int8 and tuple(got.shape) == (m, k)
    got = to_numpy(got)
    np.testing.assert_array_equal(got, np.asarray(jref.skr_filter_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(got, np.asarray(jops.filter_pairs(*args)))
    # the corner query hits its node where the node has a word; the wordless one never hits
    assert got[0, k // 2] == case["n_bm"][k // 2].any() and not got[-1].any()


def test_filter_pairs_in_chunks_equals_one_pass(monkeypatch):
    """The plain version's query chunks (one query at a time here) give the
    unchunked answer."""
    case = filter_case(np.random.default_rng(3), 33, 257, 8)
    args = [to_torch(case[a]) for a in FILTER_ARGS]
    whole = ref.skr_filter_ref(*args)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 1)
    assert torch.equal(ref.skr_filter_ref(*args), whole)
    assert whole.any()


@pytest.mark.parametrize("n", [0, 1, 7, 128, 129, 7832])
def test_padded_tile_len_matches_reference(n):
    assert ops.padded_tile_len(n) == jops.padded_tile_len(n)


def test_cpu_tensors_never_launch_the_filter_kernel():
    _build.reset_launch_counts()
    case = filter_case(np.random.default_rng(4), 5, 9, 2)
    args = [to_torch(case[a]) for a in FILTER_ARGS]
    assert torch.equal(ops.filter_pairs(*args), ref.skr_filter_ref(*args))
    assert not any(_build.launch_counts().values())


# ---------------------------------------------------------------- snapshot
@pytest.fixture(scope="module")
def layout():
    """An STR layout (3 levels) served by both packages with dense snapshots."""
    index, ds, jindex, jds = _pair("str", "sp", 2000, 7, leaf_size=32, fanout=4)
    return dict(index=index, ds=ds, jindex=jindex, jds=jds,
                wl=make_workload(ds, m=20, dist="MIX", seed=4),
                jwl=jmake_workload(jds, m=20, dist="MIX", seed=4),
                snap=IndexSnapshot.build(index, ds, device="cpu", dense=True),
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds, dense=True),
                k=index.levels[-1].n)


def _reference_fields(js):
    return {name: [np.asarray(a) for a in v] if isinstance(v, list) else (
        None if v is None else np.asarray(v))
        for name, v in ((n, getattr(js, n)) for n in jsnapshot._ARRAY_FIELDS)}


def test_dense_snapshot_matches_reference(layout):
    L = layout
    ts, js = L["snap"], L["jsnap"]
    assert len(ts.child_matrix) == len(js.child_matrix) == L["index"].height - 1
    for got, want in zip(ts.child_matrix, js.child_matrix):
        want = np.asarray(want)
        assert got.dtype == torch.int8 and want.dtype == np.int8
        np.testing.assert_array_equal(to_numpy(got), want)
        assert (want.sum(axis=0) == 1).all()  # every child has one parent
    carried = IndexSnapshot.from_reference_arrays(_reference_fields(js), js.obj_per_leaf,
                                                  device="cpu")
    for got, want in zip(carried.child_matrix, ts.child_matrix):
        assert torch.equal(got, want)
    plain = IndexSnapshot.build(L["index"], L["ds"], device="cpu")
    assert plain.child_matrix == []
    assert ts.nbytes() - plain.nbytes() == sum(m.numel() for m in ts.child_matrix)
    assert carried.nbytes() == ts.nbytes()


# ----------------------------------------------------------------- engine
_KNOBS = [dict(), dict(fused=False), dict(compact=False), dict(fused=False, compact=False)]


@pytest.mark.parametrize("kw", _KNOBS, ids=["default", "unfused", "full-width", "both"])
def test_dense_retrieve_matches_reference_frontier_and_oracle(layout, kw):
    L = layout
    got = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], mode="dense", **kw)
    want = jengine.retrieve_workload(L["jsnap"], L["jwl"], max_leaves=L["k"], mode="dense", **kw)
    _same(got, want, _DENSE_KEYS)
    frontier = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache())
    np.testing.assert_array_equal(got["overflow"], frontier["overflow"])
    for q in range(got["ids"].shape[0]):
        a, b = got["ids"][q], frontier["ids"][q]
        np.testing.assert_array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0]))
    assert (got["nodes_scanned"] >= frontier["nodes_scanned"]).all()
    _assert_matches_oracle(got, execute_serial(L["index"], L["ds"], L["wl"]))


@pytest.mark.parametrize("max_leaves", [1, 3])
def test_dense_overflow_and_leaf_order_match_reference(layout, max_leaves):
    """Few leaves per query: the spill and the order of the selected leaves
    (hits by ascending id, then the misses, as ``lax.top_k`` ties) decide
    every id's position."""
    L = layout
    wl = make_workload(L["ds"], m=12, dist="UNI", seed=6, region_frac=0.05)
    jwl = jmake_workload(L["jds"], m=12, dist="UNI", seed=6, region_frac=0.05)
    got = retrieve_workload(L["snap"], wl, max_leaves=max_leaves, mode="dense")
    want = jengine.retrieve_workload(L["jsnap"], jwl, max_leaves=max_leaves, mode="dense")
    _same(got, want, _DENSE_KEYS)
    assert got["overflow"].max() > 0


def test_serve_batch_dense_matches_reference(layout):
    L = layout
    got = serve_batch(L["snap"], L["wl"].rects[:6], L["wl"].kw_bitmap[:6], max_leaves=L["k"],
                      mode="dense")
    want = jserve.serve_batch(L["jsnap"], L["jwl"].rects[:6], L["jwl"].kw_bitmap[:6],
                              max_leaves=L["k"], mode="dense")
    _same(got, want, _DENSE_KEYS)
    assert got["ids"].shape[0] == 6


@pytest.mark.parametrize("own_leaf_terms", [True, False])
@pytest.mark.parametrize("kw", [dict(), dict(fused=False), dict(compact=False)],
                         ids=["default", "unfused", "full-width"])
def test_dense_with_delta_matches_reference(layout, own_leaf_terms, kw):
    """The same inserts and deletes on both packages' ``DeltaLog``: the dense
    scan filters the widened level arrays and verifies the insert slots,
    on the compact words while every inserted term lies in its leaf's
    dictionary, else at full width."""
    L = layout
    log = DeltaLog(L["index"], L["ds"], L["snap"])
    jlog = jdelta.DeltaLog(L["jindex"], L["jds"], L["jsnap"])
    rng = np.random.default_rng(11)
    vocab = (L["index"].levels[-1].mbrs, L["snap"].leaf_terms.numpy()) if own_leaf_terms else ()
    locs, kws = make_update_stream(L["ds"], 40, rng, 0.02, *vocab)
    new = log.insert(locs, kws)
    np.testing.assert_array_equal(new, jlog.insert(locs, kws))
    dels = list(rng.choice(L["ds"].n, 30, replace=False)) + [int(new[0]), int(new[-1])]
    assert log.delete(dels) == jlog.delete(dels)
    assert log.compact_ok == jlog.compact_ok == own_leaf_terms
    got = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], mode="dense",
                            delta=log.buffer, **kw)
    want = jengine.retrieve_workload(L["jsnap"], L["jwl"], max_leaves=L["k"], mode="dense",
                                     delta=jlog.buffer, **kw)
    _same(got, want, _DENSE_KEYS)
    frontier = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache(),
                                 delta=log.buffer)
    for q in range(got["ids"].shape[0]):
        a, b = got["ids"][q], frontier["ids"][q]
        np.testing.assert_array_equal(np.sort(a[a >= 0]), np.sort(b[b >= 0]))


def test_dense_on_a_snapshot_without_child_matrices_raises(layout):
    L = layout
    plain = IndexSnapshot.build(L["index"], L["ds"], device="cpu")
    jplain = jsnapshot.IndexSnapshot.build(L["jindex"], L["jds"])
    with pytest.raises(ValueError, match="dense=True"):
        retrieve_workload(plain, L["wl"], max_leaves=L["k"], mode="dense")
    with pytest.raises(ValueError, match="dense=True"):
        jengine.retrieve_workload(jplain, L["jwl"], max_leaves=L["k"], mode="dense")
