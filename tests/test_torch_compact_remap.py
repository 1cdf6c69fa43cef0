"""The compact fused verify's remapping entry (``ops.fused_verify_leaf_words``)
against the JAX package, on the CPU.

The entry takes the queries' global bitmaps and the leaf dictionaries and
remaps the query words into each selected leaf's vocabulary inside the
kernel (rows 2 and 3 of the port's kernel table), so no fused SKR batch
runs ``ops.remap_query_words``. On the CPU it runs its plain version,
``ref.fused_verify_leaf_words_ref``. What each test holds, exactly (the
remap only moves bits, verification only compares floats and ANDs words):

* ids and ``kwv`` equal the reference's ``remap_query_words`` followed by
  its oracle ``fused_verify_compact_ref`` and by its Pallas wrapper of the
  same variant (interpret mode); with ``words=True`` the returned words
  equal the reference's remap as int32 bit views;
* the same at ragged operands: Wl of 1, 2 and 8, W of 1 and 3, OBJ of 1
  and 37, dirty leaf ids, ``leaf_ok = 0`` rows, a query whose bits meet no
  dictionary, entries past the bitmap's bits and all-``-1`` dictionaries;
* ``retrieve`` with its default knobs and ``fused_variant="vmem"``, and
  ``serve_batch`` with a delta of each kind, never call
  ``ops.remap_query_words`` and equal the JAX package on every key;
  ``fused=False`` still calls it and still matches.

Inputs are numpy from a seed: u32 words to JAX, int32 views to the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.workloads import make_workload as jmake_workload  # noqa: E402
from repro.launch import wisk_serve as jserve  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.serve import engine as jengine, snapshot as jsnapshot  # noqa: E402
from repro.serve.plan import PlanCache as JPlanCache  # noqa: E402
from repro_torch.data.workloads import make_workload  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.launch.wisk_serve import serve_batch  # noqa: E402
from repro_torch.serve.engine import IndexSnapshot, retrieve_workload  # noqa: E402
from repro_torch.serve.plan import PlanCache  # noqa: E402

from test_torch_cases import (  # noqa: E402
    FUSED_SWEEP, REMAP_ARGS, REMAP_SWEEP, fused_case, remap_case, to_numpy, to_torch,
)
from test_torch_delta import Pair  # noqa: E402
from test_torch_knn import _SKR_KEYS, _same  # noqa: E402
from test_torch_serving import _pair  # noqa: E402

_VARIANTS = ("vmem", "prefetch", "auto")


@jax.jit
def _remap_and_verify(q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm,
                      obj_sig, obj_id):
    """The reference's ``remap_query_words``, then its oracle
    ``fused_verify_compact_ref`` on the remapped words (one jitted program:
    one compile per shape)."""
    q_cbm, q_sig = jops.remap_query_words(q_bm, leaf_terms, top_leaf)
    return (q_cbm, q_sig), jref.fused_verify_compact_ref(
        q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id)


def _reference(case):
    """The reference's remap of the case and its compact oracle on it:
    ``(q_cbm, q_sig), (ids, kwv), jargs`` (u32 words), ``jargs`` the
    reference fused verify's operands."""
    (q_cbm, q_sig), out = _remap_and_verify(*(jnp.asarray(case[k]) for k in REMAP_ARGS))
    jargs = (case["q_rects"], q_cbm, q_sig, case["top_leaf"], case["leaf_ok"], case["obj_x"],
             case["obj_y"], case["obj_cbm"], case["obj_sig"], case["obj_id"])
    return (q_cbm, q_sig), out, jargs


def _assert_entry_matches(case, variant):
    """The entry on the case equals the reference, words included; returns
    the port's ``(ids, kwv, q_cbm, q_sig)`` and the reference's ``jargs``."""
    args = [to_torch(case[k]) for k in REMAP_ARGS]
    got = ops.fused_verify_leaf_words(*args, variant=variant, words=True)
    ids, kwv, q_cbm, q_sig = got
    m, t = case["top_leaf"].shape
    k, obj = case["obj_x"].shape
    wl = case["obj_cbm"].shape[2]
    assert all(a.dtype == torch.int32 for a in got)
    assert [tuple(a.shape) for a in got] == [(m, t * obj), (m, t), (m, t, wl), (m, t)]
    (e_cbm, e_sig), (eids, ekwv), jargs = _reference(case)
    np.testing.assert_array_equal(to_numpy(q_cbm), np.asarray(e_cbm).view(np.int32))
    np.testing.assert_array_equal(to_numpy(q_sig), np.asarray(e_sig).view(np.int32))
    np.testing.assert_array_equal(to_numpy(ids), np.asarray(eids))
    np.testing.assert_array_equal(to_numpy(kwv), np.asarray(ekwv))
    # words=False returns the same two outputs alone
    plain = ops.fused_verify_leaf_words(*args, variant=variant)
    assert len(plain) == 2 and torch.equal(plain[0], ids) and torch.equal(plain[1], kwv)
    return got, jargs


@pytest.mark.parametrize("variant", _VARIANTS)
@pytest.mark.parametrize("m,t,k,obj,w,max_kw", [FUSED_SWEEP[1], (6, 3, 5, 24, 8, 200)])
def test_leaf_words_entry_matches_reference(variant, m, t, k, obj, w, max_kw):
    """On encoded leaf banks (``fused_case``; max_kw = 200 gives Wl = 7):
    ids, ``kwv`` and the words equal the reference's remap and oracle, and
    its Pallas kernel of the same variant on the remapped words."""
    case = fused_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + 19), m, t, k,
                      obj, w, max_kw)
    assert (case["obj_cbm"].shape[2] > 1) == (max_kw > 32)
    (ids, kwv, _, _), jargs = _assert_entry_matches(case, variant)
    eids, ekwv = jops.fused_gather_verify_compact(*jargs, variant=variant)
    np.testing.assert_array_equal(to_numpy(ids), np.asarray(eids))
    np.testing.assert_array_equal(to_numpy(kwv), np.asarray(ekwv))


@pytest.mark.parametrize("m,t,k,obj,w,wl", REMAP_SWEEP)
def test_leaf_words_entry_ragged_matches_reference(m, t, k, obj, w, wl):
    """Ragged dictionaries (``remap_case``) under every variant: the same
    ids, counts and words as the reference; the query that meets no
    dictionary has ``q_sig == 0`` and no id in any slot."""
    case = remap_case(np.random.default_rng(m * 613 + t * 37 + k * 5 + obj + w + wl), m, t, k,
                      obj, w, wl)
    lt = case["leaf_terms"]
    assert (lt >= 32 * w).any() and (lt == -1).any()
    if k > 1:
        assert (lt[-1] == -1).all()
    for variant in _VARIANTS:
        (ids, kwv, q_cbm, q_sig), _ = _assert_entry_matches(case, variant)
        if m > 1:
            assert not q_sig[0].any() and not (ids[0] >= 0).any() and not kwv[0].any()
            assert not (ids[-1] >= 0).any() and not kwv[-1].any()  # leaf_ok = 0 only


def test_leaf_words_entry_launches_nothing_on_the_cpu():
    """The CPU entry runs the plain version and moves no launch count; an
    unknown variant is refused."""
    case = remap_case(np.random.default_rng(3), 5, 3, 4, 8, 2, 2)
    args = [to_torch(case[k]) for k in REMAP_ARGS]
    _build.reset_launch_counts()
    for variant in _VARIANTS:
        got = ops.fused_verify_leaf_words(*args, variant=variant, words=True)
        want = ref.fused_verify_leaf_words_ref(*args, words=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert not any(_build.launch_counts().values())
    with pytest.raises(ValueError, match="variant"):
        ops.fused_verify_leaf_words(*args, variant="tiled")


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def layout():
    """An STR layout with a compact bank served by both packages, 20 MIX
    queries."""
    index, ds, jindex, jds = _pair("str", "sp", 2000, 9, leaf_size=32, fanout=4)
    snap = IndexSnapshot.build(index, ds, device="cpu")
    assert snap.has_compact_bank
    return dict(wl=make_workload(ds, m=20, dist="MIX", seed=6),
                jwl=jmake_workload(jds, m=20, dist="MIX", seed=6), snap=snap,
                jsnap=jsnapshot.IndexSnapshot.build(jindex, jds), k=index.levels[-1].n)


def _refuse(*a, **kw):
    raise AssertionError("a fused SKR batch called remap_query_words")


@pytest.mark.parametrize("variant", [None, "vmem", "prefetch"])
def test_fused_retrieve_never_remaps(layout, monkeypatch, variant):
    """``retrieve`` with the fused knob on the compact bank runs the
    remapping entry once and ``remap_query_words`` never; every key equals
    the JAX package's."""
    L = layout
    calls = []
    entry = ops.fused_verify_leaf_words
    monkeypatch.setattr(ops, "remap_query_words", _refuse)
    monkeypatch.setattr(ops, "fused_verify_leaf_words",
                        lambda *a, **kw: calls.append(kw) or entry(*a, **kw))
    got = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache(),
                            fused_variant=variant)
    assert calls == [dict(variant=variant or "auto", words=False)]
    want = jengine.retrieve_workload(L["jsnap"], L["jwl"], max_leaves=L["k"],
                                     plan_cache=JPlanCache(), fused_variant=variant)
    _same(got, want, _SKR_KEYS)


def test_unfused_retrieve_still_remaps(layout, monkeypatch):
    """``fused=False`` gathers candidates and verifies them on the words
    ``remap_query_words`` gives: it is called, and the outputs still equal
    the JAX package's."""
    L = layout
    calls = []
    remap = ops.remap_query_words
    monkeypatch.setattr(ops, "remap_query_words", lambda *a: calls.append(a) or remap(*a))
    monkeypatch.setattr(ops, "fused_verify_leaf_words", _refuse)
    got = retrieve_workload(L["snap"], L["wl"], max_leaves=L["k"], plan_cache=PlanCache(),
                            fused=False)
    assert len(calls) == 1
    want = jengine.retrieve_workload(L["jsnap"], L["jwl"], max_leaves=L["k"],
                                     plan_cache=JPlanCache(), fused=False)
    _same(got, want, _SKR_KEYS)


@pytest.mark.parametrize("own_leaf_terms", [True, False], ids=["log_a", "log_b"])
def test_fused_delta_batch_never_remaps(monkeypatch, own_leaf_terms):
    """``serve_batch`` with a delta: a log-A-like delta (compact insert
    bitmaps) takes the remapped words from the fused kernel
    (``words=True``) into the compact slot verify, a log-B-like one asks for
    none; ``remap_query_words`` never runs and every key equals the JAX
    package's ``serve_batch``."""
    P = Pair(seed=6)
    P.churn(50, 20, own_leaf_terms)
    buf = P.log.buffer
    assert (buf.ins_cbm is not None) == own_leaf_terms
    calls, slots = [], []
    entry, slot_entry = ops.fused_verify_leaf_words, ops.verify_slots_compact
    monkeypatch.setattr(ops, "remap_query_words", _refuse)

    def record(*a, **kw):
        out = entry(*a, **kw)
        calls.append((kw, out))
        return out

    monkeypatch.setattr(ops, "fused_verify_leaf_words", record)
    monkeypatch.setattr(ops, "verify_slots_compact",
                        lambda *a: slots.append(a) or slot_entry(*a))
    wl, jwl = P.workload(m=24, seed=13)
    k = P.index.levels[-1].n
    got = serve_batch(P.snap, wl.rects, wl.kw_bitmap, k, plan_cache=PlanCache(), delta=buf)
    want = jserve.serve_batch(P.jsnap, jwl.rects, jwl.kw_bitmap, k, plan_cache=JPlanCache(),
                              delta=P.jlog.buffer)
    _same(got, want, [k for k in _SKR_KEYS if k in want])
    assert [kw for kw, _ in calls] == [dict(variant="auto", words=own_leaf_terms)]
    assert len(slots) == int(own_leaf_terms)
    if own_leaf_terms:  # the slot verify read the fused kernel's own words
        assert slots[0][1] is calls[0][1][2] and slots[0][2] is calls[0][1][3]
