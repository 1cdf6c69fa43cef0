"""The insert-slot verify (``ops.verify_slots`` / ``ops.verify_slots_compact``)
against the JAX package and its own plain versions, on the CPU.

The slot entries verify the selected leaves' slots of a slot bank -- a live
delta's per-leaf insert buffers -- and return the per-query counts, so the
engine gathers no (M, T*B, ...) plane and recounts nothing. What each test
holds, exactly (verification only compares floats and ANDs words):

* the plain versions ``skr_verify_slots_ref`` / ``skr_verify_slots_compact_ref``
  equal the JAX package's ``engine._verify_delta_slots`` on seeded deltas
  carried across with ``DeltaBuffer.from_reference_arrays``: ids, counts and
  ``kw_scanned``;
* they equal a gather, ``skr_verify_ref`` / ``skr_verify_compact_ref`` and
  two row sums written out here, on seeded banks with dirty leaf ids, empty
  slots, ``leaf_ok = 0`` rows and W = 1;
* the gathered entries, read as a slot bank through ``identity_leaves``,
  give today's outputs: the int8 match planes and, counted, the ids and
  per-query counts of the unfused verify;
* ``retrieve`` with a delta of each kind (``compact_ok`` true and false),
  under each verify knob, equals the JAX package on every key and dtype,
  and verifies the insert slots with one slot-entry call on the delta's own
  buffers.

Inputs are numpy from a seed: u32 words to JAX, int32 views to the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve import engine  # noqa: E402
from repro_torch.serve.delta import DeltaBuffer  # noqa: E402

from test_torch_cases import (  # noqa: E402
    SLOT_SWEEP, VERIFY_ARGS, VERIFY_COMPACT_ARGS, VERIFY_COMPACT_SWEEP, VERIFY_SWEEP, slot_bank,
    to_torch, verify_case, verify_compact_case,
)
from test_torch_delta import Pair, _reference_fields  # noqa: E402


def _as_np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------- against the JAX package
@pytest.mark.parametrize("own_leaf_terms", [True, False])
def test_slot_plain_versions_match_reference_delta_slots(own_leaf_terms):
    """Both plain versions (and the port's ``_verify_delta_slots``) on a
    seeded delta carried across equal the reference's
    ``_verify_delta_slots``, on the compact words where the delta has them
    and on all W words always."""
    P = Pair(seed=3)
    P.churn(50, 20, own_leaf_terms)
    jbuf = P.jlog.buffer
    buf = DeltaBuffer.from_reference_arrays(_reference_fields(jbuf), jbuf.slots_per_leaf,
                                            device="cpu")
    assert (buf.ins_cbm is not None) == own_leaf_terms
    rng = np.random.default_rng(5)
    wl, _ = P.workload(m=17, seed=9)
    K, M, T = P.snap.n_leaves, 17, 5
    rects = wl.rects.copy()
    rects[::2] = (0.0, 0.0, 1.0, 1.0)  # every keyword hit of these queries matches
    held = np.flatnonzero((buf.ins_id >= 0).any(1).numpy())  # leaves with a buffered insert
    top_leaf = np.where(rng.integers(0, 4, (M, T)) > 0, rng.choice(held, (M, T)),
                        rng.integers(0, K, (M, T))).astype(np.int32)
    leaf_ok = rng.integers(0, 4, (M, T)) > 0
    leaf_ok[-1] = False
    q_rects, q_bm = to_torch(rects), to_torch(wl.kw_bitmap)
    tl, ok8 = to_torch(top_leaf), to_torch(leaf_ok.astype(np.int8))
    q_cbm, q_sig = ops.remap_query_words(q_bm, P.snap.leaf_terms, tl)
    jq_cbm, jq_sig = jops.remap_query_words(jnp.asarray(wl.kw_bitmap),
                                            jnp.asarray(P.jsnap.leaf_terms), jnp.asarray(top_leaf))
    jargs = (jnp.asarray(rects), jnp.asarray(wl.kw_bitmap), jnp.asarray(top_leaf),
             jnp.asarray(leaf_ok), jbuf)
    want_full = jengine._verify_delta_slots(*jargs, None, None)
    got_full = ref.skr_verify_slots_ref(q_rects, q_bm, tl, ok8, buf.ins_x, buf.ins_y, buf.ins_bm,
                                        buf.ins_id)
    cases = [(got_full, want_full),
             (engine._verify_delta_slots(q_rects, q_bm, tl, ok8, buf, None, None), want_full)]
    want_auto = jengine._verify_delta_slots(*jargs, jq_cbm, jq_sig)
    cases.append((engine._verify_delta_slots(q_rects, q_bm, tl, ok8, buf, q_cbm, q_sig),
                  want_auto))
    if own_leaf_terms:
        cases.append((ref.skr_verify_slots_compact_ref(
            q_rects, q_cbm, q_sig, tl, ok8, buf.ins_x, buf.ins_y, buf.ins_cbm, buf.ins_sig,
            buf.ins_id), want_auto))
    for got, want in cases:
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert _as_np(g).dtype == w.dtype and _as_np(g).shape == w.shape
            np.testing.assert_array_equal(_as_np(g), w)
    assert got_full[0].shape == (M, T * buf.slots_per_leaf)
    assert int(got_full[2].sum()) > int(got_full[1].sum()) > 0  # hits outside the rectangles
    assert not got_full[1][-1] and not got_full[2][-1]  # the leaf_ok = 0 row


# ------------------------------------------- against gather + verify + sums
def _gather_verify_count(args, compact):
    """The slot verify written out: clamp and gather the selected slots,
    run the gathered-plane plain version, then sum per query."""
    if compact:
        q_rects, q_cbm, q_sig, top_leaf, leaf_ok, x, y, cbm, sig, sid = args
    else:
        q_rects, q_bm, top_leaf, leaf_ok, x, y, bm, sid = args
    M = top_leaf.shape[0]
    K, B = sid.shape
    safe = top_leaf.clamp(0, K - 1).long()
    cx, cy, cid = (a[safe].reshape(M, -1) for a in (x, y, sid))
    valid = (cid >= 0) & (leaf_ok > 0).repeat_interleave(B, dim=1)
    if compact:
        ccbm, csig = cbm[safe].reshape(M, -1, cbm.shape[2]), sig[safe].reshape(M, -1)
        match = ref.skr_verify_compact_ref(q_rects, q_cbm, q_sig, cx, cy, ccbm, csig,
                                           valid.to(torch.int8))
        kw = (((csig & q_sig.repeat_interleave(B, dim=1)) != 0)
              & ((ccbm & q_cbm.repeat_interleave(B, dim=1)) != 0).any(-1))
    else:
        cbm = bm[safe].reshape(M, -1, bm.shape[2])
        match = ref.skr_verify_ref(q_rects, q_bm, cx, cy, cbm, valid.to(torch.int8))
        kw = ((cbm & q_bm[:, None, :]) != 0).any(-1)
    ids = torch.where(match > 0, cid, -1)
    return (ids, match.to(torch.int32).sum(1, dtype=torch.int32),
            (kw & valid).sum(1, dtype=torch.int32))


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("m,t,k,b,w", SLOT_SWEEP)
def test_slot_entries_equal_gather_verify_and_sums(m, t, k, b, w, compact):
    """The slot entries (their plain versions here: CPU tensors launch
    nothing) equal gather + verify + row sums, output dtypes and shapes
    included."""
    args = slot_bank(np.random.default_rng(m * 613 + t * 37 + k * 5 + b + w), m, t, k, b, w,
                     compact)
    _build.reset_launch_counts()
    got = (ops.verify_slots_compact if compact else ops.verify_slots)(*args)
    assert not any(_build.launch_counts().values())
    want = _gather_verify_count(args, compact)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == wnt.shape
        assert torch.equal(g, wnt)
    assert tuple(got[0].shape) == (m, t * b)
    if m > 1:
        assert not (got[0][-1] >= 0).any() and not got[2][-1]  # the leaf_ok = 0 row


# ------------------------------------------------------- gathered entries
def _random_ids(rng, valid):
    return np.where(valid > 0, rng.integers(0, 1 << 20, valid.shape), -1).astype(np.int32)


@pytest.mark.parametrize("m,c,w", VERIFY_SWEEP)
def test_gathered_full_width_through_identity_leaves(m, c, w):
    rng = np.random.default_rng(m * 31 + c + w)
    case = verify_case(rng, m, c, w)
    args = [to_torch(case[k]) for k in VERIFY_ARGS]
    want = ref.skr_verify_ref(*args)
    # the int8 entry, as the card runs it: the validity plane taken as ids
    top_leaf, leaf_ok = ops.identity_leaves(m, 1, "cpu")
    ids, _, _ = ref.skr_verify_slots_ref(args[0], args[1], top_leaf, leaf_ok, *args[2:5],
                                         ops._valid_as_ids(args[5]))
    assert torch.equal((ids >= 0).to(torch.int8), want)
    assert torch.equal(ops.verify_candidates(*args), want)
    # the counted entry: the unfused verify's ids and per-query counts
    cid = to_torch(_random_ids(rng, case["cand_valid"]))
    ids, n_match, n_kw = ops.verify_candidates_counted(*args[:5], cid)
    assert torch.equal(ids, torch.where(want > 0, cid, -1))
    assert torch.equal(n_match, want.to(torch.int32).sum(1, dtype=torch.int32))
    kw = ((args[4] & args[1][:, None, :]) != 0).any(-1) & (cid >= 0)
    assert torch.equal(n_kw, kw.sum(1, dtype=torch.int32))


@pytest.mark.parametrize("m,t,obj,wl", VERIFY_COMPACT_SWEEP)
def test_gathered_compact_through_identity_leaves(m, t, obj, wl):
    rng = np.random.default_rng(m * 31 + t * 7 + obj + wl)
    case = verify_compact_case(rng, m, t, obj, wl)
    args = [to_torch(case[k]) for k in VERIFY_COMPACT_ARGS]
    want = ref.skr_verify_compact_ref(*args)
    top_leaf, leaf_ok = ops.identity_leaves(m, t, "cpu")
    bank = lambda a: a.reshape(m * t, obj, *a.shape[2:])  # noqa: E731
    ids, _, _ = ref.skr_verify_slots_compact_ref(
        *args[:3], top_leaf, leaf_ok, *(bank(a) for a in args[3:7]),
        bank(ops._valid_as_ids(args[7])))
    assert torch.equal((ids >= 0).to(torch.int8), want)
    assert torch.equal(ops.verify_candidates_compact(*args), want)
    cid = to_torch(_random_ids(rng, case["cand_valid"]))
    ids, n_match, n_kw = ops.verify_candidates_compact_counted(*args[:7], cid)
    assert torch.equal(ids, torch.where(want > 0, cid, -1))
    assert torch.equal(n_match, want.to(torch.int32).sum(1, dtype=torch.int32))
    q_cbm, q_sig, cbm, sig = args[1], args[2], args[5], args[6]
    kw = (((sig & q_sig.repeat_interleave(obj, dim=1)) != 0)
          & ((cbm & q_cbm.repeat_interleave(obj, dim=1)) != 0).any(-1) & (cid >= 0))
    assert torch.equal(n_kw, kw.sum(1, dtype=torch.int32))


# ----------------------------------------------------------------- engine
@pytest.fixture(scope="module", params=[True, False], ids=["compact_ok", "full_width_delta"])
def delta_pair(request):
    P = Pair(seed=4)
    P.churn(60, 25, request.param)
    assert P.log.compact_ok == request.param
    return P


@pytest.mark.parametrize("fused,compact", [(None, None), (False, None), (None, False),
                                           (False, False)])
def test_retrieve_with_delta_matches_reference(delta_pair, monkeypatch, fused, compact):
    """Every key and dtype equal to the JAX package; the insert slots go
    through one slot-entry call that reads the delta's own buffers (no
    gathered plane), on the compact words exactly when both the snapshot's
    compact bank and the delta's remapped words are in play."""
    P = delta_pair
    buf = P.log.buffer
    calls = []
    for name in ("verify_slots", "verify_slots_compact"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=fn: calls.append((_n, a)) or _f(*a))
    wl, jwl = P.workload(m=24, seed=11)
    got = P.skr(wl, jwl, fused=fused, compact=compact)
    want_name = ("verify_slots_compact" if compact is None and buf.ins_cbm is not None
                 else "verify_slots")
    assert [n for n, _ in calls] == [want_name]
    bank = calls[0][1][-4:] if want_name == "verify_slots" else calls[0][1][-5:]
    fields = ((buf.ins_x, buf.ins_y, buf.ins_bm, buf.ins_id) if want_name == "verify_slots"
              else (buf.ins_x, buf.ins_y, buf.ins_cbm, buf.ins_sig, buf.ins_id))
    assert all(a is f for a, f in zip(bank, fields))
    assert got["ids"].dtype == np.int32
