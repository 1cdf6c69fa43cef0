"""The subscription match's pairs entry (``ops.match_subscription_pairs``) against the JAX package.

On the CPU the entry runs its plain version ``ref.sub_match_pairs_ref``,
which keeps the kernel's contract (a buffer of ``capacity`` pairs and the
count of all matches), through the same capacity retry the card runs. The
same seeded objects and subscriptions go to the reference; every comparison
is exact: matching only compares floats and ANDs words.

* Kernel layer: the pairs, in canonical order, equal the nonzero entries of
  the reference's ``match_subscriptions`` (its Pallas kernel, in interpret
  mode) and of its ``sub_match_ref``, at every capacity -- 0, 1, one short
  of the count, the count, the default -- with a retry exactly when the
  count passes the capacity; matches decided by words past the ones the
  kernel stages per object included; NaN points and rectangle edges,
  which match nothing, on both entries.
* Index: a stream of churn, buffer growth, deletes and ``pump`` through the
  pairs path equals the reference's index and both oracles with capacity 1
  (every batch of two or more matches launches again), while the matrix
  entries and host packing are refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.core.types import ids_to_bitmap  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.subscribe import SubscriptionIndex, canonical_pairs  # noqa: E402

from test_torch_cases import (  # noqa: E402
    SUB_NAN_SWEEP, SUB_PAIRS_SWEEP, late_word_case, nan_case, rand_kw, rand_sub_rect, sub_case,
    to_torch,
)
from test_torch_subscribe import Streams, _logs  # noqa: E402


def _operands(seed, n, s, v, obj_hi):
    """Numpy operands of one case, with the reference's match matrix."""
    locs, okw, rects, kws = sub_case(np.random.default_rng(seed), n, s, v, obj_hi)
    obm = ids_to_bitmap(okw.astype(np.int32), v)
    sbm = ids_to_bitmap(kws.astype(np.int32), v)
    want = np.asarray(jops.match_subscriptions(locs, obm, rects, sbm))
    return (locs, obm, rects, sbm), want


def _sorted(pairs):
    """(n, 2) pairs as numpy rows in (object, slot) order."""
    p = pairs.cpu().numpy()
    return p[np.lexsort((p[:, 1], p[:, 0]))]


def _counted_launches(monkeypatch):
    """Count the launches of the pairs instance (on the CPU, of its plain
    version) that ``match_subscription_pairs`` makes."""
    calls = []
    real = ops._sub_pairs
    monkeypatch.setattr(ops, "_sub_pairs", lambda *a: calls.append(a[-1]) or real(*a))
    return calls


@pytest.mark.parametrize("seed,n,s,v,obj_hi", SUB_PAIRS_SWEEP)
def test_pairs_equal_reference_nonzero(seed, n, s, v, obj_hi):
    args, want = _operands(seed, n, s, v, obj_hi)
    got = ops.match_subscription_pairs(*map(to_torch, args))
    assert got.dtype == torch.int32 and got.shape[1] == 2
    np.testing.assert_array_equal(_sorted(got), np.argwhere(want))
    full = jref.sub_match_ref(*map(jnp.asarray, args))
    np.testing.assert_array_equal(np.argwhere(np.asarray(full)), np.argwhere(want))
    if obj_hi > 32 and args[1].shape[1] > 32:  # an object has more words than are staged
        assert ((args[1] != 0).sum(axis=1) > ops._SUB_OBJECT_PAIRS).any()


@pytest.mark.parametrize("seed,n,s,v,obj_hi", [c for c in SUB_PAIRS_SWEEP if c[0] in (2, 3, 6, 7)])
def test_pairs_at_every_capacity(monkeypatch, seed, n, s, v, obj_hi):
    """Capacity 0, 1, one short of the count, the count, past it and the
    default: the same pairs, with one more launch exactly when the count
    passes the capacity (at the exact count, never truncated)."""
    args, want = _operands(seed, n, s, v, obj_hi)
    count = int(want.sum())
    assert count > 1
    calls = _counted_launches(monkeypatch)
    for cap in (0, 1, count - 1, count, count + 5, None):
        calls.clear()
        got = ops.match_subscription_pairs(*map(to_torch, args), capacity=cap)
        np.testing.assert_array_equal(_sorted(got), np.argwhere(want))
        first = ops.SUB_PAIRS_CAPACITY if cap is None else cap
        assert calls == ([first, count] if count > first else [first]), (cap, calls)
    with pytest.raises(ValueError, match="negative"):
        ops.match_subscription_pairs(*map(to_torch, args), capacity=-1)


@pytest.mark.parametrize("n,s,w", [(40, 60, 40), (9, 300, 256)])
def test_pairs_past_the_staged_words(n, s, w):
    """Matches decided only by an object's words past the ones the kernel
    stages (its first 32 nonzero words) equal the reference's."""
    args = late_word_case(np.random.default_rng(n + s + w), n, s, w)
    want = np.asarray(jops.match_subscriptions(*args))
    assert want.sum() > 0
    got = ops.match_subscription_pairs(*map(to_torch, args))
    np.testing.assert_array_equal(_sorted(got), np.argwhere(want))


@pytest.mark.parametrize("seed,n,s,v", SUB_NAN_SWEEP)
def test_pairs_with_nan_coordinates(seed, n, s, v):
    """NaN points and rectangle edges match nothing, and every other pair
    still matches as the reference's does, on the pairs and matrix entries."""
    locs, okw, rects, kws = nan_case(np.random.default_rng(seed), n, s, v)
    args = (locs, ids_to_bitmap(okw.astype(np.int32), v), rects,
            ids_to_bitmap(kws.astype(np.int32), v))
    want = np.asarray(jops.match_subscriptions(*args))
    assert want.sum() > 0 and not want[np.isnan(locs).any(axis=1)].any()
    got = ops.match_subscription_pairs(*map(to_torch, args))
    np.testing.assert_array_equal(_sorted(got), np.argwhere(want))
    mat = ops.match_subscriptions(args[0], args[1], to_torch(rects), to_torch(args[3]))
    np.testing.assert_array_equal(mat.numpy(), want)


@pytest.mark.parametrize("cap", [0, 1, 5, 1000])
def test_plain_pairs_keep_the_kernel_contract(cap):
    """``sub_match_pairs_ref`` returns a (capacity, 2) buffer whose first
    min(count, capacity) rows are the pairs and the count of all of them."""
    args, want = _operands(3, 130, 129, 200, 4)
    locs, obm, rects, sbm = map(to_torch, args)
    pairs, count = ref.sub_match_pairs_ref(locs, obm, rects, sbm, ref.or_fold(sbm), cap)
    assert pairs.shape == (cap, 2) and pairs.dtype == torch.int32
    assert count.shape == (1,) and int(count) == int(want.sum())
    n = min(cap, int(count))
    np.testing.assert_array_equal(pairs[:n].numpy(), np.argwhere(want)[:n])
    assert not pairs[n:].any()


def test_pairs_edges():
    """No object or no slot: no pair and no launch; a given signature
    equals the folded one; the packed matrix entry agrees."""
    args, want = _operands(2, 40, 13, 64, 4)
    locs, obm, rects, sbm = map(to_torch, args)
    _build.reset_launch_counts()
    for a in ((locs[:0], obm[:0], rects, sbm), (locs, obm, rects[:0], sbm[:0])):
        got = ops.match_subscription_pairs(*a)
        assert got.shape == (0, 2) and got.dtype == torch.int32
    given = ops.match_subscription_pairs(locs, obm, rects, sbm, ref.or_fold(sbm))
    assert torch.equal(given, ops.match_subscription_pairs(locs, obm, rects, sbm))
    mat = ops.match_subscriptions(args[0], args[1], rects, sbm)
    np.testing.assert_array_equal(_sorted(given), torch.nonzero(mat).numpy())
    assert not any(_build.launch_counts().values())


def test_canonical_pairs_order():
    """Pairs in any order come out by object id, then subscription id, a
    repeated object id included; ids past int32 keep their value."""
    found = torch.tensor([[0, 1], [1, 0], [2, 2], [3, 3], [4, 2]], dtype=torch.int32)
    slot_sub = torch.tensor([9, 2, 1, 0], dtype=torch.int32)
    big = 2 ** 40
    got = canonical_pairs(found, np.array([7, 3, 7, 3, big]), slot_sub)
    np.testing.assert_array_equal(got, [[3, 0], [3, 9], [7, 1], [7, 2], [big, 1]])
    assert got.dtype == np.int64
    assert canonical_pairs(found[:0], np.arange(4), slot_sub).shape == (0, 2)


def _refuse(*a, **kw):
    raise AssertionError("the stream ran a matrix entry or packed words on the host")


def test_stream_with_retries_matches_reference(monkeypatch):
    """Churn, buffer growth, deletes and a pump-only twin through the pairs
    path at capacity 1: every batch with two or more matches launches again,
    and the stream equals the reference's index and both oracles; the
    matrix entries and ``pack_query_words`` never run."""
    monkeypatch.setattr(ops, "SUB_PAIRS_CAPACITY", 1)
    for name in ("sub_match", "match_subscriptions", "pack_query_words"):
        monkeypatch.setattr(ops, name, _refuse)
    calls = _counted_launches(monkeypatch)
    rng = np.random.default_rng(13)
    ds, log, jlog = _logs(seed=2)
    st = Streams(ds.vocab_size)
    pumped = SubscriptionIndex(ds.vocab_size, device="cpu")
    hot = int(np.argmax(ds.kw_freq))
    subs = [(rand_sub_rect(rng), rand_kw(rng, ds.vocab_size, lo=1)) for _ in range(12)]
    subs += [((0.0, 0.0, 1.0, 1.0), [hot])] * 3
    for r, kw in subs:
        st.subscribe(r, kw)
        pumped.subscribe(r, kw)
    spot = ds.locs[rng.integers(ds.n)]
    inserted, streams = [], []
    for rnd in range(6):
        n = int(rng.integers(3, 9))
        locs = np.clip(spot[None, :] + rng.normal(0, 1e-3, (n, 2)).astype(np.float32), 0, 1)
        okw = np.stack([rand_kw(rng, ds.vocab_size) for _ in range(n)])
        okw[:, -1] = hot
        ids = log.insert(locs, okw)
        np.testing.assert_array_equal(ids, jlog.insert(locs, okw))
        st.arrive(ids, locs, okw)
        pumped.pump(log)
        assert st.port.pump(log) == 0 and st.jax.pump(jlog) == 0
        inserted.extend(int(i) for i in ids)
        if rnd == 2:
            for sid in (0, 5, 12):
                st.unsubscribe(sid)
                pumped.unsubscribe(sid)
            r, kw = (0.0, 0.0, 1.0, 1.0), [hot]
            assert st.subscribe(r, kw) == pumped.subscribe(r, kw)
        if rnd >= 3:
            dels = rng.choice(inserted, size=2, replace=False)
            assert log.delete(dels) == jlog.delete(dels)
            inserted = [i for i in inserted if i not in set(int(d) for d in dels)]
            streams.append(st.drain())
    assert log.buffer.slots_per_leaf == jlog.buffer.slots_per_leaf > 4
    got = np.concatenate(streams + [st.drain()])
    assert got.shape[0] > 0
    np.testing.assert_array_equal(pumped.drain(), got)
    # one launch at capacity 1 per match call, and one more at the exact count
    retries = sum(1 for c in calls if c > 1)
    assert retries >= 6 and calls.count(1) >= 12, calls
