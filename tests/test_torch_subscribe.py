"""The port's standing subscriptions (``serve/subscribe.py``) against the JAX package.

On the CPU the port's match wrapper runs its plain PyTorch version. The
same subscriptions and arrivals go to the port's ``SubscriptionIndex``, the
reference's, and the oracles ``SubscriptionOracle`` /
``match_subscriptions_bruteforce`` (the port's numpy copies and the
reference's), which use set semantics and no bitmaps. Every comparison is
exact: matching only compares floats and ANDs words.

* Kernel layer: ``match_subscriptions`` (packed object words and
  signatures, as the kernel takes them) and the full-width ``sub_match_ref``
  equal the reference's wrapper (interpret mode), its oracle and the
  brute force, with empty keyword sets, zero-area and whole-space rects,
  objects on rectangle corners, in one chunk and in many.
* Index: over one schedule of subscription churn (freed-slot reuse),
  arrivals through a ``DeltaLog`` with buffer growth and deletes, ``pump``
  after ``match_arrivals``, a pump-only twin and repeated drains, the
  notification stream equals the reference's index and both oracles pair
  for pair, and the compiled block equals the reference's field for field.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.query import (  # noqa: E402
    SubscriptionOracle as JOracle, match_subscriptions_bruteforce as jbruteforce,
)
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.serve import delta as jdelta, subscribe as jsubscribe  # noqa: E402
from repro.serve.snapshot import IndexSnapshot as JSnapshot  # noqa: E402
from repro_torch.core.query import SubscriptionOracle, match_subscriptions_bruteforce  # noqa: E402
from repro_torch.core.types import ids_to_bitmap  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.serve.delta import DeltaLog  # noqa: E402
from repro_torch.serve.snapshot import IndexSnapshot  # noqa: E402
from repro_torch.serve.subscribe import SubscriptionIndex  # noqa: E402

from test_torch_cases import SUB_SWEEP, rand_kw, rand_sub_rect, sub_case, to_numpy, to_torch  # noqa: E402
from test_torch_serving import _pair  # noqa: E402


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("seed,n,s,v", SUB_SWEEP)
def test_match_subscriptions_matches_reference_and_bruteforce(seed, n, s, v):
    locs, okw, rects, kws = sub_case(np.random.default_rng(seed), n, s, v)
    obm = ids_to_bitmap(okw.astype(np.int32), v)
    sbm = ids_to_bitmap(kws.astype(np.int32), v)
    got = ops.match_subscriptions(locs, obm, to_torch(rects), to_torch(sbm))
    assert got.dtype == torch.int8 and tuple(got.shape) == (n, s)
    got = to_numpy(got)
    want = match_subscriptions_bruteforce(locs, okw, rects, list(kws))
    np.testing.assert_array_equal(want, jbruteforce(locs, okw, rects, list(kws)))
    np.testing.assert_array_equal(got.astype(bool), want)
    np.testing.assert_array_equal(got, np.asarray(jops.match_subscriptions(locs, obm, rects, sbm)))
    full = ref.sub_match_ref(*map(to_torch, (locs, obm, rects, sbm)))
    np.testing.assert_array_equal(to_numpy(full), got)
    np.testing.assert_array_equal(
        got, np.asarray(jref.sub_match_ref(*map(jnp.asarray, (locs, obm, rects, sbm)))))


def test_match_in_chunks_equals_one_pass(monkeypatch):
    locs, okw, rects, kws = sub_case(np.random.default_rng(3), 130, 129, 200)
    obm = ids_to_bitmap(okw.astype(np.int32), 200)
    sbm = ids_to_bitmap(kws.astype(np.int32), 200)
    packed = ops.match_subscriptions(locs, obm, to_torch(rects), to_torch(sbm))
    full = ref.sub_match_ref(*map(to_torch, (locs, obm, rects, sbm)))
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 1)  # one object at a time
    assert torch.equal(ops.match_subscriptions(locs, obm, to_torch(rects), to_torch(sbm)), packed)
    assert torch.equal(ref.sub_match_ref(*map(to_torch, (locs, obm, rects, sbm))), full)
    assert packed.any()


def test_block_padding_is_inert():
    """Slots past the live fill, and a freed slot, never match, even for
    objects that carry the subscription's keyword everywhere."""
    rng = np.random.default_rng(7)
    v = 40
    idx = SubscriptionIndex(v, device="cpu")
    sid = idx.subscribe((0.0, 0.0, 1.0, 1.0), [0, 1, 2])
    blk = idx.block()
    assert blk.n_slots == 8 and idx.n_live == 1
    locs = rng.random((50, 2)).astype(np.float32)
    okw = np.stack([rand_kw(rng, v) for _ in range(50)])
    okw[:, 0] = 0
    obm = ids_to_bitmap(okw.astype(np.int32), v)
    mat = to_numpy(ops.match_subscriptions(locs, obm, blk.rects, blk.bm, blk.sig[:, 0]))
    assert mat[:, 1:].sum() == 0 and mat[:, 0].all()
    assert idx.unsubscribe(sid)
    blk = idx.block()
    assert to_numpy(ops.match_subscriptions(locs, obm, blk.rects, blk.bm)).sum() == 0


def test_cpu_index_never_launches_the_match_kernel():
    _build.reset_launch_counts()
    rng = np.random.default_rng(8)
    idx = SubscriptionIndex(64, device="cpu")
    idx.subscribe((0.0, 0.0, 1.0, 1.0), [3])
    locs = rng.random((5, 2)).astype(np.float32)
    assert idx.match_arrivals(np.arange(5), locs, kw_ids=np.full((5, 1), 3)) == 5
    assert not any(_build.launch_counts().values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SubscriptionIndex(64)


# ------------------------------------------------------------------ index
class Streams:
    """The port's index, the reference's and both oracles, driven by the
    same events."""

    def __init__(self, v):
        self.port = SubscriptionIndex(v, device="cpu")
        self.jax = jsubscribe.SubscriptionIndex(v)
        self.oracles = (SubscriptionOracle(), JOracle())

    def subscribe(self, rect, kw):
        ids = {self.port.subscribe(rect, kw), self.jax.subscribe(rect, kw),
               *(o.subscribe(rect, kw) for o in self.oracles)}
        assert len(ids) == 1
        return ids.pop()

    def unsubscribe(self, sid):
        got = {self.port.unsubscribe(sid), self.jax.unsubscribe(sid),
               *(o.unsubscribe(sid) for o in self.oracles)}
        assert len(got) == 1

    def arrive(self, ids, locs, okw):
        n = self.port.match_arrivals(ids, locs, kw_ids=okw)
        assert n == self.jax.match_arrivals(ids, locs, kw_ids=okw)
        for o in self.oracles:
            assert n == o.arrive(ids, locs, okw)
        return n

    def drain(self):
        got = self.port.drain()
        np.testing.assert_array_equal(got, self.jax.drain())
        for o in self.oracles:
            np.testing.assert_array_equal(got, o.drain())
        return got

    def blocks_equal(self):
        blk, jblk = self.port.block(), self.jax.block()
        np.testing.assert_array_equal(to_numpy(blk.rects), np.asarray(jblk.rects))
        np.testing.assert_array_equal(to_numpy(blk.bm, jblk.bm), np.asarray(jblk.bm))
        np.testing.assert_array_equal(to_numpy(blk.sig, jblk.sig), np.asarray(jblk.sig))


def test_subscription_churn_with_slot_reuse_matches_reference():
    """Interleaved subscribe / unsubscribe / arrive / drain: freed slots are
    reused without leaking old filters, blocks and streams equal the
    reference's and the oracles', and a second drain is empty."""
    rng = np.random.default_rng(3)
    v = 48
    st = Streams(v)
    live, next_id = [], 0
    for step in range(12):
        for s in [s for s in live if rng.random() < 0.33]:
            st.unsubscribe(s)
            live.remove(s)
        for _ in range(rng.integers(1, 4)):
            live.append(st.subscribe(rand_sub_rect(rng), rand_kw(rng, v, lo=0)))
        n = int(rng.integers(1, 20))
        ids = np.arange(next_id, next_id + n)
        next_id += n
        locs = rng.random((n, 2)).astype(np.float32)
        st.arrive(ids, locs, np.stack([rand_kw(rng, v) for _ in range(n)]))
        if step % 3 == 2:
            st.blocks_equal()
            st.drain()
    st.drain()
    assert st.drain().shape == (0, 2)
    assert st.port.matched_total == st.jax.matched_total == st.oracles[0].matched_total
    assert st.port.n_slots == st.jax.n_slots <= 32


def _logs(seed, slots_per_leaf=4):
    """A grid index served by both packages, with a ``DeltaLog`` on each."""
    index, ds, jindex, jds = _pair("grid", "fs", 1000, seed, g=5, levels=2)
    log = DeltaLog(index, ds, IndexSnapshot.build(index, ds, device="cpu"), slots_per_leaf)
    jlog = jdelta.DeltaLog(jindex, jds, JSnapshot.build(jindex, jds), slots_per_leaf)
    return ds, log, jlog


def test_delta_churn_growth_and_pump_match_reference():
    """Arrivals through both packages' ``DeltaLog``: inserts concentrated
    on one spot overflow a leaf's 4 slots (growth), deletes free slots that
    fresh, higher ids reuse; ``match_arrivals`` runs in the insert step and
    ``pump`` after it queues nothing, on both packages; a port index driven
    by ``pump`` alone gives the same stream; deleted objects keep their
    queued notifications; repeated drains stay empty."""
    rng = np.random.default_rng(5)
    ds, log, jlog = _logs(seed=1)
    st = Streams(ds.vocab_size)
    pumped = SubscriptionIndex(ds.vocab_size, device="cpu")
    hot = int(np.argmax(ds.kw_freq))
    subs = [(rand_sub_rect(rng), rand_kw(rng, ds.vocab_size, lo=1)) for _ in range(10)]
    subs.append(((0.0, 0.0, 1.0, 1.0), [hot]))  # every arrival carrying `hot` matches
    for r, kw in subs:
        st.subscribe(r, kw)
        pumped.subscribe(r, kw)
    spot = ds.locs[rng.integers(ds.n)]
    inserted, streams = [], []
    for rnd in range(6):
        n = int(rng.integers(2, 8))
        locs = np.clip(spot[None, :] + rng.normal(0, 1e-3, (n, 2)).astype(np.float32), 0, 1)
        okw = np.stack([rand_kw(rng, ds.vocab_size) for _ in range(n)])
        okw[0, -1] = hot
        ids = log.insert(locs, okw)
        np.testing.assert_array_equal(ids, jlog.insert(locs, okw))
        st.arrive(ids, locs, okw)
        pumped.pump(log)
        assert st.port.pump(log) == 0 and st.jax.pump(jlog) == 0
        inserted.extend(int(i) for i in ids)
        if rnd >= 2:
            dels = rng.choice(inserted, size=min(3, len(inserted)), replace=False)
            assert log.delete(dels) == jlog.delete(dels)
            inserted = [i for i in inserted if i not in set(int(d) for d in dels)]
        if rnd == 3:
            streams.append(st.drain())
            streams.append(st.drain())
            assert streams[-1].shape == (0, 2)
    assert log.buffer.slots_per_leaf == jlog.buffer.slots_per_leaf > 4
    streams.append(st.drain())
    got = np.concatenate(streams)
    assert got.shape[0] > 0
    np.testing.assert_array_equal(pumped.drain(), got)
    assert st.port.pump(log) == 0 and st.drain().shape == (0, 2)


def test_out_of_vocabulary_arrival_keeps_notifications_exact():
    """An arrival whose keyword lies outside its leaf's compact dictionary
    flips the ``DeltaLog`` to full-width insert slots; the stream equals the
    reference's and the oracles' either way, and ``pump`` reads the
    full-width buffer."""
    rng = np.random.default_rng(11)
    ds, log, jlog = _logs(seed=3, slots_per_leaf=8)
    st = Streams(ds.vocab_size)
    pumped = SubscriptionIndex(ds.vocab_size, device="cpu")
    rare = int(np.argmin(ds.kw_freq))
    subs = [(rand_sub_rect(rng), rand_kw(rng, ds.vocab_size, lo=1)) for _ in range(6)]
    subs.append(((0.0, 0.0, 1.0, 1.0), [rare]))
    for r, kw in subs:
        st.subscribe(r, kw)
        pumped.subscribe(r, kw)
    assert log.compact_ok
    for _ in range(20):
        locs = rng.random((4, 2)).astype(np.float32)
        okw = np.stack([rand_kw(rng, ds.vocab_size) for _ in range(4)])
        okw[0, 0] = rare
        ids = log.insert(locs, okw)
        np.testing.assert_array_equal(ids, jlog.insert(locs, okw))
        st.arrive(ids, locs, okw)
        pumped.pump(log)
        if not log.compact_ok:
            break
    assert not log.compact_ok and not jlog.compact_ok
    np.testing.assert_array_equal(pumped.drain(), st.drain())


def test_mark_advances_with_no_live_subscription():
    """Objects that arrive while nothing is subscribed are never delivered
    to a later subscriber, on both packages and the oracles."""
    rng = np.random.default_rng(2)
    st = Streams(16)
    locs = rng.random((6, 2)).astype(np.float32)
    okw = np.full((6, 1), 5)
    assert st.arrive(np.arange(6), locs, okw) == 0
    st.subscribe((0.0, 0.0, 1.0, 1.0), [5])
    for idx in (st.port, st.jax):  # already seen: skipped (the oracles keep no mark)
        assert idx.match_arrivals(np.arange(6), locs, kw_ids=okw) == 0
    assert st.arrive(np.arange(6, 9), locs[:3], okw[:3]) == 3
    np.testing.assert_array_equal(st.drain()[:, 0], [6, 7, 8])
