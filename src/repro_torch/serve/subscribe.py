"""Standing subscriptions: continuous spatio-textual filters over the update stream.

The port of the JAX package's ``serve/subscribe.py`` for one device. The
subscriptions are the indexed set, and every arriving object is a point
query matched against all of them:

* ``SubscriptionBlock`` -- the compiled subscription index on the device:
  rects ``(S, 4)`` f32, keyword bitmaps ``(S, W)`` (int32 views of the
  reference's u32 words) and one-word OR-fold signatures ``(S, 1)``, with S
  a power-of-two slot count grown by doubling, freed slots reused first,
  and each slot's subscription id ``(S,)``. Empty slots carry
  ``NEVER_RECT`` and a zero bitmap and match nothing.
* ``SubscriptionIndex`` -- the host-side manager and notification log.
  ``subscribe`` / ``unsubscribe`` edit host mirrors and the block is
  compiled again lazily; ``match_arrivals`` matches a batch of arriving
  objects against the block with the ``sub_match`` kernel's pairs instance
  (``ops.match_subscription_pairs``) and queues ``(object_id,
  subscription_id)`` notifications; ``pump(delta_log)`` sweeps a
  ``DeltaLog``'s live buffered inserts instead; ``drain()`` hands the queue
  out exactly once.

Exactly-once: every object id is matched at most once, guarded by a
high-water mark over the global object id space (``DeltaLog`` assigns ids
``n, n+1, ...`` in arrival order, and a reused buffer slot holds a fresh,
higher id), so buffer growth, slot reuse and deletes never re-emit, and
``pump`` after ``match_arrivals`` emits nothing. The mark advances even
when no subscription is live: a later subscriber never sees earlier
objects.

Stream semantics, as ``core.query.SubscriptionOracle``: a subscription sees
exactly the objects that arrive while it is live; deleting an object never
retracts a queued notification; an empty keyword set matches nothing; a
zero-area rect matches objects exactly at that point. Notifications are
queued in canonical (object id, subscription id) order per batch.

No (N, S) match matrix is made: the arrivals' bitmaps go to the device
once (``pump``'s never leave it), the kernel emits the matching (object,
slot) pairs there, they are sorted there into canonical order, and only
they are copied back.
``launch.wisk_serve.LiveIndex`` holds one ``SubscriptionIndex`` on its
front door, matches each insert batch here in the same step, and keeps it
across generation swaps, so queued notifications and the high-water mark
survive a rebuild.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.types import bitmap_words, ids_to_bitmap
from ..kernels import ops
from ..kernels.ops import NEVER_RECT
from .snapshot import to_device

MIN_SUB_SLOTS = 8
_INT32_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True, eq=False)
class SubscriptionBlock:
    """Immutable compiled subscription index on the device.

    ``rects`` (S, 4) f32 / ``bm`` (S, W) i32 / ``sig`` (S, 1) i32 with S a
    power-of-two slot count; empty slots are ``NEVER_RECT`` and a zero
    bitmap (signature 0), so the match kernel needs no validity plane.
    ``sub_id`` (S,) i32 is each slot's subscription id (-1 when empty),
    which orders the notifications on the device.
    """

    rects: torch.Tensor
    bm: torch.Tensor
    sig: torch.Tensor
    sub_id: torch.Tensor

    @property
    def n_slots(self) -> int:
        return int(self.rects.shape[0])

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.rects, self.bm, self.sig, self.sub_id))


def canonical_pairs(found: torch.Tensor, obj_ids: np.ndarray, slot_sub: torch.Tensor) -> np.ndarray:
    """The matching (object index, slot) pairs ``found`` -- (n, 2) int32, in
    any order -- as notifications ``(object id, subscription id)``, (n, 2)
    int64 on the host in canonical order: by object id, then subscription
    id. ``obj_ids`` (host) names the objects, ``slot_sub`` (on ``found``'s
    device) the slots' subscriptions. The pairs are sorted on their device
    by one 64-bit key -- the object id's rank among the batch's distinct
    ids, then the subscription id -- and only the sorted keys are copied."""
    uniq, rank = np.unique(np.asarray(obj_ids, np.int64), return_inverse=True)
    rank = torch.from_numpy(rank.reshape(-1).astype(np.int64)).to(found.device)
    key = (rank[found[:, 0].long()] << 32) | (slot_sub[found[:, 1].long()].long() & 0xFFFFFFFF)
    key = torch.sort(key).values.cpu().numpy()
    return np.stack([uniq[key >> 32], key & 0xFFFFFFFF], 1)


class SubscriptionIndex:
    """Host-side manager of the standing-subscription set and its
    notification log, over a block on ``device`` (``cuda`` unless the caller
    passes another).

    One writer, like ``DeltaLog``: ``subscribe`` / ``unsubscribe`` /
    ``match_arrivals`` / ``pump`` / ``drain`` are called from one thread.
    The block is compiled lazily and kept until the subscription set
    changes; its slot count only ever doubles.
    """

    def __init__(self, vocab_size: int, min_slots: int = MIN_SUB_SLOTS, device=None) -> None:
        self.device = resolve_device(device)
        self.vocab_size = int(vocab_size)
        self.n_words = bitmap_words(self.vocab_size)
        S = int(min_slots)
        self._rects = np.tile(np.asarray(NEVER_RECT, np.float32), (S, 1))
        self._bms = np.zeros((S, self.n_words), np.uint32)
        self._sub_id = np.full(S, -1, np.int32)
        self._slot = {}  # sub_id -> slot
        self._free: List[int] = []
        self._fill = 0
        self._next_sub = 0
        self._block: Optional[SubscriptionBlock] = None
        # exactly-once high-water mark over the global object id space
        self._seen_max = -1
        # queued (object id, subscription id) pairs, one (n, 2) array per batch
        self._pending: List[np.ndarray] = []
        self.emitted_total = 0
        self.matched_total = 0

    # ------------------------------------------------------------- editing
    @property
    def n_live(self) -> int:
        return len(self._slot)

    @property
    def n_slots(self) -> int:
        return self._rects.shape[0]

    def subscribe(self, rect, kw_ids) -> int:
        """Register a standing (rect, keyword) filter; returns its id.

        It matches only objects arriving from now on. Slots freed by
        ``unsubscribe`` are reused before the block grows by doubling.
        """
        rect = np.asarray(rect, np.float32).reshape(4)
        kw = np.asarray(kw_ids, np.int32).reshape(1, -1)
        bm = ids_to_bitmap(kw, self.vocab_size)[0]
        sid = self._next_sub
        self._next_sub += 1
        if self._free:
            slot = self._free.pop()
        else:
            slot = self._fill
            self._fill += 1
            if slot >= self.n_slots:
                half = self.n_slots
                self._rects = np.concatenate(
                    [self._rects, np.tile(np.asarray(NEVER_RECT, np.float32), (half, 1))]
                )
                self._bms = np.concatenate([self._bms, np.zeros((half, self.n_words), np.uint32)])
                self._sub_id = np.concatenate([self._sub_id, np.full(half, -1, np.int32)])
        self._rects[slot] = rect
        self._bms[slot] = bm
        self._sub_id[slot] = sid
        self._slot[sid] = slot
        self._block = None
        return sid

    def unsubscribe(self, sub_id: int) -> bool:
        """Retire a subscription; its slot becomes reusable. Notifications
        already queued for it stay queued; no later arrival can match it."""
        slot = self._slot.pop(int(sub_id), None)
        if slot is None:
            return False
        self._rects[slot] = np.asarray(NEVER_RECT, np.float32)
        self._bms[slot] = 0
        self._sub_id[slot] = -1
        self._free.append(slot)
        self._block = None
        return True

    def block(self) -> SubscriptionBlock:
        """The compiled block of the current subscription set on the device
        (kept until the set changes)."""
        if self._block is None:
            self._block = SubscriptionBlock(
                rects=to_device(self._rects, self.device),
                bm=to_device(self._bms, self.device),
                sig=to_device(np.bitwise_or.reduce(self._bms, axis=1).reshape(-1, 1), self.device),
                sub_id=to_device(self._sub_id, self.device),
            )
        return self._block

    # ------------------------------------------------------------ matching
    def _admit(self, ids: np.ndarray) -> bool:
        """Advance the exactly-once mark over arrivals above it; whether any
        live subscription is there to match them."""
        if ids.size == 0:
            return False
        self._seen_max = max(self._seen_max, int(ids.max()))
        return bool(self._slot)

    def _match(self, ids: np.ndarray, locs: torch.Tensor, bms: torch.Tensor) -> int:
        """Match admitted arrivals -- ``locs`` (n, 2) f32 and ``bms`` (n, W)
        int32 on the block's device -- against the block and queue their
        notifications in canonical (object id, subscription id) order."""
        blk = self.block()
        found = ops.match_subscription_pairs(locs, bms, blk.rects, blk.bm, blk.sig[:, 0])
        pairs = canonical_pairs(found, ids, blk.sub_id)
        if pairs.shape[0] == 0:
            return 0
        self._pending.append(pairs)
        self.matched_total += pairs.shape[0]
        return pairs.shape[0]

    def match_arrivals(self, ids, locs, kw_ids=None, bms=None) -> int:
        """Match one batch of arriving objects against the block, in the
        step they enter the ``DeltaLog``. Ids at or below the high-water
        mark were matched already and are skipped; the mark advances even
        when no subscription is live. ``bms`` (u32 words) or ``kw_ids``
        (-1-padded id lists) give the keywords; the points and bitmaps go
        to the device once. Returns how many notifications were queued."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        locs = np.asarray(locs, np.float32).reshape(-1, 2)
        if bms is None:
            bms = ids_to_bitmap(np.asarray(kw_ids, np.int32).reshape(ids.size, -1), self.vocab_size)
        bms = np.asarray(bms, np.uint32).reshape(ids.size, -1)
        keep = ids > self._seen_max
        if not keep.all():
            ids, locs, bms = ids[keep], locs[keep], bms[keep]
        if not self._admit(ids):
            return 0
        return self._match(ids, to_device(locs, self.device), to_device(bms, self.device))

    def pump(self, delta_log) -> int:
        """Full-buffer sweep: match every live buffered insert of
        ``delta_log`` that the high-water mark has not covered. After
        ``match_arrivals`` it queues nothing, and a stream driven by ``pump``
        alone queues the same notifications. Empty slots (``ins_id == -1``,
        freed by deletes or padding from growth) are skipped. The selected
        slots' points and bitmaps stay on the device; only their ids come
        to the host. Returns how many were queued."""
        buf = delta_log.buffer
        ins_id = buf.ins_id.reshape(-1)
        live = (ins_id >= 0) & (ins_id > min(self._seen_max, _INT32_MAX))
        rows = torch.nonzero(live).reshape(-1)
        if rows.numel() == 0:
            return 0
        ids = ins_id[rows].cpu().numpy().astype(np.int64)
        if not self._admit(ids):
            return 0
        locs = torch.stack([buf.ins_x.reshape(-1)[rows], buf.ins_y.reshape(-1)[rows]], 1)
        bms = buf.ins_bm.reshape(ins_id.shape[0], -1)[rows]
        return self._match(ids, locs, bms)

    # ------------------------------------------------------- notifications
    @property
    def n_pending(self) -> int:
        return sum(p.shape[0] for p in self._pending)

    def drain(self) -> np.ndarray:
        """All queued (object_id, subscription_id) notifications, exactly
        once: a second drain with no arrivals in between returns an empty
        (0, 2) array."""
        out = np.concatenate(self._pending) if self._pending else np.zeros((0, 2), np.int64)
        self._pending = []
        self.emitted_total += out.shape[0]
        return out
