"""Delta layer: live inserts and deletes merged into serving on the fly.

The port of the JAX package's ``serve/delta.py`` for one device. The
snapshot (serve/snapshot.py) is frozen; this module lets a served index
take updates without a rebuild:

* ``DeltaBuffer`` -- the device-resident delta state the executors
  (serve/engine.py) merge into every query:

  - per-leaf **insert buffers** ``ins_x/ins_y/ins_bm/ins_id`` shaped
    ``(K, B)`` (B = ``slots_per_leaf``, a power of two): buffered objects
    are verified beside the snapshot's leaf object blocks in SKR's verify
    stage and in the kNN probe and leaf chunks;
  - a **delete mask** ``base_alive`` shaped ``(K, OBJ)``: deleted snapshot
    objects never match and never enter the kNN top-k; a deleted *buffered*
    object clears its ``ins_id`` slot to ``-1``;
  - per-level **augmented filter arrays** ``aug_mbrs``/``aug_bms``: the
    snapshot's level MBRs and bitmaps widened along the ancestor path of
    every buffered insert, so no descent prunes a node whose subtree holds a
    buffered match. Deletes never shrink them (filtering only prunes, so
    that stays exact).

  A ``DeltaBuffer`` is immutable: every update builds new tensors
  (out-of-place ``index_put``, or a fresh upload) and never writes into a
  tensor of a buffer that was handed out, so a reader holding an old buffer
  keeps a consistent view. Untouched fields are shared between buffers.

* ``DeltaLog`` -- the host-side manager of the update stream: it routes
  each insert to its nearest leaf, widens the augmented arrays up the
  parent chain, tracks deleted ids, grows full leaf buffers by doubling,
  and materializes ``merged_dataset()`` (base + inserts, deletes
  tombstoned) for a rebuild.

Bitmaps are int32 tensors holding the bits of the reference's u32 words,
as in the snapshot. Id convention: inserts get ids ``n, n+1, ...`` in
arrival order, so a cold rebuild over ``merged_dataset()`` returns the same
ids. For multi-rank serving a buffer is replicated on a rank's device
(``replicate``), or routed to the owning index shards
(``partition_delta``, on the host) with ``shard(mesh)`` placing this
rank's slab.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.query import _mbr_dist2_f32
from ..core.types import GeoTextDataset, WiskIndex, ids_to_bitmap
from ..kernels.ops import NEVER_RECT
from .snapshot import IndexSnapshot, _moved, _nbytes, _slabs, _stack_shard_rows, to_device

MIN_SLOTS_PER_LEAF = 8

# the buffer's tensor fields, in the JAX package's order
ARRAY_FIELDS = (
    "aug_mbrs",
    "aug_bms",
    "ins_x",
    "ins_y",
    "ins_bm",
    "ins_id",
    "base_alive",
    "ins_cbm",
    "ins_sig",
)


@dataclasses.dataclass(frozen=True, eq=False)
class DeltaBuffer:
    """Immutable device-resident delta state merged by the executors.

    Shapes (K = leaves, B = ``slots_per_leaf``, OBJ = the snapshot's
    ``obj_per_leaf``, W = bitmap words, Wl = compact words); bitmap fields
    are int32 views of u32 words:

    * ``aug_mbrs``/``aug_bms`` -- per level ``(n, 4)`` f32 / ``(n, W)`` i32;
    * ``ins_x``/``ins_y`` -- ``(K, B)`` f32 buffered insert coordinates;
    * ``ins_bm`` -- ``(K, B, W)`` i32 buffered insert bitmaps;
    * ``ins_id`` -- ``(K, B)`` i32 buffered insert ids, ``-1`` = empty slot;
    * ``base_alive`` -- ``(K, OBJ)`` i8, ``0`` = snapshot object deleted;
    * ``ins_cbm``/``ins_sig`` -- ``(K, B, Wl)`` / ``(K, B)`` i32 or None:
      each insert's bitmap remapped into its leaf's compact vocabulary and
      its OR-fold. Present only while every buffered term lies in its
      leaf's dictionary; the executors then verify the insert slots on the
      compact words, else on the full-width ``ins_bm``.
    """

    aug_mbrs: List[torch.Tensor]
    aug_bms: List[torch.Tensor]
    ins_x: torch.Tensor
    ins_y: torch.Tensor
    ins_bm: torch.Tensor
    ins_id: torch.Tensor
    base_alive: torch.Tensor
    slots_per_leaf: int
    ins_cbm: Optional[torch.Tensor] = None
    ins_sig: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.ins_x.device

    @property
    def n_levels(self) -> int:
        return len(self.aug_mbrs)

    def n_buffered(self) -> int:
        """Live buffered inserts (a host sync; monitoring only)."""
        return int((self.ins_id >= 0).sum())

    def n_deleted(self) -> int:
        """Deleted snapshot objects (a host sync; monitoring only)."""
        return int((self.base_alive == 0).sum())

    def nbytes(self) -> int:
        """Bytes of every tensor the buffer holds (augmented levels no
        insert has touched are the snapshot's own tensors)."""
        return _nbytes(self, ARRAY_FIELDS)

    def to(self, device) -> "DeltaBuffer":
        """The buffer with every tensor on ``device`` (itself when they are
        there already)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return DeltaBuffer(slots_per_leaf=self.slots_per_leaf, **_moved(self, ARRAY_FIELDS, dev))

    def replicate(self, mesh) -> "DeltaBuffer":
        """The whole buffer on a serving mesh rank's device (the
        query-parallel regime's replica)."""
        return self.to(mesh.device)

    def shard(self, mesh) -> "DeltaBuffer":
        """This rank's slab of a ``partition_delta`` buffer, on its device:
        every tensor split along its first dimension over the mesh's
        ``index`` axis (logical axis ``leaf``), as the partitioned
        snapshot's ``shard``."""
        return DeltaBuffer(slots_per_leaf=self.slots_per_leaf, **_slabs(self, ARRAY_FIELDS, mesh))

    @staticmethod
    def empty(snap: IndexSnapshot, slots_per_leaf: int = MIN_SLOTS_PER_LEAF) -> "DeltaBuffer":
        """An all-empty buffer over ``snap``: the augmented arrays are the
        snapshot's own (immutable) tensors, every insert slot is empty and
        nothing is deleted. Serving with it returns exactly the plain
        snapshot results."""
        K, W, B = snap.n_leaves, snap.n_words, int(slots_per_leaf)
        dev = snap.device
        cbm = sig = None
        if snap.has_compact_bank:
            cbm = torch.zeros((K, B, snap.n_compact_words), dtype=torch.int32, device=dev)
            sig = torch.zeros((K, B), dtype=torch.int32, device=dev)
        return DeltaBuffer(
            aug_mbrs=list(snap.level_mbrs),
            aug_bms=list(snap.level_bms),
            ins_x=torch.zeros((K, B), dtype=torch.float32, device=dev),
            ins_y=torch.zeros((K, B), dtype=torch.float32, device=dev),
            ins_bm=torch.zeros((K, B, W), dtype=torch.int32, device=dev),
            ins_id=torch.full((K, B), -1, dtype=torch.int32, device=dev),
            base_alive=torch.ones((K, snap.obj_per_leaf), dtype=torch.int8, device=dev),
            slots_per_leaf=B,
            ins_cbm=cbm,
            ins_sig=sig,
        )

    def grown(self, new_slots: int) -> "DeltaBuffer":
        """The same buffer with the insert capacity padded to ``new_slots``
        (new tensors; empty slots carry id ``-1``)."""
        if new_slots <= self.slots_per_leaf:
            return self
        pad = new_slots - self.slots_per_leaf

        def padded(t, value=0):
            if t is None:
                return None
            fill = torch.full((t.shape[0], pad) + tuple(t.shape[2:]), value,
                              dtype=t.dtype, device=t.device)
            return torch.cat([t, fill], dim=1)

        return dataclasses.replace(
            self,
            ins_x=padded(self.ins_x),
            ins_y=padded(self.ins_y),
            ins_bm=padded(self.ins_bm),
            ins_id=padded(self.ins_id, -1),
            slots_per_leaf=int(new_slots),
            ins_cbm=padded(self.ins_cbm),
            ins_sig=padded(self.ins_sig),
        )

    @staticmethod
    def from_reference_arrays(
        fields: Mapping[str, object], slots_per_leaf: int, device=None
    ) -> "DeltaBuffer":
        """The port's buffer of the JAX package's: ``fields`` maps each name
        of ``ARRAY_FIELDS`` to ``np.asarray`` of the field (a list of arrays
        for the per-level fields, None for absent compact slots). The state
        carried across, as ``IndexSnapshot.from_reference_arrays`` carries
        the snapshot."""
        dev = resolve_device(device)
        kw = {}
        for name in ARRAY_FIELDS:
            v = fields.get(name)
            if v is None:
                kw[name] = None
            elif isinstance(v, (list, tuple)):
                kw[name] = [to_device(a, dev) for a in v]
            else:
                kw[name] = to_device(v, dev)
        return DeltaBuffer(slots_per_leaf=int(slots_per_leaf), **kw)


def partition_delta(delta: DeltaBuffer, part) -> DeltaBuffer:
    """Route a ``DeltaBuffer`` in the global layout to the owning index shards.

    Returns a new buffer, on the host, whose rows follow the stacked
    ``PartitionedSnapshot`` layout of ``part`` (an ``IndexPartition``):
    level arrays become ``(S*pad_li, ...)`` with each shard's slice holding
    its own nodes' augmented MBRs and bitmaps (pads: the never-intersecting
    rectangle, empty bitmaps); the insert buffers and the delete mask become
    ``(S*Kp, ...)`` with each leaf's buffered inserts and alive mask only on
    the shard that owns the leaf (pads: empty slots, alive). ``shard(mesh)``
    then places one rank's slab, so every shard merges exactly its own
    updates.
    """
    L = delta.n_levels
    leaf_ids = part.nodes[L - 1]
    Kp = part.level_pads[L - 1]
    never = np.asarray(NEVER_RECT, np.float32)
    cpu = torch.device("cpu")

    def leaves(t, fill):
        return None if t is None else to_device(
            _stack_shard_rows(t.cpu().numpy(), leaf_ids, Kp, fill), cpu)

    return DeltaBuffer(
        aug_mbrs=[to_device(_stack_shard_rows(m.cpu().numpy(), part.nodes[li],
                                              part.level_pads[li], never), cpu)
                  for li, m in enumerate(delta.aug_mbrs)],
        aug_bms=[to_device(_stack_shard_rows(b.cpu().numpy(), part.nodes[li],
                                             part.level_pads[li], 0), cpu)
                 for li, b in enumerate(delta.aug_bms)],
        ins_x=leaves(delta.ins_x, 0),
        ins_y=leaves(delta.ins_y, 0),
        ins_bm=leaves(delta.ins_bm, 0),
        ins_id=leaves(delta.ins_id, -1),
        base_alive=leaves(delta.base_alive, 1),
        slots_per_leaf=delta.slots_per_leaf,
        ins_cbm=leaves(delta.ins_cbm, 0),
        ins_sig=leaves(delta.ins_sig, 0),
    )


def _remap_insert_bitmap(bm: np.ndarray, terms: np.ndarray):
    """Remap one full-width insert bitmap into a leaf's compact vocabulary.

    ``bm``: (W,) u32; ``terms``: (32*Wl,) i32 sorted leaf dictionary,
    ``-1``-padded. Returns ``(cbm (Wl,) u32, sig u32, exact)`` where
    ``exact`` is False when the object carries a term missing from the
    dictionary: the remap would drop it, so the caller must verify on the
    full-width words instead.
    """
    shifts = np.arange(32, dtype=np.uint32)
    Wl = terms.size // 32
    tpos = np.clip(terms, 0, bm.size * 32 - 1)
    bits = (bm[tpos >> 5] >> (tpos & 31).astype(np.uint32)) & np.uint32(1)
    bits = np.where(terms >= 0, bits, np.uint32(0))
    cbm = np.bitwise_or.reduce(bits.reshape(Wl, 32) << shifts, axis=-1)
    sig = np.bitwise_or.reduce(cbm)
    n_terms = int(np.sum(((bm[:, None] >> shifts) & 1)))
    return cbm, sig, int(bits.sum()) == n_terms


def parent_chains(index: WiskIndex) -> List[np.ndarray]:
    """Per level: ``parents[li][node]`` = the node's parent at level li-1.

    ``parents[0]`` is a placeholder (roots have no parent). Host-only,
    computed once per index from the level CSRs; ``DeltaLog`` widens the
    augmented arrays along each insert's ancestor path with it.
    """
    out: List[np.ndarray] = [np.zeros(index.levels[0].n, np.int32)]
    for li in range(len(index.levels) - 1):
        lvl = index.levels[li]
        par = np.zeros(index.levels[li + 1].n, np.int32)
        owner = np.repeat(np.arange(lvl.n, dtype=np.int32), np.diff(lvl.child_ptr))
        par[lvl.child[: lvl.child_ptr[lvl.n]]] = owner
        out.append(par)
    return out


def _set(t: torch.Tensor, rows: np.ndarray, cols: np.ndarray, values) -> torch.Tensor:
    """A new tensor: ``t`` with ``t[rows[i], cols[i]] = values[i]`` (out of
    place, so a buffer already handed out never changes)."""
    dev = t.device
    idx = (torch.from_numpy(np.asarray(rows, np.int64)).to(dev),
           torch.from_numpy(np.asarray(cols, np.int64)).to(dev))
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=t.dtype, device=dev)
    return t.index_put(idx, values)


class DeltaLog:
    """Host-side manager of the update stream over one snapshot.

    Owns the current ``DeltaBuffer`` (``.buffer``), the routing metadata
    (leaf MBRs and parent chains), and the host mirrors (``ins_locs``,
    ``ins_kw_ids``, ``deleted``) that ``merged_dataset()`` turns into a
    rebuild's input. Every update replaces ``.buffer`` with a new immutable
    buffer; readers holding the old one keep their view.
    """

    def __init__(
        self,
        index: WiskIndex,
        dataset: GeoTextDataset,
        snapshot: IndexSnapshot,
        slots_per_leaf: int = MIN_SLOTS_PER_LEAF,
    ) -> None:
        self.index = index
        self.dataset = dataset
        self.snapshot = snapshot
        self.buffer: DeltaBuffer = DeltaBuffer.empty(snapshot, slots_per_leaf)
        self._parents = parent_chains(index)
        self._leaf_mbrs = np.asarray(index.levels[-1].mbrs, np.float32)
        # sticky: flips False for good at the first insert that carries a
        # term outside its leaf's dictionary
        self.compact_ok = snapshot.has_compact_bank
        self._leaf_terms = snapshot.leaf_terms.cpu().numpy() if self.compact_ok else None
        # host mirrors of the augmented arrays: updates are host unions, and
        # each touched level is uploaded anew once per insert batch
        self._aug_mbrs = [m.cpu().numpy().copy() for m in snapshot.level_mbrs]
        self._aug_bms = [b.cpu().numpy().view(np.uint32).copy() for b in snapshot.level_bms]
        self._fill = np.zeros(snapshot.n_leaves, np.int64)  # high-water slot per leaf
        self._free: Dict[int, List[int]] = {}  # leaf -> reusable (deleted) slots
        # snapshot object id -> its (leaf, slot), for delete masking
        oid = snapshot.leaf_obj_id.cpu().numpy()
        kk, ss = np.nonzero(oid >= 0)
        self._base_leaf = np.full(dataset.n, -1, np.int64)
        self._base_leaf[oid[kk, ss]] = kk
        self._base_slot = np.zeros(dataset.n, np.int64)
        self._base_slot[oid[kk, ss]] = ss
        self._ins_slot: Dict[int, Tuple[int, int]] = {}  # buffered id -> (leaf, slot)
        self.ins_locs: List[np.ndarray] = []
        self.ins_kw_ids: List[np.ndarray] = []
        self.ins_leaf: List[int] = []
        self.deleted: set = set()
        self._next_id = dataset.n

    # ------------------------------------------------------------- inserts
    def insert(self, locs: np.ndarray, kw_ids: np.ndarray) -> np.ndarray:
        """Buffer new objects; returns their ids.

        ``locs``: (n, 2) f32 in the unit square; ``kw_ids``: (n, max_kw) i32
        padded with ``-1``. Each object goes to the leaf with the smallest
        point-to-MBR distance (ties: smallest leaf id), into a freed slot
        of that leaf or else past its high-water mark; the leaf's ancestor
        chain in the augmented arrays is widened so every descent can reach
        it. When a leaf is full the buffer doubles ``slots_per_leaf``.
        """
        locs = np.asarray(locs, np.float32).reshape(-1, 2)
        kw_ids = np.asarray(kw_ids, np.int32).reshape(locs.shape[0], -1)
        n = locs.shape[0]
        if n == 0:
            return np.zeros(0, np.int64)
        ids = np.arange(self._next_id, self._next_id + n, dtype=np.int64)
        self._next_id += n
        bms = ids_to_bitmap(kw_ids, self.dataset.vocab_size)
        leaf = np.argmin(
            _mbr_dist2_f32(self._leaf_mbrs[None, :, :], locs[:, None, :]), axis=1
        ).astype(np.int64)

        # slots: freed ones first, then past the high-water mark
        slots = np.zeros(n, np.int64)
        for i, lf in enumerate(leaf):
            free = self._free.get(int(lf))
            if free:
                slots[i] = free.pop()
            else:
                slots[i] = self._fill[lf]
                self._fill[lf] += 1
            self._ins_slot[int(ids[i])] = (int(lf), int(slots[i]))
        max_need = int(self._fill.max()) if self._fill.size else 0
        B = self.buffer.slots_per_leaf
        while B < max_need:
            B *= 2
        buf = self.buffer.grown(B)
        dev = buf.device
        buf = dataclasses.replace(
            buf,
            ins_x=_set(buf.ins_x, leaf, slots, torch.from_numpy(locs[:, 0].copy()).to(dev)),
            ins_y=_set(buf.ins_y, leaf, slots, torch.from_numpy(locs[:, 1].copy()).to(dev)),
            ins_bm=_set(buf.ins_bm, leaf, slots, to_device(bms, dev)),
            ins_id=_set(buf.ins_id, leaf, slots, torch.from_numpy(ids.astype(np.int32)).to(dev)),
        )
        if self.compact_ok:
            Wl = buf.ins_cbm.shape[2]
            cbms = np.zeros((n, Wl), np.uint32)
            sigs = np.zeros((n,), np.uint32)
            exact = True
            for i in range(n):
                cbms[i], sigs[i], ok = _remap_insert_bitmap(
                    np.asarray(bms[i], np.uint32), self._leaf_terms[int(leaf[i])]
                )
                exact = exact and ok
            if exact:
                buf = dataclasses.replace(
                    buf,
                    ins_cbm=_set(buf.ins_cbm, leaf, slots, to_device(cbms, dev)),
                    ins_sig=_set(buf.ins_sig, leaf, slots, to_device(sigs, dev)),
                )
            else:
                # a term this leaf has never seen: compact insert slots would
                # lose it, so drop them for good (the executors then verify
                # the insert slots on the full-width ins_bm)
                self.compact_ok = False
                buf = dataclasses.replace(buf, ins_cbm=None, ins_sig=None)

        # widen every ancestor: min/max/or are order-free unions, so one
        # scatter per level equals the reference's insert-by-insert loop
        aug_mbrs, aug_bms = list(buf.aug_mbrs), list(buf.aug_bms)
        node = leaf
        for li in range(len(self._aug_mbrs) - 1, -1, -1):
            mb, bm = self._aug_mbrs[li], self._aug_bms[li]
            np.minimum.at(mb[:, 0], node, locs[:, 0])
            np.minimum.at(mb[:, 1], node, locs[:, 1])
            np.maximum.at(mb[:, 2], node, locs[:, 0])
            np.maximum.at(mb[:, 3], node, locs[:, 1])
            np.bitwise_or.at(bm, node, bms)
            aug_mbrs[li] = to_device(mb, dev)
            aug_bms[li] = to_device(bm, dev)
            node = self._parents[li][node].astype(np.int64)
        self.buffer = dataclasses.replace(buf, aug_mbrs=aug_mbrs, aug_bms=aug_bms)

        self.ins_locs.append(locs)
        self.ins_kw_ids.append(kw_ids)
        self.ins_leaf.extend(int(l) for l in leaf)
        return ids

    # -------------------------------------------------------------- deletes
    def delete(self, ids) -> int:
        """Mark objects deleted; returns how many ids were newly deleted.

        A snapshot object clears its ``base_alive`` slot; a buffered object
        clears its ``ins_id`` slot to ``-1`` and frees the slot. The
        augmented arrays stay wide (filtering only prunes, and the verify
        and top-k stages mask the deleted slots). Unknown ids are ignored.
        """
        ids = [int(i) for i in np.atleast_1d(np.asarray(ids, np.int64))]
        base_kk, base_ss, ins_kk, ins_ss = [], [], [], []
        n_new = 0
        for oid in ids:
            if oid in self.deleted:
                continue
            if 0 <= oid < self.dataset.n and self._base_leaf[oid] >= 0:
                base_kk.append(int(self._base_leaf[oid]))
                base_ss.append(int(self._base_slot[oid]))
            elif oid in self._ins_slot:
                k, s = self._ins_slot.pop(oid)
                ins_kk.append(k)
                ins_ss.append(s)
                self._free.setdefault(k, []).append(s)
            else:
                continue
            self.deleted.add(oid)
            n_new += 1
        buf = self.buffer
        if ins_kk:
            buf = dataclasses.replace(buf, ins_id=_set(buf.ins_id, ins_kk, ins_ss, -1))
        if base_kk:
            buf = dataclasses.replace(buf, base_alive=_set(buf.base_alive, base_kk, base_ss, 0))
        self.buffer = buf
        return n_new

    # ------------------------------------------------------------- rebuild
    def n_updates(self) -> int:
        return (self._next_id - self.dataset.n) + len(self.deleted)

    def merged_dataset(self) -> GeoTextDataset:
        """Base dataset + buffered inserts, deletes tombstoned.

        Ids are row indices: base objects keep ``0..n-1``, inserts take
        ``n..`` in arrival order, and a deleted object keeps its row with
        no keywords, so it can never match an SKR or Boolean-kNN query.
        """
        base = self.dataset
        max_kw = base.kw_ids.shape[1]
        if self.ins_kw_ids:
            max_kw = max(max_kw, max(k.shape[1] for k in self.ins_kw_ids))

        def pad(a: np.ndarray) -> np.ndarray:
            return np.pad(a, ((0, 0), (0, max_kw - a.shape[1])), constant_values=-1)

        locs = np.concatenate([base.locs, *self.ins_locs], 0) if self.ins_locs else base.locs.copy()
        kw = (np.concatenate([pad(base.kw_ids), *[pad(k) for k in self.ins_kw_ids]], 0)
              if self.ins_kw_ids else base.kw_ids.copy())
        if self.deleted:
            kw[np.fromiter(self.deleted, np.int64)] = -1
        return GeoTextDataset.from_ids(locs, kw, base.vocab_size)

    def merged_assignment(self) -> np.ndarray:
        """(n_merged,) leaf assignment: the snapshot's clustering extended
        with each buffered insert's routed leaf."""
        extra = np.asarray(self.ins_leaf, np.int32)
        return np.concatenate([self.index.clusters.assign, extra])
