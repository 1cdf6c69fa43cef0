"""Snapshot layer: the device-resident WISK index, frozen.

``IndexSnapshot`` holds every tensor the frontier executor (serve/engine.py)
touches -- per-level MBRs and keyword bitmaps, CSR child tables, the padded
per-leaf object blocks, the int16 rank-coded MBR planes with their
coordinate dictionaries, the compact leaf-local verify bank and, when built
with ``dense=True``, the dense child matrices of the A/B dense scan. It is
the port of the JAX package's ``serve/snapshot.py:IndexSnapshot`` for one
device, field for field.

Bitmaps live on the device as ``int32`` tensors holding the bits of the
reference's ``uint32`` words: the conversion is ``.view(np.int32)`` on the
way in and ``.view(np.uint32)`` on the way out, never a value cast.

Mutability policy: the snapshot is frozen. Serving *state* (the monotone
frontier width cache) lives in ``serve/plan.py``'s ``PlanCache``.

``build`` and ``from_reference_arrays`` run on the host and place the
tensors on ``device`` (``cuda`` unless the caller passes another);
``replicate(mesh)`` puts a copy on a serving mesh rank's device.

Index-parallel serving: for an index too large to replicate,
``partition_index`` cuts the level-0 (root) forest into ``n_shards``
balanced sub-hierarchies and ``PartitionedSnapshot`` stacks the per-shard
slabs along the first dimension, on the host. ``shard(mesh)`` moves only
this rank's slab to its device and returns it as a plain ``IndexSnapshot``
(what the reference's ``local_view`` re-wraps inside a ``shard_map`` body),
on which the engine's descent runs unchanged
(launch/wisk_serve.py: ``serve_index_sharded`` /
``serve_knn_index_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.query import padded_child_table, round_up_bucket
from ..core.types import GeoTextDataset, WiskIndex, set_bits
from ..kernels.ops import NEVER_RECT

# int16 code capacity per coordinate dictionary: a level whose distinct
# coordinate count exceeds this gets no narrow planes
NARROW_DICT_MAX = 32767

# leaf-local vocabulary capacity: if any leaf's distinct-term count exceeds
# this, the compact leaf bank is not built
LEAF_DICT_MAX = 32768


def encode_leaf_vocab(leaf_obj_bm, cap: int = LEAF_DICT_MAX):
    """Re-encode the leaf object bitmaps against per-leaf sorted vocabularies.

    Per leaf, the dictionary is the sorted distinct set of global term ids
    present in ANY of the leaf's objects; each object's bitmap is re-packed
    over leaf-LOCAL bit positions into ``Wl`` u32 words, with ``Wl`` the
    power-of-two bucket of the widest leaf's word count. Every object's term
    set is a subset of its leaf's dictionary, so intersecting a query's
    remapped words with the compact slab is exactly the global-width test.

    Returns numpy ``(leaf_terms, leaf_obj_cbm, leaf_obj_sig)``:

    * ``leaf_terms``  (K, 32*Wl) i32 -- global term id per local bit, -1 pad;
    * ``leaf_obj_cbm`` (K, OBJ, Wl) u32 -- the compact object bitmap slab;
    * ``leaf_obj_sig`` (K, OBJ) u32 -- per-object OR-fold of the Wl words;

    or ``(None, None, None)`` when any leaf's dictionary would exceed
    ``cap``. The same arrays as the reference encoder, computed from each
    leaf's set bits alone (its nonzero words, unpacked), so the work
    follows the objects' terms and not the (OBJ, 32 * Wl) padding: a
    learned leaf of thousands of objects over a W = 256 vocabulary would
    otherwise cost gigabytes of temporaries.
    """
    bm = np.asarray(leaf_obj_bm, np.uint32)
    K, OBJ, W = bm.shape
    leaf_bits = [set_bits(bm[c]) for c in range(K)]  # per leaf: (object row, global term)
    terms = [np.unique(g) for _, g in leaf_bits]  # each leaf's sorted dictionary
    max_terms = max((t.size for t in terms), default=0)
    if max_terms > cap:
        return None, None, None
    need = -(-max(1, max_terms) // 32)
    Wl = 1 << (need - 1).bit_length()  # power-of-two word count, min 1
    leaf_terms = np.full((K, 32 * Wl), -1, np.int32)
    cbm = np.zeros((K, OBJ, Wl), np.uint32)
    for c, ((rows, g), t) in enumerate(zip(leaf_bits, terms)):
        leaf_terms[c, : t.size] = t
        local = np.searchsorted(t, g)
        np.bitwise_or.at(cbm[c], (rows, local >> 5),
                         np.left_shift(np.uint32(1), (local & 31).astype(np.uint32)))
    sig = np.bitwise_or.reduce(cbm, axis=-1)  # (K, OBJ)
    return leaf_terms, cbm, sig


def encode_mbr_planes(level_mbrs):
    """Rank-encode per-level MBR planes into int16 codes + f32 dictionaries.

    Per level, the x dictionary is the sorted distinct set of {xlo, xhi}
    values (y likewise) and each MBR coordinate is replaced by its rank --
    ``dict[code]`` reconstructs the exact f32 value, so descending on the
    codes is lossless. Returns numpy ``(codes, dicts_x, dicts_y)`` as
    parallel per-level lists, or three empty lists when any level's
    dictionary would overflow the int16 code space (``NARROW_DICT_MAX``).
    """
    codes, dicts_x, dicts_y = [], [], []
    for m in level_mbrs:
        m = np.asarray(m, np.float32)
        dx = np.unique(m[:, [0, 2]])
        dy = np.unique(m[:, [1, 3]])
        if dx.size > NARROW_DICT_MAX or dy.size > NARROW_DICT_MAX:
            return [], [], []
        c = np.stack(
            [
                np.searchsorted(dx, m[:, 0]),
                np.searchsorted(dy, m[:, 1]),
                np.searchsorted(dx, m[:, 2]),
                np.searchsorted(dy, m[:, 3]),
            ],
            axis=1,
        ).astype(np.int16)
        codes.append(c)
        dicts_x.append(dx.astype(np.float32))
        dicts_y.append(dy.astype(np.float32))
    return codes, dicts_x, dicts_y


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; ``uint32`` words become their int32 view."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. np.asarray of another framework's array
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _moved(obj, fields, device: torch.device) -> dict:
    """``obj``'s tensor fields (lists per level, None kept) on ``device``."""
    kw = {}
    for name in fields:
        v = getattr(obj, name)
        if v is None:
            kw[name] = None
        elif isinstance(v, list):
            kw[name] = [t.to(device) for t in v]
        else:
            kw[name] = v.to(device)
    return kw


def _slabs(obj, fields, mesh) -> dict:
    """``obj``'s stacked tensor fields (lists per level, None kept), each
    cut to this rank's block of its first dimension over the mesh's leaf
    axis (``sharding/rules.py``) and moved to the rank's device."""
    from ..sharding.rules import shard_rows

    def slab(t):
        return shard_rows(t, "leaf", mesh).to(mesh.device)

    kw = {}
    for name in fields:
        v = getattr(obj, name)
        kw[name] = None if v is None else [slab(t) for t in v] if isinstance(v, list) else slab(v)
    return kw


def _nbytes(obj, fields) -> int:
    """Bytes of ``obj``'s tensor fields."""
    total = 0
    for name in fields:
        v = getattr(obj, name)
        for t in v if isinstance(v, list) else [v]:
            if t is not None:
                total += t.numel() * t.element_size()
    return total


# the snapshot's tensor fields, in the JAX package's field order
ARRAY_FIELDS = (
    "level_mbrs",
    "level_bms",
    "child_table",
    "child_counts",
    "child_matrix",
    "leaf_obj_x",
    "leaf_obj_y",
    "leaf_obj_bm",
    "leaf_obj_id",
    "level_mbr_codes",
    "level_dict_x",
    "level_dict_y",
    "leaf_terms",
    "leaf_obj_cbm",
    "leaf_obj_sig",
)


@dataclasses.dataclass(frozen=True, eq=False)
class IndexSnapshot:
    """Immutable device-resident tensors for batched serving over a WiskIndex.

    Bitmap fields are int32 views of the reference's u32 words.
    """

    level_mbrs: List[torch.Tensor]  # per level: (n, 4) f32
    level_bms: List[torch.Tensor]  # per level: (n, W) i32
    child_table: List[torch.Tensor]  # per non-leaf level: (n_up, max_fanout) i32, -1 pad
    child_counts: List[torch.Tensor]  # (n_up,) i32
    child_matrix: List[torch.Tensor]  # per non-leaf level: (n_up, n_down) i8; [] unless dense
    leaf_obj_x: torch.Tensor  # (K, OBJ) f32 padded per-leaf object blocks
    leaf_obj_y: torch.Tensor
    leaf_obj_bm: torch.Tensor  # (K, OBJ, W) i32 full-width bank (field parity)
    leaf_obj_id: torch.Tensor  # (K, OBJ) i32, -1 pad
    obj_per_leaf: int
    # int16 rank codes into the sorted distinct-coordinate dictionaries;
    # empty lists when a level's dictionary would overflow int16
    level_mbr_codes: List[torch.Tensor] = dataclasses.field(default_factory=list)  # (n, 4) i16
    level_dict_x: List[torch.Tensor] = dataclasses.field(default_factory=list)  # (Dx,) f32
    level_dict_y: List[torch.Tensor] = dataclasses.field(default_factory=list)  # (Dy,) f32
    # compact leaf verify bank; None when a leaf vocabulary overflows LEAF_DICT_MAX
    leaf_terms: Optional[torch.Tensor] = None  # (K, 32*Wl) i32 global term per bit, -1 pad
    leaf_obj_cbm: Optional[torch.Tensor] = None  # (K, OBJ, Wl) i32 compact bitmaps
    leaf_obj_sig: Optional[torch.Tensor] = None  # (K, OBJ) i32 OR-fold signatures

    @property
    def device(self) -> torch.device:
        return self.leaf_obj_x.device

    @property
    def n_levels(self) -> int:
        return len(self.level_mbrs)

    @property
    def n_leaves(self) -> int:
        return int(self.level_mbrs[-1].shape[0])

    @property
    def n_words(self) -> int:
        return int(self.level_bms[0].shape[1])

    @property
    def has_narrow_planes(self) -> bool:
        """True when every level carries int16 shadow MBR codes."""
        return len(self.level_mbr_codes) == len(self.level_mbrs) > 0

    @property
    def has_compact_bank(self) -> bool:
        """True when the leaf-local compact verify bank was built."""
        return self.leaf_obj_cbm is not None

    @property
    def n_compact_words(self) -> int:
        """Wl: words per object in the compact leaf bank."""
        return int(self.leaf_obj_cbm.shape[2])

    def root_width(self) -> int:
        """Bucketed width of the root frontier."""
        return round_up_bucket(int(self.level_mbrs[0].shape[0]))

    def nbytes(self) -> int:
        """Bytes of every tensor the snapshot holds on its device."""
        return _nbytes(self, ARRAY_FIELDS)

    def to(self, device) -> "IndexSnapshot":
        """The snapshot with every tensor on ``device`` (itself when they
        are there already)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return IndexSnapshot(obj_per_leaf=self.obj_per_leaf, **_moved(self, ARRAY_FIELDS, dev))

    def replicate(self, mesh) -> "IndexSnapshot":
        """The whole snapshot on a serving mesh rank's device (the
        query-parallel regime's replica)."""
        return self.to(mesh.device)

    @staticmethod
    def build(
        index: WiskIndex, dataset: GeoTextDataset, device=None, dense: bool = False
    ) -> "IndexSnapshot":
        """Freeze a host-side ``WiskIndex`` onto ``device`` (``cuda`` unless
        the caller passes another; raises when CUDA is absent).

        Leaf object blocks are padded to the power-of-two bucket of the
        largest cluster (``obj_per_leaf``), object ids ``-1``-padded.
        ``dense=True`` also builds the (n_up, n_down) int8 child matrix of
        every non-leaf level, which only ``retrieve(mode="dense")`` reads.
        """
        dev = resolve_device(device)
        child_table, child_counts, child_matrix = [], [], []
        for li, l in enumerate(index.levels[:-1]):
            child_table.append(padded_child_table(l))
            counts = np.diff(l.child_ptr).astype(np.int32)
            child_counts.append(counts)
            if dense:
                m = np.zeros((l.n, index.levels[li + 1].n), np.int8)
                m[np.repeat(np.arange(l.n), counts), l.child[: l.child_ptr[-1]]] = 1
                child_matrix.append(m)
        clusters = index.clusters
        sizes = np.diff(clusters.offsets)
        OBJ = round_up_bucket(int(sizes.max()))
        K = clusters.k
        W = dataset.words
        ox = np.zeros((K, OBJ), np.float32)
        oy = np.zeros((K, OBJ), np.float32)
        obm = np.zeros((K, OBJ, W), np.uint32)
        oid = np.full((K, OBJ), -1, np.int32)
        for c in range(K):
            ids = clusters.order[clusters.offsets[c] : clusters.offsets[c + 1]]
            ox[c, : ids.size] = dataset.locs[ids, 0]
            oy[c, : ids.size] = dataset.locs[ids, 1]
            obm[c, : ids.size] = dataset.kw_bitmap[ids]
            oid[c, : ids.size] = ids
        codes, dicts_x, dicts_y = encode_mbr_planes([l.mbrs for l in index.levels])
        lterms, lcbm, lsig = encode_leaf_vocab(obm)
        fields = dict(
            level_mbrs=[l.mbrs for l in index.levels],
            level_bms=[l.bitmaps for l in index.levels],
            child_table=child_table,
            child_counts=child_counts,
            child_matrix=child_matrix,
            leaf_obj_x=ox,
            leaf_obj_y=oy,
            leaf_obj_bm=obm,
            leaf_obj_id=oid,
            level_mbr_codes=codes,
            level_dict_x=dicts_x,
            level_dict_y=dicts_y,
            leaf_terms=lterms,
            leaf_obj_cbm=lcbm,
            leaf_obj_sig=lsig,
        )
        return IndexSnapshot.from_reference_arrays(fields, OBJ, dev)

    @staticmethod
    def from_reference_arrays(
        fields: Mapping[str, object], obj_per_leaf: int, device=None
    ) -> "IndexSnapshot":
        """The port's snapshot of the JAX package's: ``fields`` maps each
        name of its ``_ARRAY_FIELDS`` to ``np.asarray`` of the field (a list
        of arrays for per-level fields, None for an absent compact bank).
        Plays the role a weight converter plays for a model: both packages
        then serve the same index."""
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
        return IndexSnapshot(obj_per_leaf=int(obj_per_leaf), **kw)


# ------------------------------------------------ index-parallel partitioning
@dataclasses.dataclass(frozen=True, eq=False)
class IndexPartition:
    """Host-side cut of the level-0 (root) forest into shard-local subtrees.

    Each root subtree is assigned whole to one shard (greedy LPT on subtree
    leaf counts, deterministic tie-breaks), so every shard's node set is
    closed under the child relation and its sub-hierarchy is a self-contained
    index. ``nodes[li][s]`` lists shard ``s``'s global node ids at level
    ``li`` (sorted ascending: local id order IS global id order within a
    shard, which the engine's smallest-id tie-breaks rely on);
    ``shard_of``/``local_of`` are the per-level inverse maps.
    """

    n_shards: int
    root_to_shard: np.ndarray  # (n_root,) owning shard per root subtree
    nodes: List[List[np.ndarray]]  # [li][s] sorted global node ids
    shard_of: List[np.ndarray]  # [li] (n_li,) owning shard per node
    local_of: List[np.ndarray]  # [li] (n_li,) local index within the shard
    level_pads: Tuple[int, ...]  # stacked per-shard slab height per level
    n_leaves: int  # global leaf count

    @property
    def leaf_pad(self) -> int:
        return self.level_pads[-1]


def partition_index(snap: IndexSnapshot, n_shards: int) -> IndexPartition:
    """Cut ``snap``'s root forest into ``n_shards`` balanced subtree groups.

    Greedy LPT: roots are sorted by descending subtree leaf count (ties:
    smallest root id) and each is assigned to the currently lightest shard
    (ties: lowest shard id) -- deterministic, and within one subtree of the
    optimal balance. Requires ``n_root >= n_shards`` (the level-0 forest is
    the cut line). Host-only.
    """
    L = snap.n_levels
    n_root = int(snap.level_mbrs[0].shape[0])
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_root < n_shards:
        raise ValueError(
            f"cannot cut {n_root} root subtrees into {n_shards} shards; "
            "rebuild with a wider root forest or fewer index shards"
        )
    table = [t.cpu().numpy() for t in snap.child_table]
    # per-root per-level membership by BFS down the CSR tables
    members: List[List[np.ndarray]] = []
    for r in range(n_root):
        per_level = [np.array([r], np.int64)]
        for li in range(L - 1):
            rows = table[li][per_level[-1]]
            per_level.append(np.sort(rows[rows >= 0]).astype(np.int64))
        members.append(per_level)
    weights = [int(m[-1].size) for m in members]
    order = sorted(range(n_root), key=lambda r: (-weights[r], r))
    load = [0] * n_shards
    root_to_shard = np.zeros(n_root, np.int64)
    for r in order:
        s = min(range(n_shards), key=lambda i: (load[i], i))
        root_to_shard[r] = s
        load[s] += weights[r]
    nodes: List[List[np.ndarray]] = []
    for li in range(L):
        row = []
        for s in range(n_shards):
            ms = [members[r][li] for r in range(n_root) if root_to_shard[r] == s]
            row.append(np.sort(np.concatenate(ms)).astype(np.int64) if ms
                       else np.zeros(0, np.int64))
        nodes.append(row)
    shard_of, local_of = [], []
    for li in range(L):
        n_li = int(snap.level_mbrs[li].shape[0])
        so = np.full(n_li, -1, np.int64)
        lo = np.full(n_li, -1, np.int64)
        for s in range(n_shards):
            so[nodes[li][s]] = s
            lo[nodes[li][s]] = np.arange(nodes[li][s].size)
        shard_of.append(so)
        local_of.append(lo)
    level_pads = tuple(max(nodes[li][s].size for s in range(n_shards)) for li in range(L))
    return IndexPartition(
        n_shards=n_shards,
        root_to_shard=root_to_shard,
        nodes=nodes,
        shard_of=shard_of,
        local_of=local_of,
        level_pads=level_pads,
        n_leaves=snap.n_leaves,
    )


def _stack_shard_rows(arr: np.ndarray, ids_per_shard, pad_to: int, fill) -> np.ndarray:
    """Stack per-shard row subsets of ``arr`` into one (S*pad_to, ...) slab;
    pad rows get ``fill`` (a scalar, or a per-column row like
    ``NEVER_RECT``). The first dimension is the one the ``index`` mesh axis
    splits."""
    S = len(ids_per_shard)
    out = np.empty((S * pad_to, *arr.shape[1:]), arr.dtype)
    out[:] = fill
    for s, ids in enumerate(ids_per_shard):
        out[s * pad_to: s * pad_to + ids.size] = arr[ids]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# the partitioned snapshot's tensor fields, in the JAX package's order
PARTITION_FIELDS = (
    "level_mbrs",
    "level_bms",
    "child_table",
    "child_counts",
    "leaf_obj_x",
    "leaf_obj_y",
    "leaf_obj_bm",
    "leaf_obj_id",
    "root_gid",
    "leaf_gid",
    "level_counts",
    "level_mbr_codes",
    "level_dict_x",
    "level_dict_y",
    "leaf_terms",
    "leaf_obj_cbm",
    "leaf_obj_sig",
)


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionedSnapshot:
    """The index cut into shard-local sub-hierarchies, stacked on the host.

    Every per-node / per-leaf tensor of the base ``IndexSnapshot`` is laid
    out as ``(n_shards * pad, ...)``: shard ``s``'s slab occupies rows
    ``[s*pad, (s+1)*pad)``, padded with inert rows (``NEVER_RECT`` MBRs,
    zero bitmaps, ``-1`` ids). Child tables hold shard-LOCAL ids, so each
    slab is a closed sub-hierarchy; ``leaf_obj_id`` keeps GLOBAL object ids
    and ``root_gid``/``leaf_gid`` map local node slots back to global ids
    (the collectives' tie-break currency). The narrow int16 planes are
    re-encoded per shard against shard-local coordinate dictionaries (still
    lossless; none for the whole partition if any shard's dictionary
    overflows ``NARROW_DICT_MAX``). Bitmaps are int32 views, as in the
    snapshot; every tensor lives on the CPU until ``shard(mesh)``.
    """

    level_mbrs: List[torch.Tensor]  # per level: (S*Np, 4) f32
    level_bms: List[torch.Tensor]  # per level: (S*Np, W) i32
    child_table: List[torch.Tensor]  # (S*Np, fan) i32, shard-LOCAL child ids
    child_counts: List[torch.Tensor]  # (S*Np,) i32
    leaf_obj_x: torch.Tensor  # (S*Kp, OBJ) f32
    leaf_obj_y: torch.Tensor
    leaf_obj_bm: torch.Tensor  # (S*Kp, OBJ, W) i32
    leaf_obj_id: torch.Tensor  # (S*Kp, OBJ) i32 GLOBAL object ids, -1 pad
    root_gid: torch.Tensor  # (S*Np0,) i32 global node id per local root, -1 pad
    leaf_gid: torch.Tensor  # (S*Kp,) i32 global leaf id per local leaf, -1 pad
    level_counts: torch.Tensor  # (S, L) i32 real node count per (shard, level)
    obj_per_leaf: int
    n_shards: int
    part: IndexPartition
    level_mbr_codes: List[torch.Tensor] = dataclasses.field(default_factory=list)
    level_dict_x: List[torch.Tensor] = dataclasses.field(default_factory=list)  # (S*Dx,)
    level_dict_y: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # the compact leaf bank: leaf dictionaries are shard-local already, so
    # stacking selects each shard's leaf rows (Wl stays global)
    leaf_terms: Optional[torch.Tensor] = None  # (S*Kp, 32*Wl) i32, -1 pad
    leaf_obj_cbm: Optional[torch.Tensor] = None  # (S*Kp, OBJ, Wl) i32
    leaf_obj_sig: Optional[torch.Tensor] = None  # (S*Kp, OBJ) i32

    @property
    def n_levels(self) -> int:
        return len(self.level_mbrs)

    @property
    def n_leaves_global(self) -> int:
        return self.part.n_leaves

    @property
    def has_narrow_planes(self) -> bool:
        return len(self.level_mbr_codes) == len(self.level_mbrs) > 0

    @property
    def has_compact_bank(self) -> bool:
        return self.leaf_obj_cbm is not None

    def local_root_width(self) -> int:
        """Bucketed width of one shard's root frontier."""
        return round_up_bucket(self.part.level_pads[0])

    def nbytes(self) -> int:
        """Bytes of every stacked tensor (all shards)."""
        return _nbytes(self, PARTITION_FIELDS)

    def per_shard_bytes(self) -> int:
        """Bytes per index shard: each rank holds exactly one slab of every
        stacked tensor."""
        return self.nbytes() // self.n_shards

    def shard(self, mesh) -> IndexSnapshot:
        """This rank's slab on its device, as a plain ``IndexSnapshot``: every
        stacked tensor split along its first dimension over the mesh's
        ``index`` axis (logical axis ``leaf``), and only this rank's block
        moved. The slab is a closed sub-hierarchy (pad rows included), so
        the engine descends on it unchanged."""
        fields = [name for name in ARRAY_FIELDS if name != "child_matrix"]
        return IndexSnapshot(obj_per_leaf=self.obj_per_leaf, child_matrix=[],
                             **_slabs(self, fields, mesh))

    def shard_ids(self, mesh) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """This rank's ``(root_gid, leaf_gid)`` slabs on its device and its
        real root count (host int)."""
        kw = _slabs(self, ("root_gid", "leaf_gid", "level_counts"), mesh)
        return kw["root_gid"], kw["leaf_gid"], int(kw["level_counts"][0, 0])

    @staticmethod
    def build(snap: IndexSnapshot, n_shards: int) -> "PartitionedSnapshot":
        """Partition a built ``IndexSnapshot`` (on any device) into
        ``n_shards`` stacked shard-local sub-hierarchies, on the host (see
        ``partition_index``)."""
        part = partition_index(snap, n_shards)
        L = snap.n_levels
        S = n_shards
        pads = part.level_pads
        never = np.asarray(NEVER_RECT, np.float32)
        fields = dict(level_mbrs=[], level_bms=[], child_table=[], child_counts=[])
        for li in range(L):
            ids = part.nodes[li]
            fields["level_mbrs"].append(
                _stack_shard_rows(_host(snap.level_mbrs[li]), ids, pads[li], never))
            fields["level_bms"].append(_stack_shard_rows(_host(snap.level_bms[li]), ids, pads[li], 0))
            if li < L - 1:
                stacked = _stack_shard_rows(_host(snap.child_table[li]), ids, pads[li], -1)
                # global child ids -> shard-local ids (children live in the
                # parent's shard: subtrees are assigned whole)
                loc = part.local_of[li + 1][np.clip(stacked, 0, None)]
                fields["child_table"].append(np.where(stacked >= 0, loc, -1).astype(np.int32))
                fields["child_counts"].append(
                    _stack_shard_rows(_host(snap.child_counts[li]), ids, pads[li], 0))
        leaf_ids = part.nodes[L - 1]
        Kp = pads[L - 1]
        for name, fill in (("leaf_obj_x", 0.0), ("leaf_obj_y", 0.0), ("leaf_obj_bm", 0),
                           ("leaf_obj_id", -1)):
            fields[name] = _stack_shard_rows(_host(getattr(snap, name)), leaf_ids, Kp, fill)
        if snap.has_compact_bank:
            for name, fill in (("leaf_terms", -1), ("leaf_obj_cbm", 0), ("leaf_obj_sig", 0)):
                fields[name] = _stack_shard_rows(_host(getattr(snap, name)), leaf_ids, Kp, fill)
        n_of = [int(snap.level_mbrs[li].shape[0]) for li in range(L)]
        fields["root_gid"] = _stack_shard_rows(np.arange(n_of[0], dtype=np.int32), part.nodes[0],
                                               pads[0], -1)
        fields["leaf_gid"] = _stack_shard_rows(np.arange(n_of[-1], dtype=np.int32), leaf_ids, Kp,
                                               -1)
        fields["level_counts"] = np.stack(
            [[part.nodes[li][s].size for li in range(L)] for s in range(S)]).astype(np.int32)
        # per-shard narrow planes: re-encoded against shard-local dictionaries
        per_level = []
        narrow_ok = snap.has_narrow_planes
        for li in range(L if narrow_ok else 0):
            m = _host(snap.level_mbrs[li]).astype(np.float32)
            row = []
            for s in range(S):
                codes, dx, dy = encode_mbr_planes([m[part.nodes[li][s]]])
                if not codes:
                    narrow_ok = False
                    break
                row.append((codes[0], dx[0], dy[0]))
            if not narrow_ok:
                break
            per_level.append(row)
        if narrow_ok:
            fields.update(level_mbr_codes=[], level_dict_x=[], level_dict_y=[])
            for li, row in enumerate(per_level):
                cp = np.zeros((S * pads[li], 4), np.int16)
                Dx = max(r[1].size for r in row)
                Dy = max(r[2].size for r in row)
                dxp = np.zeros((S * Dx,), np.float32)
                dyp = np.zeros((S * Dy,), np.float32)
                for s, (c, dx, dy) in enumerate(row):
                    cp[s * pads[li]: s * pads[li] + c.shape[0]] = c
                    # dictionaries padded by repeating the last entry: pad
                    # slots are never addressed by a real (in-range) code
                    dxp[s * Dx:(s + 1) * Dx] = np.pad(dx, (0, Dx - dx.size), mode="edge")
                    dyp[s * Dy:(s + 1) * Dy] = np.pad(dy, (0, Dy - dy.size), mode="edge")
                fields["level_mbr_codes"].append(cp)
                fields["level_dict_x"].append(dxp)
                fields["level_dict_y"].append(dyp)
        return PartitionedSnapshot.from_reference_arrays(fields, snap.obj_per_leaf, part)

    @staticmethod
    def from_reference_arrays(
        fields: Mapping[str, object], obj_per_leaf: int, part: IndexPartition
    ) -> "PartitionedSnapshot":
        """A partitioned snapshot from stacked host arrays: ``fields`` maps
        each name of ``PARTITION_FIELDS`` to a numpy array (a list of them
        for per-level fields, None for an absent compact bank) -- the
        reference's ``PartitionedSnapshot`` fields through ``np.asarray``,
        or ``build``'s own -- and ``part`` is the cut they follow."""
        cpu = torch.device("cpu")
        kw = {}
        for name in PARTITION_FIELDS:
            v = fields.get(name)
            if v is None:
                kw[name] = [] if name in ("level_mbr_codes", "level_dict_x", "level_dict_y") \
                    else None
            elif isinstance(v, (list, tuple)):
                kw[name] = [to_device(a, cpu) for a in v]
            else:
                kw[name] = to_device(v, cpu)
        return PartitionedSnapshot(obj_per_leaf=int(obj_per_leaf), n_shards=part.n_shards,
                                   part=part, **kw)
