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
tensors on ``device`` (``cuda`` unless the caller passes another).
"""
from __future__ import annotations

import dataclasses
from typing import List, Mapping, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.query import padded_child_table, round_up_bucket
from ..core.types import GeoTextDataset, WiskIndex, set_bits

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
        total = 0
        for name in ARRAY_FIELDS:
            v = getattr(self, name)
            for t in v if isinstance(v, list) else [v]:
                if t is not None:
                    total += t.numel() * t.element_size()
        return total

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
