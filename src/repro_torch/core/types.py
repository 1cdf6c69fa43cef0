"""Core data types for WISK: geo-textual datasets, workloads, clusters, index.

Host-side numpy containers, kept bit-for-bit in step with the JAX
package's ``core/types.py`` so both packages build the same index from the
same seed. Everything is stored as dense, fixed-shape arrays. Keyword sets
are represented twice:

* ``kw_ids``  -- ``(n, max_kw) int32`` padded with ``-1`` (exact sets, used by
  host-side construction and the serial reference query path), and
* ``kw_bitmap`` -- ``(n, words) uint32`` bitmaps over the vocabulary (used by
  the vectorized filtering and verification paths; the serving snapshot
  keeps them on the card as ``int32`` views of the same bits).

Coordinates live in the unit square ``[0,1]^2``; rectangles are
``(xlo, ylo, xhi, yhi)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Array = Any  # np.ndarray or torch.Tensor


def bitmap_words(vocab_size: int) -> int:
    return (vocab_size + 31) // 32


def ids_to_bitmap(kw_ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """Convert padded id lists ``(n, k)`` (pad=-1) to uint32 bitmaps ``(n, W)``."""
    n = kw_ids.shape[0]
    W = bitmap_words(vocab_size)
    bm = np.zeros((n, W), dtype=np.uint32)
    rows, cols = np.nonzero(kw_ids >= 0)
    ids = kw_ids[rows, cols].astype(np.int64)
    np.bitwise_or.at(bm, (rows, ids // 32), (np.uint32(1) << (ids % 32).astype(np.uint32)))
    return bm


def set_bits(bitmaps: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row, term) of every set bit of (rows, W) u32 bitmaps, row-major:
    only the nonzero words are unpacked."""
    rows, words = np.nonzero(bitmaps)
    bits = np.unpackbits(np.ascontiguousarray(bitmaps[rows, words]).view(np.uint8).reshape(-1, 4),
                         axis=1, bitorder="little")
    hit, bit = np.nonzero(bits)
    return rows[hit], words[hit].astype(np.int64) * 32 + bit


def bitmap_intersects(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rowwise: does bitmap a[i] share any bit with b[i]? Shapes broadcast."""
    return np.any((a & b) != 0, axis=-1)


@dataclasses.dataclass
class GeoTextDataset:
    """A geo-textual object collection.

    locs:      (n, 2) float32 in [0,1]^2
    kw_ids:    (n, max_kw) int32, padded with -1
    kw_bitmap: (n, W) uint32
    kw_freq:   (V,) int64 -- #objects containing each keyword
    """

    locs: np.ndarray
    kw_ids: np.ndarray
    kw_bitmap: np.ndarray
    vocab_size: int
    kw_freq: np.ndarray

    @property
    def n(self) -> int:
        return int(self.locs.shape[0])

    @property
    def words(self) -> int:
        return int(self.kw_bitmap.shape[1])

    @staticmethod
    def from_ids(locs: np.ndarray, kw_ids: np.ndarray, vocab_size: int) -> "GeoTextDataset":
        locs = np.asarray(locs, dtype=np.float32)
        kw_ids = np.asarray(kw_ids, dtype=np.int32)
        bm = ids_to_bitmap(kw_ids, vocab_size)
        flat = kw_ids[kw_ids >= 0]
        freq = np.bincount(flat, minlength=vocab_size).astype(np.int64)
        return GeoTextDataset(locs, kw_ids, bm, vocab_size, freq)

    def subset(self, idx: np.ndarray) -> "GeoTextDataset":
        return GeoTextDataset(
            self.locs[idx], self.kw_ids[idx], self.kw_bitmap[idx], self.vocab_size, self.kw_freq
        )


@dataclasses.dataclass
class Workload:
    """A batch of SKR queries.

    rects:     (m, 4) float32 (xlo, ylo, xhi, yhi)
    kw_ids:    (m, max_qk) int32 padded -1
    kw_bitmap: (m, W) uint32
    """

    rects: np.ndarray
    kw_ids: np.ndarray
    kw_bitmap: np.ndarray
    vocab_size: int

    @property
    def m(self) -> int:
        return int(self.rects.shape[0])

    @staticmethod
    def from_ids(rects: np.ndarray, kw_ids: np.ndarray, vocab_size: int) -> "Workload":
        rects = np.asarray(rects, dtype=np.float32)
        kw_ids = np.asarray(kw_ids, dtype=np.int32)
        return Workload(rects, kw_ids, ids_to_bitmap(kw_ids, vocab_size), vocab_size)

    def subset(self, idx: np.ndarray) -> "Workload":
        return Workload(self.rects[idx], self.kw_ids[idx], self.kw_bitmap[idx], self.vocab_size)

    def concat(self, other: "Workload") -> "Workload":
        assert self.vocab_size == other.vocab_size
        k = max(self.kw_ids.shape[1], other.kw_ids.shape[1])

        def pad(a):
            return np.pad(a, ((0, 0), (0, k - a.shape[1])), constant_values=-1)

        return Workload(
            np.concatenate([self.rects, other.rects], 0),
            np.concatenate([pad(self.kw_ids), pad(other.kw_ids)], 0),
            np.concatenate([self.kw_bitmap, other.kw_bitmap], 0),
            self.vocab_size,
        )


def rects_intersect(rects_a: np.ndarray, rects_b: np.ndarray) -> np.ndarray:
    """Pairwise-broadcast rectangle intersection test (closed rectangles)."""
    axlo, aylo, axhi, ayhi = (rects_a[..., i] for i in range(4))
    bxlo, bylo, bxhi, byhi = (rects_b[..., i] for i in range(4))
    return (axlo <= bxhi) & (bxlo <= axhi) & (aylo <= byhi) & (bylo <= ayhi)


def points_in_rect(locs: np.ndarray, rect: np.ndarray) -> np.ndarray:
    return (
        (locs[..., 0] >= rect[..., 0])
        & (locs[..., 0] <= rect[..., 2])
        & (locs[..., 1] >= rect[..., 1])
        & (locs[..., 1] <= rect[..., 3])
    )


@dataclasses.dataclass
class ClusterSet:
    """A flat partition of the dataset into k clusters (WISK bottom clusters).

    assign:  (n,) int32 cluster id per object
    order:   (n,) int32 object ids sorted by cluster (CSR payload)
    offsets: (k+1,) int64 CSR offsets into ``order``
    mbrs:    (k, 4) float32 MBR of member objects
    bitmaps: (k, W) uint32 OR of member bitmaps
    """

    assign: np.ndarray
    order: np.ndarray
    offsets: np.ndarray
    mbrs: np.ndarray
    bitmaps: np.ndarray

    @property
    def k(self) -> int:
        return int(self.mbrs.shape[0])

    @staticmethod
    def from_assignment(dataset: GeoTextDataset, assign: np.ndarray) -> "ClusterSet":
        assign = np.asarray(assign, dtype=np.int32)
        k = int(assign.max()) + 1 if assign.size else 0
        order = np.argsort(assign, kind="stable").astype(np.int32)
        counts = np.bincount(assign, minlength=k)
        offsets = np.zeros(k + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        mbrs = np.zeros((k, 4), dtype=np.float32)
        W = dataset.words
        bitmaps = np.zeros((k, W), dtype=np.uint32)
        locs = dataset.locs
        for c in range(k):
            ids = order[offsets[c] : offsets[c + 1]]
            if ids.size == 0:
                mbrs[c] = (1.0, 1.0, 0.0, 0.0)  # empty (never intersects)
                continue
            pl = locs[ids]
            mbrs[c] = (pl[:, 0].min(), pl[:, 1].min(), pl[:, 0].max(), pl[:, 1].max())
            bitmaps[c] = np.bitwise_or.reduce(dataset.kw_bitmap[ids], axis=0)
        return ClusterSet(assign, order, offsets, mbrs, bitmaps)

    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)


@dataclasses.dataclass
class InvertedFile:
    """CSR inverted file per (cluster, keyword): cluster-local postings.

    For cluster c: keywords ``kw[kw_ptr[c]:kw_ptr[c+1]]`` sorted ascending,
    keyword j's postings are ``obj[obj_ptr[kw_ptr[c]+j] : obj_ptr[kw_ptr[c]+j+1]]``
    (global object ids).
    """

    kw_ptr: np.ndarray  # (k+1,) int64
    kw: np.ndarray  # (nnz_kw,) int32
    obj_ptr: np.ndarray  # (nnz_kw+1,) int64
    obj: np.ndarray  # (nnz_post,) int32

    @staticmethod
    def build(dataset: GeoTextDataset, clusters: ClusterSet) -> "InvertedFile":
        k = clusters.k
        kw_ptr = np.zeros(k + 1, dtype=np.int64)
        kws: List[np.ndarray] = []
        obj_lists: List[np.ndarray] = []
        obj_counts: List[int] = []
        for c in range(k):
            ids = clusters.order[clusters.offsets[c] : clusters.offsets[c + 1]]
            if ids.size:
                pairs_obj = np.repeat(ids, np.sum(dataset.kw_ids[ids] >= 0, axis=1))
                pairs_kw = dataset.kw_ids[ids][dataset.kw_ids[ids] >= 0]
                srt = np.argsort(pairs_kw, kind="stable")
                pairs_kw, pairs_obj = pairs_kw[srt], pairs_obj[srt]
                uk, start = np.unique(pairs_kw, return_index=True)
                counts = np.diff(np.append(start, pairs_kw.size))
                kws.append(uk.astype(np.int32))
                for s, cnt in zip(start, counts):
                    obj_lists.append(pairs_obj[s : s + cnt].astype(np.int32))
                    obj_counts.append(int(cnt))
                kw_ptr[c + 1] = kw_ptr[c] + uk.size
            else:
                kw_ptr[c + 1] = kw_ptr[c]
        kw = np.concatenate(kws) if kws else np.zeros(0, dtype=np.int32)
        obj_ptr = np.zeros(kw.size + 1, dtype=np.int64)
        np.cumsum(np.asarray(obj_counts, dtype=np.int64), out=obj_ptr[1:]) if obj_counts else None
        obj = np.concatenate(obj_lists) if obj_lists else np.zeros(0, dtype=np.int32)
        return InvertedFile(kw_ptr, kw, obj_ptr, obj)

    def nbytes(self) -> int:
        return self.kw_ptr.nbytes + self.kw.nbytes + self.obj_ptr.nbytes + self.obj.nbytes


@dataclasses.dataclass
class Level:
    """One level of the WISK hierarchy (dense arrays over nodes).

    ``child_ptr/child`` give the CSR of children in the level below
    (leaf level: children index bottom clusters == themselves).
    """

    mbrs: np.ndarray  # (n, 4) float32
    bitmaps: np.ndarray  # (n, W) uint32
    child_ptr: np.ndarray  # (n+1,) int64
    child: np.ndarray  # (nnz,) int32

    @property
    def n(self) -> int:
        return int(self.mbrs.shape[0])


@dataclasses.dataclass
class WiskIndex:
    """The assembled index: levels[0] is the root level, levels[-1] the leaves
    (bottom clusters); ``inv`` is the leaf-level inverted file."""

    levels: List[Level]
    clusters: ClusterSet
    inv: InvertedFile
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def height(self) -> int:
        return len(self.levels)

    def num_nodes(self) -> int:
        return sum(l.n for l in self.levels)

    def nbytes(self) -> int:
        total = self.inv.nbytes()
        for l in self.levels:
            total += l.mbrs.nbytes + l.bitmaps.nbytes + l.child_ptr.nbytes + l.child.nbytes
        total += self.clusters.offsets.nbytes + self.clusters.order.nbytes
        return total
