"""Analytic bytes-moved model for the serving descent (DESIGN.md §3.5): the
JAX package's ``roofline/descent_bytes.py``, priced at the H100's HBM rate.

The descent hot path is bandwidth-bound: every stage streams operand planes
whose shapes are static per compiled batch, so bytes moved is a deterministic
integer given (batch size, frontier widths, word counts, leaf-bank geometry).
This module prices the two descent representations and the three leaf-verify
variants so benchmarks/bench_roofline.py can put exact before/after counters
on the scoreboard (tools/bench_compare.py diffs them bit-for-bit -- any
drift is a semantic change, not noise).

Per-stage napkin model (one HBM touch per operand element; reuse inside a
kernel tile is free, re-gathers across levels are not):

Filter stage, one level at frontier width F over M queries
  legacy  M*F*(4*4 + W*4)        f32 MBR plane + full word plane per slot
  narrow  M*F*(4*2 + Wp*4)       int16 rank codes + packed nonzero words,
          + (Dx+Dy)*4            the per-level coordinate dictionaries
                                 (read once; they stay resident across tiles)
  both    + M*(16 + 4*Wq)        the query rects + query word plane
          + M*F                  the int8 survivor mask written back

Leaf verify over M queries x T selected leaves of OBJ padded objects
  unfused   3 * M*T*OBJ*(12+4W)  the candidate bytes are touched three
                                 times: the gather reads the bank rows,
                                 writes the (M, T*OBJ) slab to HBM, and the
                                 verify kernel re-reads the slab
  vmem      ceil(M/bm) * K*OBJ*(12+4W)  whole bank re-streamed per query
                                 block (valid only while the bank fits VMEM)
  prefetch  M*T*OBJ*(12+4W)      one DMA per (query, slot) block -- single
                                 pass, no slab bounce, any bank size
  (the ids/kwv output writes are identical across all three variants and
  excluded from the verify term)

Compact leaf-vocabulary verify (``compact_words=Wl`` > 0, DESIGN.md §3.5):
the per-object word plane shrinks from the global W words to the leaf-local
Wl words plus the one-word OR-fold signature, so every variant's per-object
term becomes 12 + 4 + 4*Wl. The remap of each query's packed word plane
into leaf-local ids adds, once per (query, selected leaf):
  remap     M*T*(32*Wl*4 + (Wl+1)*4)  the leaf's term dictionary row
                                 (32*Wl i32) read in, the remapped plane
                                 (Wl words) + signature (1 word) written out

Modeled milliseconds divide by the roofline's ``HBM_BW`` (analysis.py: the
H100 SXM's 3.35 TB/s). All byte counts are exact ints -- keep them that way
(scoreboard diffs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from .analysis import HBM_BW

_MBR_F32 = 4 * 4  # four f32 coordinates
_MBR_I16 = 4 * 2  # four int16 rank codes
_WORD = 4  # one uint32 bitmap word
_OBJ_FIXED = 3 * 4  # x, y (f32) + id (i32) per leaf object
_SIG = 4  # one uint32 OR-fold signature per leaf object (compact bank)


def filter_level_bytes(
    m: int,
    width: int,
    n_words: int,
    *,
    narrow: bool = False,
    packed_words: int = 0,
    dict_sizes: Tuple[int, int] = (0, 0),
) -> int:
    """Bytes one filter level moves for ``m`` queries at frontier ``width``.

    ``narrow`` prices the int16-code / packed-word representation:
    ``packed_words`` is the static packed width Wp (ops.pack_query_words)
    and ``dict_sizes`` the level's (Dx, Dy) dictionary lengths. The query
    operands use the same word width as the node planes (full W legacy,
    Wp narrow) and the int8 survivor mask is charged on both."""
    if narrow:
        per_slot = _MBR_I16 + packed_words * _WORD
        q_words = packed_words
        extra = (dict_sizes[0] + dict_sizes[1]) * 4
    else:
        per_slot = _MBR_F32 + n_words * _WORD
        q_words = n_words
        extra = 0
    return m * width * per_slot + m * (16 + q_words * _WORD) + m * width + extra


def remap_bytes(m: int, t: int, compact_words: int) -> int:
    """Bytes the leaf-local query remap moves for ``m`` queries x ``t`` slots.

    Per (query, selected leaf): the leaf's term-dictionary row (32*Wl i32)
    is read and the remapped word plane (Wl u32) plus the one-word signature
    are written (ops.remap_query_words)."""
    return m * t * (32 * compact_words * 4 + (compact_words + 1) * _WORD)


def verify_bytes(
    m: int,
    t: int,
    obj_per_leaf: int,
    n_words: int,
    n_leaves: int,
    variant: str,
    bm: int = 8,
    compact_words: int = 0,
) -> int:
    """Bytes the leaf verify stage moves for ``m`` queries x ``t`` slots.

    ``variant`` is one of ``unfused`` / ``vmem`` / ``prefetch`` (the engine's
    three hot-path variants, DESIGN.md §3.5); ``bm`` is the query block of
    the VMEM-fused kernel. ``compact_words`` > 0 prices the leaf-local
    vocabulary bank instead: Wl-word object planes plus the one-word
    signature, with the per-(query, slot) remap term added on top."""
    if compact_words > 0:
        per_obj = _OBJ_FIXED + _SIG + compact_words * _WORD
        extra = remap_bytes(m, t, compact_words)
    else:
        per_obj = _OBJ_FIXED + n_words * _WORD
        extra = 0
    if variant == "unfused":
        return 3 * m * t * obj_per_leaf * per_obj + extra
    if variant == "vmem":
        blocks = -(-m // bm)
        return blocks * n_leaves * obj_per_leaf * per_obj + extra
    if variant == "prefetch":
        return m * t * obj_per_leaf * per_obj + extra
    raise ValueError(f"unknown verify variant {variant!r}")


def modeled_ms(n_bytes: int) -> float:
    """Bandwidth-bound wall time (ms) for ``n_bytes`` at the H100's HBM
    rate -- a lower bound ranking representations, not a latency predictor."""
    return n_bytes / HBM_BW * 1e3


@dataclasses.dataclass(frozen=True)
class DescentBytes:
    """Exact bytes-moved decomposition of one compiled descent batch."""

    filter_bytes: int  # sum over levels of filter_level_bytes
    verify_bytes: int  # the chosen verify variant's bytes
    per_level: Tuple[int, ...]  # the filter term per level, root first

    @property
    def total(self) -> int:
        return self.filter_bytes + self.verify_bytes

    @property
    def total_ms(self) -> float:
        return modeled_ms(self.total)


def descent_bytes(
    m: int,
    widths: Sequence[int],
    n_words: int,
    *,
    narrow: bool = False,
    packed_words: int = 0,
    dict_sizes: Sequence[Tuple[int, int]] = (),
    t: int = 0,
    obj_per_leaf: int = 0,
    n_leaves: int = 0,
    verify_variant: str = "prefetch",
    bm: int = 8,
    compact_words: int = 0,
) -> DescentBytes:
    """Price a whole descent: per-level filter widths + one verify variant.

    ``widths`` are the converged padded frontier widths (engine output
    ``frontier_widths``), root first; ``dict_sizes`` parallels them when
    ``narrow``. ``t=0`` prices a filter-only descent (verify term 0);
    ``compact_words`` > 0 prices the leaf-local compact verify bank."""
    dsz = list(dict_sizes) or [(0, 0)] * len(widths)
    per_level = tuple(
        filter_level_bytes(
            m, int(w), n_words,
            narrow=narrow, packed_words=packed_words, dict_sizes=dsz[i],
        )
        for i, w in enumerate(widths)
    )
    vb = 0
    if t > 0:
        vb = verify_bytes(m, t, obj_per_leaf, n_words, n_leaves, verify_variant,
                          bm, compact_words=compact_words)
    return DescentBytes(sum(per_level), vb, per_level)


def compare(legacy: DescentBytes, narrow: DescentBytes) -> Dict[str, object]:
    """The scoreboard-facing summary of a legacy/narrow descent pair."""
    return {
        "legacy_bytes": legacy.total,
        "narrow_bytes": narrow.total,
        "ratio": legacy.total / max(narrow.total, 1),
        "legacy_ms": legacy.total_ms,
        "narrow_ms": narrow.total_ms,
    }
