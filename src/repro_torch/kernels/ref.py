"""Plain PyTorch versions of the serving kernels (the kernels' oracles).

Each function has the semantics of the same-named oracle in the JAX
package's ``kernels/ref.py``. Bitmaps are ``int32`` tensors holding the
bits of the reference's ``uint32`` words (``.view(np.int32)``), so every
keyword test is a bitwise AND against zero and no value changes. The range
predicates only compare floats; the kNN distances compute ``dx*dx + dy*dy``
op by op (eager PyTorch never fuses it into a multiply-add), which is the
reference oracles' and the host ``_mbr_dist2_f32``'s arithmetic and what
the CUDA kernels in ``csrc/`` reproduce with ``__fmul_rn``/``__fadd_rn``.

The dense cross products (``skr_filter_ref``, ``sub_match_ref``,
``sub_match_packed_ref``, ``sub_match_pairs_ref``) and the CDF bank (``cdf_mlp_ref``) work in chunks
of queries, objects or points: whole, their (M, K, W) and (N, S, W) AND
planes and (N, B, H) activations would take many GB at serving shapes.

``kernels/ops.py`` sends a CPU tensor here; on the card ``chip_smoke.py``
holds each CUDA kernel against these functions on the same inputs.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

# elements of the largest intermediate a chunked plain version makes at once
_CHUNK_ELEMS = 1 << 26


def _row_chunks(n_rows: int, elems_per_row: int):
    """Slices of at most ``_CHUNK_ELEMS // elems_per_row`` rows (at least one)
    covering ``range(n_rows)``."""
    step = max(1, _CHUNK_ELEMS // max(int(elems_per_row), 1))
    for r0 in range(0, n_rows, step):
        yield slice(r0, min(r0 + step, n_rows))


def frontier_filter_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    f_mbrs: torch.Tensor,  # (M, F, 4) f32 -- MBRs gathered at each frontier slot
    f_bm: torch.Tensor,  # (M, F, W) i32
    f_valid: torch.Tensor,  # (M, F) int8 (1 = slot holds a real node)
) -> torch.Tensor:
    """(M, F) int8: frontier slot survives (MBR intersect AND bitmap AND valid)."""
    inter = (
        (q_rects[:, None, 0] <= f_mbrs[:, :, 2])
        & (f_mbrs[:, :, 0] <= q_rects[:, None, 2])
        & (q_rects[:, None, 1] <= f_mbrs[:, :, 3])
        & (f_mbrs[:, :, 1] <= q_rects[:, None, 3])
    )
    kw = ((f_bm & q_bm[:, None, :]) != 0).any(dim=-1)
    return (inter & kw & (f_valid > 0)).to(torch.int8)


def frontier_filter_narrow_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bits: torch.Tensor,  # (M, Wp) i32 -- packed nonzero query words
    f_codes: torch.Tensor,  # (M, F, 4) int16 -- MBR rank codes
    f_bm: torch.Tensor,  # (M, F, Wp) i32 -- packed node word planes
    f_valid: torch.Tensor,  # (M, F) int8
    dict_x: torch.Tensor,  # (Dx,) f32 sorted distinct x coords
    dict_y: torch.Tensor,  # (Dy,) f32 sorted distinct y coords
) -> torch.Tensor:
    """Narrow-plane twin of ``frontier_filter_ref``: dequantize the int16
    rank codes through the per-level coordinate dictionaries (exact -- every
    code indexes the f32 value it was built from), then apply the identical
    intersect/keyword/validity predicate on the packed word planes."""
    return frontier_filter_ref(q_rects, q_bits, _dequantize(f_codes, dict_x, dict_y), f_bm, f_valid)


def frontier_level_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    level_mbrs: torch.Tensor,  # (N, 4) f32 -- one level's MBRs
    level_bms: torch.Tensor,  # (N, W) i32 -- one level's bitmaps
    frontier: torch.Tensor,  # (M, F) i32 node ids, -1 = empty slot
) -> torch.Tensor:
    """``frontier_filter_ref`` on the level arrays gathered at the frontier
    (node ids clamped to ``[0, N-1]``; slots with id -1 invalid)."""
    safe = frontier.clamp(0, level_bms.shape[0] - 1).long()
    return frontier_filter_ref(q_rects, q_bm, level_mbrs[safe], level_bms[safe],
                               (frontier >= 0).to(torch.int8))


def frontier_level_narrow_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    level_codes: torch.Tensor,  # (N, 4) int16 -- one level's MBR rank codes
    level_bms: torch.Tensor,  # (N, W) i32 -- one level's bitmaps
    frontier: torch.Tensor,  # (M, F) i32 node ids, -1 = empty slot
    dict_x: torch.Tensor,  # (Dx,) f32 -- the level's coordinate dictionaries
    dict_y: torch.Tensor,  # (Dy,) f32
) -> torch.Tensor:
    """``frontier_filter_narrow_ref`` on the level's narrow planes gathered
    at the frontier, as ``frontier_level_ref`` gathers the f32 ones."""
    safe = frontier.clamp(0, level_bms.shape[0] - 1).long()
    return frontier_filter_narrow_ref(q_rects, q_bm, level_codes[safe], level_bms[safe],
                                      (frontier >= 0).to(torch.int8), dict_x, dict_y)


def _dequantize(f_codes, dict_x, dict_y):
    """(M, F, 4) f32 MBRs from int16 rank codes (exact: each code indexes
    the f32 value it was built from). Codes clamp to the dictionaries, as
    the CUDA kernels' ``dequantize_mbr`` does; the snapshot's encoder never
    emits one out of range."""
    fc = f_codes.long()
    cx = fc[:, :, 0::2].clamp(0, dict_x.shape[0] - 1)
    cy = fc[:, :, 1::2].clamp(0, dict_y.shape[0] - 1)
    return torch.stack(
        [dict_x[cx[:, :, 0]], dict_y[cy[:, :, 0]], dict_x[cx[:, :, 1]], dict_y[cy[:, :, 1]]],
        dim=-1,
    )


def knn_filter_ref(
    q_pts: torch.Tensor,  # (M, 2) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    f_mbrs: torch.Tensor,  # (M, F, 4) f32 -- MBRs gathered at each frontier slot
    f_bm: torch.Tensor,  # (M, F, W) i32
    f_valid: torch.Tensor,  # (M, F) int8
) -> torch.Tensor:
    """(M, F) f32 squared point-to-MBR min-distance; +inf where the slot is
    invalid or its bitmap shares no bit with the query's."""
    px = q_pts[:, 0:1]
    py = q_pts[:, 1:2]
    zero = torch.zeros((), dtype=torch.float32, device=q_pts.device)
    dx = torch.maximum(torch.maximum(f_mbrs[:, :, 0] - px, px - f_mbrs[:, :, 2]), zero)
    dy = torch.maximum(torch.maximum(f_mbrs[:, :, 1] - py, py - f_mbrs[:, :, 3]), zero)
    d2 = dx * dx + dy * dy
    kw = ((f_bm & q_bm[:, None, :]) != 0).any(dim=-1)
    return torch.where(kw & (f_valid > 0), d2, torch.full_like(d2, float("inf")))


def knn_level_dist_ref(
    q_pts: torch.Tensor,  # (M, 2) f32
    q_wids: torch.Tensor,  # (M, Wp) i32 -- packed query word ids
    q_bits: torch.Tensor,  # (M, Wp) i32 -- packed query word values
    level_mbrs: torch.Tensor,  # (N, 4) f32 -- one level's MBRs
    level_bms: torch.Tensor,  # (N, W) i32 -- one level's bitmaps
    frontier: torch.Tensor,  # (M, F) i32 node ids, -1 = empty slot
) -> torch.Tensor:
    """``knn_filter_ref`` on the level arrays gathered at the frontier (node
    ids clamped to ``[0, N-1]``; slots with id -1 invalid), the bitmaps only
    at the query's packed words. Exact by ``pack_query_words``' argument:
    ``OR_w (bm & q) == OR_p (bits & gathered)``."""
    safe, f_bm, valid = _at_frontier(level_bms, q_wids, frontier)
    return knn_filter_ref(q_pts, q_bits, level_mbrs[safe], f_bm, valid)


def knn_level_dist_narrow_ref(
    q_pts: torch.Tensor,  # (M, 2) f32
    q_wids: torch.Tensor,  # (M, Wp) i32 -- packed query word ids
    q_bits: torch.Tensor,  # (M, Wp) i32 -- packed query word values
    level_codes: torch.Tensor,  # (N, 4) int16 -- one level's MBR rank codes
    level_bms: torch.Tensor,  # (N, W) i32 -- one level's bitmaps
    frontier: torch.Tensor,  # (M, F) i32 node ids, -1 = empty slot
    dict_x: torch.Tensor,  # (Dx,) f32 -- the level's coordinate dictionaries
    dict_y: torch.Tensor,  # (Dy,) f32
) -> torch.Tensor:
    """``knn_filter_narrow_ref`` on the level's narrow planes gathered at
    the frontier, as ``knn_level_dist_ref`` gathers the f32 ones."""
    safe, f_bm, valid = _at_frontier(level_bms, q_wids, frontier)
    return knn_filter_narrow_ref(q_pts, q_bits, level_codes[safe], f_bm, valid, dict_x, dict_y)


def _at_frontier(level_bms, q_wids, frontier):
    """The frontier's node ids clamped to the level (int64), the node words
    at the query's packed words (M, F, Wp), and the int8 mask of real slots."""
    safe = frontier.clamp(0, level_bms.shape[0] - 1).long()
    f_bm = level_bms[safe[:, :, None], q_wids.long()[:, None, :]]
    return safe, f_bm, (frontier >= 0).to(torch.int8)


def knn_filter_narrow_ref(
    q_pts: torch.Tensor,  # (M, 2) f32
    q_bits: torch.Tensor,  # (M, Wp) i32 -- packed nonzero query words
    f_codes: torch.Tensor,  # (M, F, 4) int16 -- MBR rank codes
    f_bm: torch.Tensor,  # (M, F, Wp) i32 -- packed node word planes
    f_valid: torch.Tensor,  # (M, F) int8
    dict_x: torch.Tensor,  # (Dx,) f32
    dict_y: torch.Tensor,  # (Dy,) f32
) -> torch.Tensor:
    """Narrow-plane twin of ``knn_filter_ref`` (exact dictionary
    dequantization, then identical distance/keyword semantics)."""
    return knn_filter_ref(q_pts, q_bits, _dequantize(f_codes, dict_x, dict_y), f_bm, f_valid)


def _in_rect(q_rects: torch.Tensor, cand_x: torch.Tensor, cand_y: torch.Tensor) -> torch.Tensor:
    """(M, C) bool: candidate point inside its query's closed rectangle."""
    return (
        (cand_x >= q_rects[:, 0:1])
        & (cand_x <= q_rects[:, 2:3])
        & (cand_y >= q_rects[:, 1:2])
        & (cand_y <= q_rects[:, 3:4])
    )


def skr_verify_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    cand_x: torch.Tensor,  # (M, C) f32
    cand_y: torch.Tensor,  # (M, C) f32
    cand_bm: torch.Tensor,  # (M, C, W) i32
    cand_valid: torch.Tensor,  # (M, C) int8 (1 = real candidate)
) -> torch.Tensor:
    """(M, C) int8: candidate in-rect, keyword-matching on all W words, and valid."""
    kw = ((cand_bm & q_bm[:, None, :]) != 0).any(dim=-1)
    return (_in_rect(q_rects, cand_x, cand_y) & kw & (cand_valid > 0)).to(torch.int8)


def _fused_verify_gathered(q_rects, q_words, cbm, top_leaf, leaf_ok, obj_x, obj_y, obj_id):
    """The fused verify on the selected leaves' word plane ``cbm`` (M,
    T*OBJ, n), already gathered at the n words that ``q_words`` (M, n)
    holds. Returns ``(ids, kwv)``."""
    M, T = top_leaf.shape
    K, OBJ = obj_x.shape
    safe = top_leaf.clamp(0, K - 1).long()
    cx = obj_x[safe].reshape(M, -1)
    cy = obj_y[safe].reshape(M, -1)
    cid = obj_id[safe].reshape(M, -1)
    cval = (cid >= 0) & (leaf_ok > 0).repeat_interleave(OBJ, dim=1)
    match = skr_verify_ref(q_rects, q_words, cx, cy, cbm, cval.to(torch.int8))
    ids = torch.where(match > 0, cid, torch.full_like(cid, -1))
    kw = ((cbm & q_words[:, None, :]) != 0).any(dim=-1)
    kwv = (kw & cval).reshape(M, T, OBJ).sum(dim=2, dtype=torch.int32)
    return ids, kwv


def fused_verify_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32
    top_leaf: torch.Tensor,  # (M, T) int32 selected leaf ids
    leaf_ok: torch.Tensor,  # (M, T) int8
    obj_x: torch.Tensor,  # (K, OBJ) f32 leaf object bank
    obj_y: torch.Tensor,  # (K, OBJ) f32
    obj_bm: torch.Tensor,  # (K, OBJ, W) i32 full-width bitmap slab
    obj_id: torch.Tensor,  # (K, OBJ) int32, -1 pad
):
    """Gather the selected leaves' full-width blocks (leaf ids clamped to
    ``[0, K-1]``), then apply ``skr_verify_ref``. Returns ``(ids, kwv)`` as
    ``fused_verify_compact_ref`` does: kwv counts keyword-matching valid
    candidates per slot, inside the rectangle or not."""
    M, T = top_leaf.shape
    safe = top_leaf.clamp(0, obj_x.shape[0] - 1).long()
    cbm = obj_bm[safe].reshape(M, -1, obj_bm.shape[2])
    return _fused_verify_gathered(q_rects, q_bm, cbm, top_leaf, leaf_ok, obj_x, obj_y, obj_id)


def fused_verify_packed_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_wids: torch.Tensor,  # (M, Wp) i32 -- packed query word ids
    q_bits: torch.Tensor,  # (M, Wp) i32 -- packed query word values
    top_leaf: torch.Tensor,  # (M, T) int32 selected leaf ids
    leaf_ok: torch.Tensor,  # (M, T) int8
    obj_x: torch.Tensor,  # (K, OBJ) f32 leaf object bank
    obj_y: torch.Tensor,  # (K, OBJ) f32
    obj_bm: torch.Tensor,  # (K, OBJ, W) i32 full-width bitmap slab
    obj_id: torch.Tensor,  # (K, OBJ) int32, -1 pad
):
    """``fused_verify_ref`` with the selected blocks' bitmaps read only at
    each query's packed words (``pack_query_words``): equal to it on the
    full-width bitmap the packing came from."""
    M, T = top_leaf.shape
    K, OBJ = obj_x.shape
    safe = top_leaf.clamp(0, K - 1).long()
    objs = torch.arange(OBJ, device=obj_bm.device)
    cbm = obj_bm[safe[:, :, None, None], objs[None, None, :, None],
                 q_wids.long()[:, None, None, :]]  # (M, T, OBJ, Wp)
    return _fused_verify_gathered(q_rects, q_bits, cbm.reshape(M, T * OBJ, -1), top_leaf,
                                  leaf_ok, obj_x, obj_y, obj_id)


def skr_verify_compact_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_cbm: torch.Tensor,  # (M, T, Wl) i32 leaf-local remapped query words
    q_sig: torch.Tensor,  # (M, T) i32 per-(query, slot) signature
    cand_x: torch.Tensor,  # (M, T*OBJ) f32, leaf-slot-major
    cand_y: torch.Tensor,  # (M, T*OBJ) f32
    cand_cbm: torch.Tensor,  # (M, T*OBJ, Wl) i32 compact candidate bitmaps
    cand_sig: torch.Tensor,  # (M, T*OBJ) i32 candidate signatures
    cand_valid: torch.Tensor,  # (M, T*OBJ) int8
) -> torch.Tensor:
    """(M, T*OBJ) int8: candidate in-rect, keyword-matching on the leaf-local
    vocabulary (one-word signature AND the ``Wl``-word any-AND), and valid."""
    T = q_sig.shape[1]
    OBJ = cand_x.shape[1] // T
    qc = q_cbm.repeat_interleave(OBJ, dim=1)  # (M, T*OBJ, Wl)
    qs = q_sig.repeat_interleave(OBJ, dim=1)  # (M, T*OBJ)
    sig_hit = (cand_sig & qs) != 0
    kw = sig_hit & ((cand_cbm & qc) != 0).any(dim=-1)
    return (_in_rect(q_rects, cand_x, cand_y) & kw & (cand_valid > 0)).to(torch.int8)


def fused_verify_compact_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_cbm: torch.Tensor,  # (M, T, Wl) i32 leaf-local remapped query words
    q_sig: torch.Tensor,  # (M, T) i32
    top_leaf: torch.Tensor,  # (M, T) int32 selected leaf ids
    leaf_ok: torch.Tensor,  # (M, T) int8
    obj_x: torch.Tensor,  # (K, OBJ) f32 leaf object bank
    obj_y: torch.Tensor,  # (K, OBJ) f32
    obj_cbm: torch.Tensor,  # (K, OBJ, Wl) i32 compact bitmap slab
    obj_sig: torch.Tensor,  # (K, OBJ) i32 OR-fold signatures
    obj_id: torch.Tensor,  # (K, OBJ) int32, -1 pad
):
    """Gather the selected leaves' compact blocks (leaf ids clamped to
    ``[0, K-1]``), then apply ``skr_verify_compact_ref``.

    Returns ``(ids, kwv)``: ids (M, T*OBJ) i32 -- matching object ids in
    leaf-slot-major order, ``-1`` elsewhere; kwv (M, T) i32 -- per-slot
    counts of keyword-matching valid candidates, inside the rectangle or
    not (the Eq. 1 ``verified`` partial sums).
    """
    M, T = top_leaf.shape
    K, OBJ = obj_x.shape
    safe = top_leaf.clamp(0, K - 1).long()
    cx = obj_x[safe].reshape(M, -1)  # (M, T*OBJ)
    cy = obj_y[safe].reshape(M, -1)
    ccbm = obj_cbm[safe].reshape(M, T * OBJ, -1)
    csig = obj_sig[safe].reshape(M, -1)
    cid = obj_id[safe].reshape(M, -1)
    cval = (cid >= 0) & (leaf_ok > 0).repeat_interleave(OBJ, dim=1)
    match = skr_verify_compact_ref(
        q_rects, q_cbm, q_sig, cx, cy, ccbm, csig, cval.to(torch.int8)
    )
    ids = torch.where(match > 0, cid, torch.full_like(cid, -1))
    sig_hit = (csig & q_sig.repeat_interleave(OBJ, dim=1)) != 0
    kw = sig_hit & ((ccbm & q_cbm.repeat_interleave(OBJ, dim=1)) != 0).any(dim=-1)
    kwv = (kw & cval).reshape(M, T, OBJ).sum(dim=2, dtype=torch.int32)
    return ids, kwv


def remap_query_words_ref(q_bm: torch.Tensor, leaf_terms: torch.Tensor, leaves: torch.Tensor):
    """``ops.remap_query_words``: the query bitmaps ``q_bm`` (M, W) remapped
    into the (M, T) selected leaves' vocabularies ``leaf_terms`` (K, 32*Wl),
    leaf ids clamped to ``[0, K-1]``. Returns ``(q_cbm (M, T, Wl), q_sig (M,
    T))``, int32 bit views."""
    M, W = q_bm.shape
    K, L = leaf_terms.shape
    Wl = L // 32
    safe = leaves.clamp(0, K - 1).long()
    T = safe.shape[1]
    terms = leaf_terms[safe]  # (M, T, L) global term per local bit
    tpos = terms.clamp(0, 32 * W - 1)
    widx = (tpos >> 5).reshape(M, T * L).long()
    qw = torch.gather(q_bm, 1, widx).reshape(M, T, L)
    # arithmetic shift of the int32 view, then & 1: bit 31 comes out as 1
    bits = (qw >> (tpos & 31)) & 1
    bits = torch.where(terms >= 0, bits, torch.zeros_like(bits))  # pad bits are inert
    shifts = torch.arange(32, dtype=torch.int64, device=q_bm.device)
    # distinct powers of two per word: the int64 sum is the exact OR, an
    # unsigned word value in [0, 2**32); fold it onto its int32 bit view
    word = (bits.long().reshape(M, T, Wl, 32) << shifts).sum(dim=-1)
    q_cbm = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
    q_sig = q_cbm[..., 0]
    for w in range(1, Wl):
        q_sig = q_sig | q_cbm[..., w]
    return q_cbm, q_sig


def fused_verify_leaf_words_ref(
    q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id,
    words: bool = False,
):
    """``remap_query_words_ref`` of the (M, W) query bitmaps into the
    selected leaves' vocabularies, then ``fused_verify_compact_ref`` on
    them: ``(ids, kwv)``, and with ``words`` the remapped ``(q_cbm,
    q_sig)`` after them."""
    q_cbm, q_sig = remap_query_words_ref(q_bm, leaf_terms, top_leaf)
    ids, kwv = fused_verify_compact_ref(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y,
                                        obj_cbm, obj_sig, obj_id)
    return (ids, kwv, q_cbm, q_sig) if words else (ids, kwv)


def _per_query(ids, kwv):
    """``(ids, n_match, n_kw)``: a verify's ids with its per-query counts of
    matches and of keyword-matching valid slots (the per-slot ``kwv``
    summed)."""
    return ids, (ids >= 0).sum(dim=1, dtype=torch.int32), kwv.sum(dim=1, dtype=torch.int32)


def skr_verify_slots_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32
    top_leaf: torch.Tensor,  # (M, T) int32 selected leaf ids
    leaf_ok: torch.Tensor,  # (M, T) int8
    slot_x: torch.Tensor,  # (K, B) f32 slot bank: a delta's insert buffers
    slot_y: torch.Tensor,  # (K, B) f32
    slot_bm: torch.Tensor,  # (K, B, W) i32
    slot_id: torch.Tensor,  # (K, B) int32, -1 = empty slot
):
    """Gather the selected leaves' slots (leaf ids clamped to ``[0, K-1]``),
    apply ``skr_verify_ref``, and sum per query. Returns ``(ids (M, T*B)
    i32, n_match (M,) i32, n_kw (M,) i32)``: ids of the matching slots
    (``-1`` elsewhere, leaf-slot-major), their count, and the count of
    keyword-matching valid slots, inside the rectangle or not (the Eq. 1
    ``verified`` share of the slots)."""
    return _per_query(*fused_verify_ref(q_rects, q_bm, top_leaf, leaf_ok, slot_x, slot_y,
                                        slot_bm, slot_id))


def skr_verify_slots_compact_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_cbm: torch.Tensor,  # (M, T, Wl) i32 leaf-local remapped query words
    q_sig: torch.Tensor,  # (M, T) i32
    top_leaf: torch.Tensor,  # (M, T) int32 selected leaf ids
    leaf_ok: torch.Tensor,  # (M, T) int8
    slot_x: torch.Tensor,  # (K, B) f32 slot bank: a delta's insert buffers
    slot_y: torch.Tensor,  # (K, B) f32
    slot_cbm: torch.Tensor,  # (K, B, Wl) i32 compact words
    slot_sig: torch.Tensor,  # (K, B) i32 OR-fold signatures
    slot_id: torch.Tensor,  # (K, B) int32, -1 = empty slot
):
    """``skr_verify_slots_ref`` on the compact words: gather, then
    ``skr_verify_compact_ref``, then the two per-query sums."""
    return _per_query(*fused_verify_compact_ref(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, slot_x,
                                                slot_y, slot_cbm, slot_sig, slot_id))


def skr_filter_ref(
    q_rects: torch.Tensor,  # (M, 4) f32
    q_bm: torch.Tensor,  # (M, W) i32 bitmap words
    n_mbrs: torch.Tensor,  # (K, 4) f32 node MBRs
    n_bm: torch.Tensor,  # (K, W) i32 node bitmaps
) -> torch.Tensor:
    """(M, K) int8: query rect intersects node MBR AND bitmaps share a bit
    (the dense A/B scan's relevance matrix), a chunk of queries at a time."""
    M, K, W = q_rects.shape[0], n_mbrs.shape[0], n_bm.shape[1]
    out = torch.empty((M, K), dtype=torch.int8, device=q_rects.device)
    for sl in _row_chunks(M, K * W):
        qr, qb = q_rects[sl], q_bm[sl]
        inter = (
            (qr[:, None, 0] <= n_mbrs[None, :, 2])
            & (n_mbrs[None, :, 0] <= qr[:, None, 2])
            & (qr[:, None, 1] <= n_mbrs[None, :, 3])
            & (n_mbrs[None, :, 1] <= qr[:, None, 3])
        )
        kw = ((qb[:, None, :] & n_bm[None, :, :]) != 0).any(dim=-1)
        out[sl] = (inter & kw).to(torch.int8)
    return out


def _in_sub_rects(o_pts: torch.Tensor, s_rects: torch.Tensor) -> torch.Tensor:
    """(N, S) bool: object point inside the closed subscription rectangle."""
    x = o_pts[:, 0:1]
    y = o_pts[:, 1:2]
    return (
        (x >= s_rects[None, :, 0])
        & (x <= s_rects[None, :, 2])
        & (y >= s_rects[None, :, 1])
        & (y <= s_rects[None, :, 3])
    )


def sub_match_ref(
    o_pts: torch.Tensor,  # (N, 2) f32 arriving object points
    o_bm: torch.Tensor,  # (N, W) i32 full-width object bitmaps
    s_rects: torch.Tensor,  # (S, 4) f32 subscription rects
    s_bm: torch.Tensor,  # (S, W) i32 subscription bitmaps
) -> torch.Tensor:
    """(N, S) int8: object point inside sub rect AND bitmaps share a bit.

    The full-width oracle of the ``sub_match`` kernel. Padding is inert: a
    zero bitmap on either side fails the keyword test, a ``NEVER_RECT``
    subscription contains no point."""
    N, S, W = o_pts.shape[0], s_rects.shape[0], s_bm.shape[1]
    out = torch.empty((N, S), dtype=torch.int8, device=o_pts.device)
    for sl in _row_chunks(N, S * W):
        kw = ((o_bm[sl, None, :] & s_bm[None, :, :]) != 0).any(dim=-1)
        out[sl] = (_in_sub_rects(o_pts[sl], s_rects) & kw).to(torch.int8)
    return out


def sub_match_packed_ref(
    o_pts: torch.Tensor,  # (N, 2) f32
    o_wids: torch.Tensor,  # (N, Wp) i32 packed word ids (ops.pack_query_words)
    o_bits: torch.Tensor,  # (N, Wp) i32 packed word values
    o_sig: torch.Tensor,  # (N,) i32 OR-fold object signatures
    s_rects: torch.Tensor,  # (S, 4) f32
    s_bm: torch.Tensor,  # (S, W) i32
    s_sig: torch.Tensor,  # (S,) i32 OR-fold subscription signatures
) -> torch.Tensor:
    """The ``sub_match`` kernel's own operands: point-in-rect AND the
    signature prefilter AND each object's packed words against the
    subscriptions' words gathered at those word ids. Equal to
    ``sub_match_ref`` on the full-width bitmaps the packing came from."""
    N, S, Wp = o_pts.shape[0], s_rects.shape[0], o_wids.shape[1]
    out = torch.empty((N, S), dtype=torch.int8, device=o_pts.device)
    s_words = s_bm.t()  # (W, S) word-major view
    for sl in _row_chunks(N, S * Wp):
        sig = (o_sig[sl, None] & s_sig[None, :]) != 0
        g = s_words[o_wids[sl].long()]  # (n, Wp, S)
        kw = ((g & o_bits[sl, :, None]) != 0).any(dim=1)
        out[sl] = (_in_sub_rects(o_pts[sl], s_rects) & sig & kw).to(torch.int8)
    return out


def or_fold(bm: torch.Tensor) -> torch.Tensor:
    """(n,) int32 OR of each row's words: the one-word signature (0 for a
    row with no word)."""
    sig = torch.zeros(bm.shape[:1], dtype=torch.int32, device=bm.device)
    for w in range(bm.shape[1]):
        sig |= bm[:, w]
    return sig


def nonzero_words(bm: torch.Tensor):
    """``(wids (n, Wp) i64, bits (n, Wp) i32)``: each row's nonzero words
    first, in word order, then zero words (value 0, inert), with Wp the most
    any row has (at least 1): ``ops.pack_query_words`` on tensors, without
    its power-of-two bucket."""
    nz = bm != 0
    wp = max(int(nz.sum(dim=1).max()), 1) if bm.shape[0] else 1
    wids = torch.argsort((~nz).to(torch.int8), dim=1, stable=True)[:, :wp]
    return wids, torch.gather(bm, 1, wids)


def sub_match_pairs_ref(
    o_pts: torch.Tensor,  # (N, 2) f32
    o_bm: torch.Tensor,  # (N, W) i32 full-width object bitmaps
    s_rects: torch.Tensor,  # (S, 4) f32
    s_bm: torch.Tensor,  # (S, W) i32
    s_sig: torch.Tensor,  # (S,) i32 OR-fold subscription signatures
    capacity: int,
):
    """The ``sub_match_pairs`` kernel's contract: ``(pairs (capacity, 2)
    i32, count (1,) i32)``. ``count`` is the number of matching (object
    index, slot) pairs -- point-in-rect AND the OR-fold signatures share a
    bit AND the bitmaps share a bit -- and the first ``min(count,
    capacity)`` rows of ``pairs`` hold them (here in row-major order; the
    kernel's come in no fixed order), the rest zero."""
    N, S = o_pts.shape[0], s_rects.shape[0]
    o_sig = or_fold(o_bm)
    o_wids, o_bits = nonzero_words(o_bm)  # no other word can hit
    s_words = s_bm.t()  # (W, S) word-major view
    found = [torch.zeros((0, 2), dtype=torch.int64, device=o_pts.device)]
    for sl in _row_chunks(N, S * o_wids.shape[1]):
        kw = ((s_words[o_wids[sl]] & o_bits[sl, :, None]) != 0).any(dim=1)
        sig = (o_sig[sl, None] & s_sig[None, :]) != 0
        oi, sj = torch.nonzero(_in_sub_rects(o_pts[sl], s_rects) & sig & kw, as_tuple=True)
        found.append(torch.stack([oi + sl.start, sj], 1))
    hits = torch.cat(found)
    pairs = torch.zeros((capacity, 2), dtype=torch.int32, device=o_pts.device)
    n = min(hits.shape[0], capacity)
    pairs[:n] = hits[:n].to(torch.int32)
    return pairs, torch.tensor([hits.shape[0]], dtype=torch.int32, device=o_pts.device)


@contextlib.contextmanager
def _full_f32_matmul():
    """Matrix products in full float32 on the card (no TF32) while inside;
    the caller's setting comes back afterwards."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def cdf_mlp_ref(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Evaluate a bank of B CDF MLPs (1 -> H -> H -> H -> 1, ReLU, sigmoid
    head) at N points, a chunk of points at a time, in full float32.

    params: w0 (B,1,H) b0 (B,H) w1 (B,H,H) b1 (B,H) w2 (B,H,H) b2 (B,H)
            w3 (B,H,1) b3 (B,1), all f32
    x: (N,) f32 -> out (N, B) f32 in [0, 1]
    """
    B, _, H = params["w0"].shape
    N = x.shape[0]
    out = torch.empty((N, B), dtype=torch.float32, device=x.device)
    with _full_f32_matmul():
        for sl in _row_chunks(N, B * H):
            h = x[sl, None, None] * params["w0"][None, :, 0, :] + params["b0"][None]
            h = torch.relu(h)
            h = torch.einsum("nbh,bhj->nbj", h, params["w1"]) + params["b1"][None]
            h = torch.relu(h)
            h = torch.einsum("nbh,bhj->nbj", h, params["w2"]) + params["b2"][None]
            h = torch.relu(h)
            o = torch.einsum("nbh,bho->nbo", h, params["w3"]) + params["b3"][None]
            out[sl] = torch.sigmoid(o[..., 0])
    return out
