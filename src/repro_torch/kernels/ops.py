"""Public wrappers around the serving kernels.

A CPU tensor goes to the plain PyTorch version in ``kernels/ref.py``; a
CUDA tensor launches the hand-written kernel from ``csrc/`` or raises --
there is no silent fallback. Before a launch the wrappers check device,
dtype, shape and contiguity, allocate the outputs with ``torch.empty`` and
launch on PyTorch's current stream.

Bitmaps are ``int32`` tensors holding the bits of the reference's
``uint32`` words (convert with ``.view(np.int32)`` / ``.view(np.uint32)``,
never by value). The kernels need no padding: they mask the ragged edges
themselves.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .. import resolve_device
from . import ref
from ._build import KERNELS

# sentinel rectangle that intersects nothing under the closed-rect predicate
# (xlo > xhi): used for query padding in serve.plan
NEVER_RECT = (2.0, 2.0, -2.0, -2.0)

FUSED_VARIANTS = ("auto", "vmem", "prefetch")

# The verify, kNN and match kernels keep per-block state in dynamic shared
# memory, at most _SHARED_INTS ints (32 KiB, inside the 48 KB a block takes
# without opting in): the full-width query-tile verify up to _TILE_QUERIES
# queries' per-slot counts for its _TILE_SLOTS slots, with their leaf rows
# and the queries' packed (word id, value) pairs, 2 * Wp ints a query,
# whatever W is; the compact verify a pair's Wl remapped words (the
# query-tile launch one pair per warp, _COMPACT_TILE_WARPS of them, and its
# _COMPACT_TILE_QUERIES queries' W bitmap words where they fit); the kNN
# level filters one query's packed pairs; sub_match up to _SUB_MATCH_OBJECTS
# objects' packed words (the pairs instance at most _SUB_OBJECT_PAIRS pairs
# an object). The (M, T) full-width verify, the full-width slot verify and
# the dense filter compact a query's nonzero words in rounds, whatever W is.
_TILE_QUERIES = 8
_TILE_SLOTS = 4
_SHARED_INTS = 8192
# queries per block of the compact query-tile verify: a batch of 1024 gives
# 512 blocks, about four per SM of an H100; a knob that never changes a
# result
_COMPACT_TILE_QUERIES = 2
_COMPACT_TILE_WARPS = 8
# the dense filter: _FILTER_STRIP nodes a block (csrc/skr_filter.cu)
_FILTER_STRIP = 512
# the match kernels: objects a block stages (8 ints each, and the staged
# word pairs) and the pairs instance's staged pairs per object
# (csrc/sub_match.cu)
_SUB_MATCH_OBJECTS = 128
_SUB_OBJECT_INTS = 8
_SUB_OBJECT_PAIRS = 32
# matching pairs the stream's match buffer holds before its kernel is
# launched again at the exact count; a knob that never changes a result
SUB_PAIRS_CAPACITY = 1 << 16
# CUDA's limit on a launch grid's second dimension
_MAX_GRID_Y = 65535


def leaf_bank_bytes(n_leaves: int, obj_per_leaf: int, n_words: int) -> int:
    """Bytes of the full-width fused-verify leaf bank: the obj_x/y/id rows
    and the (K, OBJ, W) bitmap slab."""
    return int(n_leaves) * int(obj_per_leaf) * (3 * 4 + int(n_words) * 4)


def compact_leaf_bank_bytes(
    n_leaves: int, obj_per_leaf: int, n_compact_words: int
) -> int:
    """Bytes of the compact fused-verify leaf bank: the obj_x/y/id rows, the
    one-word signature plane, and the (K, OBJ, Wl) leaf-local bitmap slab."""
    return int(n_leaves) * int(obj_per_leaf) * (
        3 * 4 + 4 + int(n_compact_words) * 4
    )


def host_words(bm) -> np.ndarray:
    """Bitmap words on the host as ``uint32`` numpy: an int32 tensor is read
    as the bit view it is, anything else goes through ``np.asarray``."""
    if isinstance(bm, torch.Tensor):
        if bm.dtype != torch.int32:
            raise TypeError(f"bitmap tensors are int32 bit views, got {bm.dtype}")
        return bm.detach().cpu().numpy().view(np.uint32)
    return np.asarray(bm, np.uint32)


def padded_tile_len(n: int, tile: int = 128) -> int:
    """Slots the reference's tiled kernels touch for a length-``n`` operand
    dimension: they block by ``min(tile, n)`` and pad up to a multiple of it.
    The dense path's ``nodes_scanned`` reports these widths, as the
    reference does, although the CUDA kernels take ragged shapes."""
    t = min(tile, max(int(n), 1))
    return -(-int(n) // t) * t


def pack_query_words(q_bm, min_bucket: int = 4):
    """Pack each query bitmap down to its nonzero words (host-side numpy).

    Returns ``(wids, bits)``: word indices (M, Wp) int32 and the word values
    (M, Wp) uint32, with Wp the power-of-two bucket of the batch's max
    nonzero-word count (capped at W). Slots past a query's own count index
    one of its zero words, so their value is 0 and they can never
    contribute a bit -- packing is exact: ``OR_w (bm & q) == OR_p (bits &
    gathered)``. Host-side because Wp sets a shape, and the batch's bitmaps
    are on the host before the descent starts.
    """
    q = np.asarray(q_bm, dtype=np.uint32)
    M, W = q.shape
    nnz = int((q != 0).sum(axis=1).max()) if M else 0
    wp = max(int(nnz), 1)
    b = max(min_bucket, 1)
    while b < wp:
        b *= 2
    wp = min(b, W)
    # stable argsort of the "is zero" flag keeps nonzero words first, in
    # original word order; zero-word slots carry value 0 and are inert
    order = np.argsort(q == 0, axis=1, kind="stable")
    wids = order[:, :wp].astype(np.int32)
    bits = np.take_along_axis(q, wids, axis=1).astype(np.uint32)
    return wids, bits


def remap_query_words(q_bm: torch.Tensor, leaf_terms: torch.Tensor, leaves: torch.Tensor):
    """Remap query bitmaps into the selected leaves' local vocabularies.

    For each (query, slot), gathers the slot's leaf dictionary
    (``leaf_terms[leaf]``: global term id per leaf-local bit, ``-1`` pad),
    pulls each entry's bit out of the query's global bitmap, and re-packs
    them into ``Wl`` words over leaf-local bit positions. A query term
    absent from the leaf's dictionary contributes no local bit: no object in
    that leaf carries it. Dirty leaf ids are clamped like the fused kernels.

    Args are int32 tensors: ``q_bm`` (M, W), ``leaf_terms`` (K, 32*Wl),
    ``leaves`` (M, T). Returns ``(q_cbm (M, T, Wl) i32, q_sig (M, T) i32)``
    with ``q_sig`` the OR-fold of the remapped words. Tensor code on any
    device (``ref.remap_query_words_ref``): the fused verify's remapping
    entry ``fused_verify_leaf_words`` does it inside its kernel, so only
    the unfused verify and kNN's leaf chunks call this.
    """
    return ref.remap_query_words_ref(q_bm, leaf_terms, leaves)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int], device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def filter_frontier(q_rects, q_bm, f_mbrs, f_bm, f_valid):
    """(M, F) int8 frontier-survivor matrix on f32 MBRs and full-width
    bitmap words gathered at each slot (the TPU kernel's operands). CUDA
    tensors run ``frontier_level``'s kernel on the planes taken as one level
    of M*F nodes (``_as_level``) -- exact, and no host sync."""
    if q_rects.device.type == "cpu":
        return ref.frontier_filter_ref(q_rects, q_bm, f_mbrs, f_bm, f_valid)
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = f_valid.shape
    W = q_bm.shape[1]
    _check("f_mbrs", f_mbrs, torch.float32, (M, F, 4), dev)
    _check("f_bm", f_bm, torch.int32, (M, F, W), dev)
    _check("f_valid", f_valid, torch.int8, (M, F), dev)
    frontier, _ = _as_level(f_valid, f_bm)
    return frontier_level(q_rects, q_bm, f_mbrs.reshape(M * F, 4), f_bm.reshape(M * F, W),
                          frontier)


def filter_frontier_narrow(q_rects, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y):
    """(M, F) int8 frontier-survivor matrix on the bandwidth-lean planes
    gathered at each slot (the TPU kernel's operands): int16 MBR rank codes
    dequantized through the level's coordinate dictionaries (exact) and
    packed query word planes from ``pack_query_words``. CUDA tensors run
    ``frontier_level_narrow``'s kernel on the planes taken as one level of
    M*F nodes (``_as_level``), the packed ``q_bits`` as the (M, Wp)
    bitmap."""
    if q_rects.device.type == "cpu":
        return ref.frontier_filter_narrow_ref(q_rects, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y)
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = f_valid.shape
    Wp = q_bits.shape[1]
    _check("f_codes", f_codes, torch.int16, (M, F, 4), dev)
    _check("f_bm", f_bm, torch.int32, (M, F, Wp), dev)
    _check("f_valid", f_valid, torch.int8, (M, F), dev)
    frontier, _ = _as_level(f_valid, f_bm)
    return frontier_level_narrow(q_rects, q_bits, f_codes.reshape(M * F, 4),
                                 f_bm.reshape(M * F, Wp), frontier, dict_x, dict_y)


def frontier_level(q_rects, q_bm, level_mbrs, level_bms, frontier):
    """(M, F) int8 survivors of one level's nodes at the frontier (int32
    node ids, -1 = empty slot; ids clamped to the level): the node's f32
    MBR (N, 4) meets the query's closed rectangle and one of its bitmap
    words (N, W) ANDs non-zero with the query's ``q_bm`` (M, W). The f32
    range descent's filter (``quantized=False``, a snapshot without narrow
    planes, or a delta's widened ``aug_mbrs``/``aug_bms``): no (M, F, W)
    plane is made. CUDA tensors run ``csrc/frontier.cu``, which reads the
    level itself and the node words only at the query's nonzero words."""
    if q_rects.device.type == "cpu":
        return ref.frontier_level_ref(q_rects, q_bm, level_mbrs, level_bms, frontier)
    dev, (M, F, N, W) = _check_frontier_level(q_rects, q_bm, level_bms, frontier)
    _check("level_mbrs", level_mbrs, torch.float32, (N, 4), dev)
    out = torch.empty((M, F), dtype=torch.int8, device=dev)
    KERNELS["frontier_level"](
        q_rects.data_ptr(), q_bm.data_ptr(), level_mbrs.data_ptr(), level_bms.data_ptr(),
        frontier.data_ptr(), out.data_ptr(), M, F, N, W, dev.index, _stream(dev),
    )
    return out


def frontier_level_narrow(q_rects, q_bm, level_codes, level_bms, frontier, dict_x, dict_y):
    """``frontier_level`` on the level's bandwidth-lean planes: its (N, 4)
    int16 MBR rank codes, decoded through its coordinate dictionaries
    ``dict_x``/``dict_y`` (exact; codes clamped to them). Bit-identical to
    ``frontier_level`` on the f32 MBRs the codes came from. The default
    range descent's filter: no (M, F, Wp) word plane or (M, F, 4) code
    plane is made, and the query words need no packing on the host. CUDA
    tensors run ``csrc/frontier.cu``, which reads the level itself."""
    if q_rects.device.type == "cpu":
        return ref.frontier_level_narrow_ref(q_rects, q_bm, level_codes, level_bms, frontier,
                                             dict_x, dict_y)
    dev, (M, F, N, W) = _check_frontier_level(q_rects, q_bm, level_bms, frontier)
    _check("level_codes", level_codes, torch.int16, (N, 4), dev)
    _check_dicts(dict_x, dict_y, dev)
    out = torch.empty((M, F), dtype=torch.int8, device=dev)
    KERNELS["frontier_level_narrow"](
        q_rects.data_ptr(), q_bm.data_ptr(), level_codes.data_ptr(), level_bms.data_ptr(),
        frontier.data_ptr(), dict_x.data_ptr(), dict_y.data_ptr(), out.data_ptr(), M, F, N, W,
        dict_x.shape[0], dict_y.shape[0], dev.index, _stream(dev),
    )
    return out


def _check_frontier_level(q_rects, q_bm, level_bms, frontier):
    """Check the operands both frontier level kernels take; returns the
    device and ``(M, F, N, W)``."""
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = frontier.shape
    N, W = level_bms.shape
    _check("q_rects", q_rects, torch.float32, (M, 4), dev)
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("level_bms", level_bms, torch.int32, (N, W), dev)
    _check("frontier", frontier, torch.int32, (M, F), dev)
    if M * F and (N == 0 or W == 0):
        raise ValueError("empty level")
    if M * -(-F // 256) >= 2 ** 31:
        raise ValueError(f"M={M}, F={F} exceed the frontier filter's grid")
    return dev, (M, F, N, W)


def _check_dicts(dict_x, dict_y, dev) -> None:
    _check("dict_x", dict_x, torch.float32, (dict_x.shape[0],), dev)
    _check("dict_y", dict_y, torch.float32, (dict_y.shape[0],), dev)
    if dict_x.shape[0] == 0 or dict_y.shape[0] == 0:
        raise ValueError("empty coordinate dictionary")


def _as_level(f_valid, f_bm):
    """Gathered (M, F, ...) planes read as one level of M*F nodes: the
    frontier (slot (m, f) is node m*F + f where valid, else -1) and all
    the planes' Wp words, ids ``arange(Wp)`` for every query."""
    M, F = f_valid.shape
    Wp = f_bm.shape[2]
    if M * F >= 2 ** 31:
        raise ValueError(f"M*F={M * F} slots exceed the level kernels' int32 node ids")
    dev = f_valid.device
    slots = torch.arange(M * F, dtype=torch.int32, device=dev).reshape(M, F)
    frontier = torch.where(f_valid > 0, slots, -1)
    wids = torch.arange(Wp, dtype=torch.int32, device=dev).expand(M, Wp).contiguous()
    return frontier, wids


def knn_frontier_dist(q_pts, q_bm, f_mbrs, f_bm, f_valid):
    """(M, F) f32 squared point-to-MBR min-distances on f32 MBRs and
    full-width bitmap words gathered at each slot (the TPU kernel's
    operands), +inf at invalid or keyword-miss slots. CUDA tensors run
    ``knn_level_dist``'s kernel on the planes taken as one level of M*F
    nodes (``_as_level``; the query words are all W words) -- exact, and no
    host sync."""
    if q_pts.device.type == "cpu":
        return ref.knn_filter_ref(q_pts, q_bm, f_mbrs, f_bm, f_valid)
    dev = q_pts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = f_valid.shape
    W = q_bm.shape[1]
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("f_mbrs", f_mbrs, torch.float32, (M, F, 4), dev)
    _check("f_bm", f_bm, torch.int32, (M, F, W), dev)
    _check("f_valid", f_valid, torch.int8, (M, F), dev)
    frontier, wids = _as_level(f_valid, f_bm)
    return knn_level_dist(q_pts, wids, q_bm, f_mbrs.reshape(M * F, 4), f_bm.reshape(M * F, W),
                          frontier)


def knn_level_dist(q_pts, q_wids, q_bits, level_mbrs, level_bms, frontier):
    """(M, F) f32 squared point-to-MBR min-distances of one level's nodes at
    the frontier (int32 node ids, -1 = empty slot; ids clamped to the
    level), +inf at empty or keyword-miss slots, from the level's f32 MBRs
    (N, 4) and full-width bitmaps (N, W), read only at each query's packed
    words ``(q_wids, q_bits)`` from ``pack_query_words``. The f32 kNN
    descent's filter: no (M, F, W) plane is made. CUDA tensors run
    ``csrc/knn_filter.cu``, which gathers for itself."""
    if q_pts.device.type == "cpu":
        return ref.knn_level_dist_ref(q_pts, q_wids, q_bits, level_mbrs, level_bms, frontier)
    dev, (M, F, Wp, N, W) = _check_level(q_pts, q_wids, q_bits, level_bms, frontier)
    _check("level_mbrs", level_mbrs, torch.float32, (N, 4), dev)
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    KERNELS["knn_level_dist"](
        q_pts.data_ptr(), q_wids.data_ptr(), q_bits.data_ptr(), level_mbrs.data_ptr(),
        level_bms.data_ptr(), frontier.data_ptr(), out.data_ptr(), M, F, Wp, N, W,
        dev.index, _stream(dev),
    )
    return out


def knn_level_dist_narrow(q_pts, q_wids, q_bits, level_codes, level_bms, frontier, dict_x,
                          dict_y):
    """``knn_level_dist`` on the level's bandwidth-lean planes: its (N, 4)
    int16 MBR rank codes, decoded through its coordinate dictionaries
    ``dict_x``/``dict_y`` (exact; codes clamped to them), and its (N, W)
    bitmaps read at the packed words. Bit-identical to ``knn_level_dist``
    on the f32 MBRs the codes came from. The narrow kNN descent's filter:
    no (M, F, Wp) word plane or (M, F, 4) code plane is made. CUDA tensors
    run ``csrc/knn_filter.cu``, which gathers for itself."""
    if q_pts.device.type == "cpu":
        return ref.knn_level_dist_narrow_ref(q_pts, q_wids, q_bits, level_codes, level_bms,
                                             frontier, dict_x, dict_y)
    dev, (M, F, Wp, N, W) = _check_level(q_pts, q_wids, q_bits, level_bms, frontier)
    _check("level_codes", level_codes, torch.int16, (N, 4), dev)
    _check_dicts(dict_x, dict_y, dev)
    out = torch.empty((M, F), dtype=torch.float32, device=dev)
    KERNELS["knn_level_dist_narrow"](
        q_pts.data_ptr(), q_wids.data_ptr(), q_bits.data_ptr(), level_codes.data_ptr(),
        level_bms.data_ptr(), frontier.data_ptr(), dict_x.data_ptr(), dict_y.data_ptr(),
        out.data_ptr(), M, F, Wp, N, W, dict_x.shape[0], dict_y.shape[0], dev.index,
        _stream(dev),
    )
    return out


def _check_level(q_pts, q_wids, q_bits, level_bms, frontier):
    """Check the operands both level kernels take; returns the device and
    ``(M, F, Wp, N, W)``."""
    dev = q_pts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = frontier.shape
    Wp = q_wids.shape[1]
    N, W = level_bms.shape
    _check("q_pts", q_pts, torch.float32, (M, 2), dev)
    _check("q_wids", q_wids, torch.int32, (M, Wp), dev)
    _check("q_bits", q_bits, torch.int32, (M, Wp), dev)
    _check("level_bms", level_bms, torch.int32, (N, W), dev)
    _check("frontier", frontier, torch.int32, (M, F), dev)
    if M * F and (N == 0 or W == 0):
        raise ValueError("empty level")
    if 2 * Wp > _SHARED_INTS:
        raise ValueError(f"Wp={Wp} packed words exceed the kNN filter's shared memory")
    if M * -(-F // 256) >= 2 ** 31:
        raise ValueError(f"M={M}, F={F} exceed the kNN filter's grid")
    return dev, (M, F, Wp, N, W)


def knn_frontier_dist_narrow(q_pts, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y):
    """(M, F) f32 squared point-to-MBR min-distances on the bandwidth-lean
    planes gathered at each slot (the TPU kernel's operands); bit-identical
    to ``knn_frontier_dist`` on the dequantized, full-width operands. CUDA
    tensors run ``knn_level_dist_narrow``'s kernel on the planes taken as
    one level of M*F nodes (``_as_level``)."""
    if q_pts.device.type == "cpu":
        return ref.knn_filter_narrow_ref(q_pts, q_bits, f_codes, f_bm, f_valid, dict_x, dict_y)
    dev = q_pts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, F = f_valid.shape
    Wp = q_bits.shape[1]
    _check("q_bits", q_bits, torch.int32, (M, Wp), dev)
    _check("f_codes", f_codes, torch.int16, (M, F, 4), dev)
    _check("f_bm", f_bm, torch.int32, (M, F, Wp), dev)
    _check("f_valid", f_valid, torch.int8, (M, F), dev)
    frontier, wids = _as_level(f_valid, f_bm)
    return knn_level_dist_narrow(q_pts, wids, q_bits, f_codes.reshape(M * F, 4),
                                 f_bm.reshape(M * F, Wp), frontier, dict_x, dict_y)


def fused_gather_verify_compact(
    q_rects, q_cbm, q_sig, top_leaf, leaf_ok,
    obj_x, obj_y, obj_cbm, obj_sig, obj_id, variant: str = "auto",
):
    """Fused leaf gather + verify on the compact leaf bank, on query words
    remapped before the call (the TPU kernels' operands).

    Consumes the descent's selected leaves (``top_leaf``/``leaf_ok``), the
    per-slot remapped query words from ``remap_query_words`` and the
    snapshot's compact bank. Returns ``(ids, kwv)``: ids (M, T*OBJ) i32
    matching object ids (``-1`` fill, leaf-slot-major) and kwv (M, T) i32
    per-slot Eq. 1 ``verified`` counts.

    ``variant`` picks the CUDA kernel (``csrc/fused_verify_compact.cu``,
    the given-words instances): ``"vmem"`` the query-tile kernel,
    ``"prefetch"`` the (M, T) kernel, and ``"auto"`` the (M, T) kernel --
    the TPU's VMEM byte cutoff is no rule on Hopper, and no measured cutoff
    exists yet. Every variant gives identical outputs; on the CPU all of
    them run the plain version. The engine runs ``fused_verify_leaf_words``,
    which remaps inside the kernel.
    """
    _check_variant(variant)
    if q_rects.device.type == "cpu":
        return ref.fused_verify_compact_ref(
            q_rects, q_cbm, q_sig, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id
        )
    dev, (M, T, K, OBJ, Wl) = _check_compact_bank(q_rects, top_leaf, leaf_ok, obj_x, obj_y,
                                                  obj_cbm, obj_sig, obj_id, variant)
    _check("q_cbm", q_cbm, torch.int32, (M, T, Wl), dev)
    _check("q_sig", q_sig, torch.int32, (M, T), dev)
    ids = torch.empty((M, T * OBJ), dtype=torch.int32, device=dev)
    kwv = torch.empty((M, T), dtype=torch.int32, device=dev)
    args = (
        q_rects.data_ptr(), q_cbm.data_ptr(), q_sig.data_ptr(), top_leaf.data_ptr(),
        leaf_ok.data_ptr(), obj_x.data_ptr(), obj_y.data_ptr(), obj_cbm.data_ptr(),
        obj_sig.data_ptr(), obj_id.data_ptr(), ids.data_ptr(), kwv.data_ptr(),
        M, T, K, OBJ, Wl,
    )
    if variant == "vmem":
        KERNELS["fused_verify_compact_tile"](*args, _COMPACT_TILE_QUERIES, dev.index,
                                             _stream(dev))
    else:
        KERNELS["fused_verify_compact_slot"](*args, dev.index, _stream(dev))
    return ids, kwv


def fused_verify_leaf_words(
    q_rects, q_bm, leaf_terms, top_leaf, leaf_ok,
    obj_x, obj_y, obj_cbm, obj_sig, obj_id, variant: str = "auto", words: bool = False,
):
    """``fused_gather_verify_compact`` on the queries' global bitmaps
    ``q_bm`` (M, W) int32: the kernel remaps each query's bits into its
    selected leaves' vocabularies ``leaf_terms`` (K, 32*Wl; the global
    term of each leaf-local bit, ``-1`` pad) itself, so no (M, T, Wl)
    operand is built before the call. Returns ``(ids, kwv)``; with
    ``words=True`` also the remapped words ``(q_cbm (M, T, Wl), q_sig (M,
    T))`` that ``remap_query_words`` gives, written by the same kernel (for
    the insert-slot verify of a delta with compact insert bitmaps).

    ``variant`` as for ``fused_gather_verify_compact``; the launches count
    as ``fused_verify_remap_tile`` (``"vmem"``) and
    ``fused_verify_remap_slot``. On the CPU every variant runs the plain
    version, ``ref.fused_verify_leaf_words_ref``.
    """
    _check_variant(variant)
    if q_rects.device.type == "cpu":
        return ref.fused_verify_leaf_words_ref(q_rects, q_bm, leaf_terms, top_leaf, leaf_ok, obj_x,
                                               obj_y, obj_cbm, obj_sig, obj_id, words=words)
    dev, (M, T, K, OBJ, Wl) = _check_compact_bank(q_rects, top_leaf, leaf_ok, obj_x, obj_y,
                                                  obj_cbm, obj_sig, obj_id, variant)
    W = q_bm.shape[1] if q_bm.dim() == 2 else -1
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("leaf_terms", leaf_terms, torch.int32, (K, 32 * Wl), dev)
    if W == 0 or Wl == 0:
        raise ValueError("the query bitmaps and the leaf dictionaries need at least one word")
    ids = torch.empty((M, T * OBJ), dtype=torch.int32, device=dev)
    kwv = torch.empty((M, T), dtype=torch.int32, device=dev)
    q_cbm = q_sig = None
    if words:
        q_cbm = torch.empty((M, T, Wl), dtype=torch.int32, device=dev)
        q_sig = torch.empty((M, T), dtype=torch.int32, device=dev)
    args = (
        q_rects.data_ptr(), q_bm.data_ptr(), leaf_terms.data_ptr(), top_leaf.data_ptr(),
        leaf_ok.data_ptr(), obj_x.data_ptr(), obj_y.data_ptr(), obj_cbm.data_ptr(),
        obj_sig.data_ptr(), obj_id.data_ptr(), ids.data_ptr(), kwv.data_ptr(),
        q_cbm.data_ptr() if words else 0, q_sig.data_ptr() if words else 0,
        M, T, K, OBJ, Wl, W,
    )
    if variant == "vmem":
        bm = _COMPACT_TILE_QUERIES
        stage = int(_COMPACT_TILE_WARPS * Wl + bm * W <= _SHARED_INTS)
        KERNELS["fused_verify_remap_tile"](*args, bm, stage, dev.index, _stream(dev))
    else:
        KERNELS["fused_verify_remap_slot"](*args, dev.index, _stream(dev))
    return (ids, kwv, q_cbm, q_sig) if words else (ids, kwv)


def _check_variant(variant: str) -> None:
    if variant not in FUSED_VARIANTS:
        raise ValueError(f"unknown fused-verify variant: {variant!r}")


def _check_compact_bank(q_rects, top_leaf, leaf_ok, obj_x, obj_y, obj_cbm, obj_sig, obj_id,
                        variant: str):
    """Check the operands both compact fused-verify entries take; returns
    the device and ``(M, T, K, OBJ, Wl)``."""
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, T = top_leaf.shape
    K, OBJ = obj_x.shape
    Wl = obj_cbm.shape[2] if obj_cbm.dim() == 3 else -1
    _check("q_rects", q_rects, torch.float32, (M, 4), dev)
    _check("top_leaf", top_leaf, torch.int32, (M, T), dev)
    _check("leaf_ok", leaf_ok, torch.int8, (M, T), dev)
    _check("obj_x", obj_x, torch.float32, (K, OBJ), dev)
    _check("obj_y", obj_y, torch.float32, (K, OBJ), dev)
    _check("obj_cbm", obj_cbm, torch.int32, (K, OBJ, Wl), dev)
    _check("obj_sig", obj_sig, torch.int32, (K, OBJ), dev)
    _check("obj_id", obj_id, torch.int32, (K, OBJ), dev)
    if K == 0 or OBJ == 0:
        raise ValueError("empty leaf bank")
    # shared memory: a pair's Wl words (the (M, T) launch), a warp's each
    # (the query-tile launch)
    per_block = _COMPACT_TILE_WARPS * Wl if variant == "vmem" else Wl
    if per_block > _SHARED_INTS:
        raise ValueError(f"Wl={Wl} compact words exceed the fused verify's shared memory")
    if M * T >= 2 ** 31:
        raise ValueError(f"M={M}, T={T} exceed the fused verify's grid")
    return dev, (M, T, K, OBJ, Wl)


def _tile_queries(ints_per_query: int) -> int:
    """Queries per block of a query-tile verify kernel that keeps
    ``ints_per_query`` ints of shared memory per query."""
    bm = max(1, min(_TILE_QUERIES, _SHARED_INTS // max(ints_per_query, 1)))
    if bm * ints_per_query > _SHARED_INTS:
        raise ValueError(
            f"{ints_per_query} shared ints per query exceed the query-tile kernel's shared memory"
        )
    return bm


def fused_gather_verify(
    q_rects, q_bm, top_leaf, leaf_ok, obj_x, obj_y, obj_bm, obj_id, variant: str = "auto",
    q_words=None,
):
    """Fused leaf gather + verify on the full-width leaf bank: the twin of
    ``fused_gather_verify_compact`` that tests the query's global bitmap
    words, with no signature. Serves ``compact=False`` and a snapshot
    without a compact bank. Returns the same ``(ids, kwv)``.

    ``variant`` picks the CUDA kernel (``csrc/fused_verify.cu``): ``"vmem"``
    the query-tile kernel, ``"prefetch"`` and ``"auto"`` the (M, T) kernel,
    as for the compact bank. ``q_words=(wids, bits)``, the batch's
    ``pack_query_words`` as (M, Wp) int32 tensors, lets the tile kernel read
    each row only at the query's nonzero words; without it the tile kernel
    takes ``wids = arange(W)``, ``bits = q_bm`` (exact either way). The
    (M, T) kernel reads ``q_bm`` and compacts each query's nonzero words
    itself. On the CPU every variant runs the plain version (on the packed
    words when they are given).
    """
    _check_variant(variant)
    if q_rects.device.type == "cpu":
        if q_words is not None:
            return ref.fused_verify_packed_ref(q_rects, *q_words, top_leaf, leaf_ok, obj_x,
                                               obj_y, obj_bm, obj_id)
        return ref.fused_verify_ref(q_rects, q_bm, top_leaf, leaf_ok, obj_x, obj_y, obj_bm, obj_id)
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, T = top_leaf.shape
    K, OBJ = obj_x.shape
    W = q_bm.shape[1]
    _check("q_rects", q_rects, torch.float32, (M, 4), dev)
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("top_leaf", top_leaf, torch.int32, (M, T), dev)
    _check("leaf_ok", leaf_ok, torch.int8, (M, T), dev)
    _check("obj_x", obj_x, torch.float32, (K, OBJ), dev)
    _check("obj_y", obj_y, torch.float32, (K, OBJ), dev)
    _check("obj_bm", obj_bm, torch.int32, (K, OBJ, W), dev)
    _check("obj_id", obj_id, torch.int32, (K, OBJ), dev)
    if K == 0 or OBJ == 0:
        raise ValueError("empty leaf bank")
    ids = torch.empty((M, T * OBJ), dtype=torch.int32, device=dev)
    kwv = torch.empty((M, T), dtype=torch.int32, device=dev)
    tail = (top_leaf.data_ptr(), leaf_ok.data_ptr(), obj_x.data_ptr(), obj_y.data_ptr(),
            obj_bm.data_ptr(), obj_id.data_ptr(), ids.data_ptr(), kwv.data_ptr(),
            M, T, K, OBJ, W)
    if variant == "vmem":
        if q_words is None:
            q_words = (torch.arange(W, dtype=torch.int32, device=dev).expand(M, W).contiguous(),
                       q_bm)
        wids, bits = q_words
        Wp = wids.shape[1]
        _check("q_wids", wids, torch.int32, (M, Wp), dev)
        _check("q_bits", bits, torch.int32, (M, Wp), dev)
        bm = _tile_queries(2 * Wp + 2 * _TILE_SLOTS)
        if bm * _TILE_SLOTS * OBJ >= 2 ** 31 or -(-T // _TILE_SLOTS) > _MAX_GRID_Y:
            raise ValueError(f"T={T}, OBJ={OBJ} exceed the query-tile kernel's grid")
        KERNELS["fused_verify_tile"](q_rects.data_ptr(), wids.data_ptr(), bits.data_ptr(), *tail,
                                     Wp, bm, _TILE_SLOTS, dev.index, _stream(dev))
    else:
        KERNELS["fused_verify_slot"](q_rects.data_ptr(), q_bm.data_ptr(), *tail, dev.index,
                                     _stream(dev))
    return ids, kwv


def verify_slots(q_rects, q_bm, top_leaf, leaf_ok, slot_x, slot_y, slot_bm, slot_id):
    """Verify the selected leaves' slots of a slot bank on all W words.

    The bank holds K leaves x B slots -- a live delta's insert buffers
    ``ins_x``/``ins_y``/``ins_bm``/``ins_id`` -- and the (M, T) selected
    leaves ``top_leaf``/``leaf_ok`` (int8) pick each query's rows (ids
    clamped to ``[0, K-1]``). A slot matches where its id is not -1, its
    leaf is ok, one of its words ANDs non-zero with the query's ``q_bm``
    (M, W) and its point lies in the closed rectangle. Returns ``(ids (M,
    T*B) i32, n_match (M,) i32, n_kw (M,) i32)``: the matching ids, ``-1``
    elsewhere, leaf-slot-major; the matches per query; and the
    keyword-matching valid slots per query, inside the rectangle or not
    (the Eq. 1 ``verified`` share). CUDA tensors run ``csrc/skr_verify.cu``,
    which reads the bank itself: no (M, T*B, W) plane is made."""
    return _verify_slots("skr_verify_slots", q_rects, q_bm, top_leaf, leaf_ok, slot_x, slot_y,
                         slot_bm, slot_id)


def verify_slots_compact(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, slot_x, slot_y, slot_cbm,
                         slot_sig, slot_id):
    """``verify_slots`` on the leaf-local compact words: the slot's one-word
    signature against ``q_sig`` (M, T), then its ``Wl`` words (K, B, Wl)
    against ``q_cbm`` (M, T, Wl), the query words ``remap_query_words``
    remapped into each selected leaf's vocabulary. The same outputs."""
    return _verify_slots_compact("skr_verify_slots_compact", q_rects, q_cbm, q_sig, top_leaf,
                                 leaf_ok, slot_x, slot_y, slot_cbm, slot_sig, slot_id)


def _check_slots(q_rects, top_leaf, leaf_ok, slot_x, slot_y, slot_id):
    """Check the operands both slot kernels take; returns the device and
    ``(M, T, K, B)``."""
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, T = top_leaf.shape
    K, B = slot_id.shape
    _check("q_rects", q_rects, torch.float32, (M, 4), dev)
    _check("top_leaf", top_leaf, torch.int32, (M, T), dev)
    _check("leaf_ok", leaf_ok, torch.int8, (M, T), dev)
    _check("slot_x", slot_x, torch.float32, (K, B), dev)
    _check("slot_y", slot_y, torch.float32, (K, B), dev)
    _check("slot_id", slot_id, torch.int32, (K, B), dev)
    if M * T and K == 0:
        raise ValueError("empty slot bank")
    if T * B >= 2 ** 31:
        raise ValueError(f"T={T}, B={B} exceed the slot kernels' candidate index")
    return dev, (M, T, K, B)


def _slot_outputs(dev, M: int, T: int, B: int):
    """Outputs of a slot kernel, ``(ids, n_match, n_kw)``: the counts zero
    where there is no candidate to verify and no launch."""
    ids = torch.empty((M, T * B), dtype=torch.int32, device=dev)
    make = torch.empty if T * B else torch.zeros
    return ids, make((M,), dtype=torch.int32, device=dev), make((M,), dtype=torch.int32, device=dev)


def _verify_slots(kernel: str, q_rects, q_bm, top_leaf, leaf_ok, slot_x, slot_y, slot_bm,
                  slot_id):
    """``verify_slots``, its launches counted under ``kernel``."""
    if q_rects.device.type == "cpu":
        return ref.skr_verify_slots_ref(q_rects, q_bm, top_leaf, leaf_ok, slot_x, slot_y,
                                        slot_bm, slot_id)
    dev, (M, T, K, B) = _check_slots(q_rects, top_leaf, leaf_ok, slot_x, slot_y, slot_id)
    W = q_bm.shape[1]
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("slot_bm", slot_bm, torch.int32, (K, B, W), dev)
    out = _slot_outputs(dev, M, T, B)
    if T * B:
        KERNELS[kernel](
            q_rects.data_ptr(), q_bm.data_ptr(), top_leaf.data_ptr(), leaf_ok.data_ptr(),
            slot_x.data_ptr(), slot_y.data_ptr(), slot_bm.data_ptr(), slot_id.data_ptr(),
            *(t.data_ptr() for t in out), M, T, K, B, W, dev.index, _stream(dev),
        )
    return out


def _verify_slots_compact(kernel: str, q_rects, q_cbm, q_sig, top_leaf, leaf_ok, slot_x, slot_y,
                          slot_cbm, slot_sig, slot_id):
    """``verify_slots_compact``, its launches counted under ``kernel``."""
    if q_rects.device.type == "cpu":
        return ref.skr_verify_slots_compact_ref(q_rects, q_cbm, q_sig, top_leaf, leaf_ok, slot_x,
                                                slot_y, slot_cbm, slot_sig, slot_id)
    dev, (M, T, K, B) = _check_slots(q_rects, top_leaf, leaf_ok, slot_x, slot_y, slot_id)
    Wl = q_cbm.shape[2]
    _check("q_cbm", q_cbm, torch.int32, (M, T, Wl), dev)
    _check("q_sig", q_sig, torch.int32, (M, T), dev)
    _check("slot_cbm", slot_cbm, torch.int32, (K, B, Wl), dev)
    _check("slot_sig", slot_sig, torch.int32, (K, B), dev)
    out = _slot_outputs(dev, M, T, B)
    if T * B:
        KERNELS[kernel](
            q_rects.data_ptr(), q_cbm.data_ptr(), q_sig.data_ptr(), top_leaf.data_ptr(),
            leaf_ok.data_ptr(), slot_x.data_ptr(), slot_y.data_ptr(), slot_cbm.data_ptr(),
            slot_sig.data_ptr(), slot_id.data_ptr(), *(t.data_ptr() for t in out),
            M, T, K, B, Wl, dev.index, _stream(dev),
        )
    return out


def _check_gathered(q_rects, **planes) -> None:
    """On the card, check gathered candidate planes (``name=(tensor, dtype,
    shape)``) under the caller's names before they are read as a slot bank
    (contiguous, so the bank is a view of them)."""
    if q_rects.device.type != "cpu":
        for name, (t, dtype, shape) in planes.items():
            _check(name, t, dtype, shape, q_rects.device)


def identity_leaves(M: int, T: int, device):
    """The leaf map under which gathered (M, T*n) candidate planes read as a
    slot bank of M*T rows of n slots: ``top_leaf[m, t] = m*T + t`` (int32),
    every ``leaf_ok`` 1 (int8)."""
    top_leaf = torch.arange(M * T, dtype=torch.int32, device=device).reshape(M, T)
    return top_leaf, torch.ones((M, T), dtype=torch.int8, device=device)


def verify_candidates_counted(q_rects, q_bm, cand_x, cand_y, cand_bm, cand_id):
    """``verify_slots`` on candidates gathered into (M, C) planes, valid
    where ``cand_id`` is not -1: the planes read as a bank of M rows of C
    slots (``identity_leaves(M, 1)``). Returns ``(ids, n_match, n_kw)``; on
    the card row 10's kernel, its launches counted as ``skr_verify``."""
    M, C = cand_x.shape
    W = q_bm.shape[1]
    _check_gathered(q_rects, cand_x=(cand_x, torch.float32, (M, C)),
                    cand_y=(cand_y, torch.float32, (M, C)),
                    cand_bm=(cand_bm, torch.int32, (M, C, W)),
                    cand_id=(cand_id, torch.int32, (M, C)))
    top_leaf, leaf_ok = identity_leaves(M, 1, q_rects.device)
    return _verify_slots("skr_verify", q_rects, q_bm, top_leaf, leaf_ok, cand_x, cand_y, cand_bm,
                         cand_id)


def verify_candidates_compact_counted(q_rects, q_cbm, q_sig, cand_x, cand_y, cand_cbm, cand_sig,
                                      cand_id):
    """``verify_slots_compact`` on leaf-slot-major candidates gathered into
    (M, T*OBJ) planes, valid where ``cand_id`` is not -1: the planes read as
    a bank of M*T rows of OBJ slots (``identity_leaves(M, T)``). Returns
    ``(ids, n_match, n_kw)``; on the card row 9's kernel, its launches
    counted as ``skr_verify_compact``."""
    M, T = q_sig.shape
    C = cand_x.shape[1]
    if T == 0 or C % T:
        raise ValueError(f"{C} candidates do not split into T={T} leaf slots")
    _check_gathered(q_rects, cand_x=(cand_x, torch.float32, (M, C)),
                    cand_y=(cand_y, torch.float32, (M, C)),
                    cand_cbm=(cand_cbm, torch.int32, (M, C, q_cbm.shape[2])),
                    cand_sig=(cand_sig, torch.int32, (M, C)),
                    cand_id=(cand_id, torch.int32, (M, C)))
    bank = lambda t: t.reshape(M * T, C // T, *t.shape[2:])  # noqa: E731
    top_leaf, leaf_ok = identity_leaves(M, T, q_rects.device)
    return _verify_slots_compact("skr_verify_compact", q_rects, q_cbm, q_sig, top_leaf, leaf_ok,
                                 bank(cand_x), bank(cand_y), bank(cand_cbm), bank(cand_sig),
                                 bank(cand_id))


def _valid_as_ids(cand_valid):
    """An int8 validity plane as the slot kernels' ids: 0 where valid, -1
    elsewhere; a match then comes back as id 0."""
    return (cand_valid > 0).to(torch.int32) - 1


def verify_candidates(q_rects, q_bm, cand_x, cand_y, cand_bm, cand_valid):
    """(M, C) int8 unfused verify of gathered candidates on all W words:
    in the closed rectangle, keyword-matching and valid. CUDA tensors run
    ``verify_candidates_counted`` on the validity plane taken as ids; CPU
    and ``meta`` tensors (a dry run's trace) the plain version."""
    if q_rects.device.type in ("cpu", "meta"):
        return ref.skr_verify_ref(q_rects, q_bm, cand_x, cand_y, cand_bm, cand_valid)
    _check("cand_valid", cand_valid, torch.int8, tuple(cand_x.shape), q_rects.device)
    ids, _, _ = verify_candidates_counted(q_rects, q_bm, cand_x, cand_y, cand_bm,
                                          _valid_as_ids(cand_valid))
    return (ids >= 0).to(torch.int8)


def verify_candidates_compact(q_rects, q_cbm, q_sig, cand_x, cand_y, cand_cbm, cand_sig,
                              cand_valid):
    """(M, T*OBJ) int8 unfused verify on the compact leaf vocabulary.
    Candidates are leaf-slot-major, T slots of OBJ each (OBJ is derived as
    ``C // T``), because the remapped query words ``q_cbm``/``q_sig`` differ
    per slot. CUDA tensors run ``verify_candidates_compact_counted`` on the
    validity plane taken as ids."""
    if q_rects.device.type == "cpu":
        return ref.skr_verify_compact_ref(
            q_rects, q_cbm, q_sig, cand_x, cand_y, cand_cbm, cand_sig, cand_valid
        )
    _check("cand_valid", cand_valid, torch.int8, tuple(cand_x.shape), q_rects.device)
    ids, _, _ = verify_candidates_compact_counted(q_rects, q_cbm, q_sig, cand_x, cand_y, cand_cbm,
                                                  cand_sig, _valid_as_ids(cand_valid))
    return (ids >= 0).to(torch.int8)


def _check_aligned(name: str, t: torch.Tensor) -> None:
    """Kernels that read rows as float4 need them 16-byte aligned."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def filter_pairs(q_rects, q_bm, n_mbrs, n_bm):
    """(M, K) int8 relevance of every query against every node of one level:
    the closed rectangle meets the node's MBR and the bitmaps share a bit
    (the dense A/B scan). CUDA tensors run ``csrc/skr_filter.cu``, which
    reads a node's words only where its MBR meets the rectangle and there
    only at the query's nonzero words, 8 queries a block; it
    writes rows of a pitch rounded up to 16 and returns the (M, K) view.
    CPU and ``meta`` tensors (a dry run's trace) run the plain version."""
    if q_rects.device.type in ("cpu", "meta"):
        return ref.skr_filter_ref(q_rects, q_bm, n_mbrs, n_bm)
    dev = q_rects.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    M, W = q_bm.shape
    K = n_mbrs.shape[0]
    _check("q_rects", q_rects, torch.float32, (M, 4), dev)
    _check("q_bm", q_bm, torch.int32, (M, W), dev)
    _check("n_mbrs", n_mbrs, torch.float32, (K, 4), dev)
    _check("n_bm", n_bm, torch.int32, (K, W), dev)
    _check_aligned("q_rects", q_rects)
    _check_aligned("n_mbrs", n_mbrs)
    if -(-K // _FILTER_STRIP) > _MAX_GRID_Y:
        raise ValueError(f"K={K} nodes exceed the filter kernel's grid")
    Kp = -(-K // 16) * 16
    out = torch.empty((M, Kp), dtype=torch.int8, device=dev)
    KERNELS["skr_filter"](
        q_rects.data_ptr(), q_bm.data_ptr(), n_mbrs.data_ptr(), n_bm.data_ptr(),
        out.data_ptr(), M, K, Kp, W, dev.index, _stream(dev),
    )
    return out[:, :K]


def _sub_objects(N: int, S: int, per_object: int) -> int:
    """Objects a block of a match launch stages: as many as their
    ``per_object`` ints fit in ``_SHARED_INTS``, at most
    ``_SUB_MATCH_OBJECTS``."""
    if per_object > _SHARED_INTS:
        raise ValueError(f"{per_object} shared ints per object exceed the match kernel's "
                         "shared memory")
    objs = min(_SUB_MATCH_OBJECTS, _SHARED_INTS // per_object)
    tiles = -(-N // objs)
    if tiles > _MAX_GRID_Y:
        raise ValueError(f"N={N} objects exceed the match kernel's grid")
    if N * S >= 2 ** 31:
        raise ValueError(f"N={N}, S={S} exceed the match kernels' int32 counts")
    return objs


def _check_block(s_rects, s_bm, s_sig, dev):
    """Check the compiled subscription block's operands; returns ``(S, W)``."""
    S, W = s_bm.shape
    _check("s_rects", s_rects, torch.float32, (S, 4), dev)
    _check("s_bm", s_bm, torch.int32, (S, W), dev)
    _check("s_sig", s_sig, torch.int32, (S,), dev)
    _check_aligned("s_rects", s_rects)
    if W == 0:
        raise ValueError("subscription bitmaps have no words")
    return S, W


def sub_match(o_pts, o_wids, o_bits, o_sig, s_rects, s_bm, s_sig):
    """(N, S) int8 subscription match matrix on the kernel's own operands:
    object points, packed nonzero words (``pack_query_words``) and OR-fold
    signatures against the block's rectangles, words and signatures. CUDA
    tensors run ``csrc/sub_match.cu``'s matrix instance."""
    if o_pts.device.type == "cpu":
        return ref.sub_match_packed_ref(o_pts, o_wids, o_bits, o_sig, s_rects, s_bm, s_sig)
    dev = o_pts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    N, Wp = o_wids.shape
    _check("o_pts", o_pts, torch.float32, (N, 2), dev)
    _check("o_wids", o_wids, torch.int32, (N, Wp), dev)
    _check("o_bits", o_bits, torch.int32, (N, Wp), dev)
    _check("o_sig", o_sig, torch.int32, (N,), dev)
    S, W = _check_block(s_rects, s_bm, s_sig, dev)
    objs = _sub_objects(N, S, _SUB_OBJECT_INTS + 2 * Wp)
    out = torch.empty((N, S), dtype=torch.int8, device=dev)
    KERNELS["sub_match"](
        o_pts.data_ptr(), o_wids.data_ptr(), o_bits.data_ptr(), o_sig.data_ptr(),
        s_rects.data_ptr(), s_bm.data_ptr(), s_sig.data_ptr(), out.data_ptr(),
        N, S, Wp, W, objs, dev.index, _stream(dev),
    )
    return out


def _sub_pairs(o_pts, o_bm, s_rects, s_bm, s_sig, capacity: int):
    """One launch of the pairs instance (the plain version on the CPU):
    ``(pairs (capacity, 2) i32, count (1,) i32)``, the first ``min(count,
    capacity)`` rows the matching pairs in no fixed order."""
    if o_pts.device.type == "cpu":
        return ref.sub_match_pairs_ref(o_pts, o_bm, s_rects, s_bm, s_sig, capacity)
    dev = o_pts.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    S, W = _check_block(s_rects, s_bm, s_sig, dev)
    N = o_pts.shape[0]
    _check("o_pts", o_pts, torch.float32, (N, 2), dev)
    _check("o_bm", o_bm, torch.int32, (N, W), dev)
    objs = _sub_objects(N, S, _SUB_OBJECT_INTS + 2 * min(W, _SUB_OBJECT_PAIRS))
    pairs = torch.empty((capacity, 2), dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    KERNELS["sub_match_pairs"](
        o_pts.data_ptr(), o_bm.data_ptr(), s_rects.data_ptr(), s_bm.data_ptr(),
        s_sig.data_ptr(), pairs.data_ptr(), count.data_ptr(), N, S, W, objs, capacity,
        dev.index, _stream(dev),
    )
    return pairs, count


def match_subscription_pairs(o_pts, o_bm, s_rects, s_bm, s_sig=None, capacity=None):
    """(n, 2) int32 (object index, slot) pairs of arriving objects that
    match the subscription block, in no fixed order, on the block's device:
    the nonzero entries of ``match_subscriptions`` without the (N, S)
    matrix.

    ``o_pts`` (N, 2) f32 and ``o_bm`` (N, W) int32 are the arrivals' points
    and full-width bitmaps on the device: the kernel compacts each object's
    nonzero words and folds its signature itself, so the host packs
    nothing. ``s_rects``/``s_bm``/``s_sig`` as for ``match_subscriptions``.
    The pairs go into a buffer of ``capacity`` rows (default
    ``SUB_PAIRS_CAPACITY``) and one count comes back (the call's one host
    sync); when it passes the capacity, the kernel is launched again at the
    exact count, so ``capacity`` never changes the result. CUDA tensors run ``csrc/sub_match.cu``'s pairs
    instance (launches counted as ``sub_match_pairs``), CPU tensors its
    plain version ``ref.sub_match_pairs_ref``, through the same retry.
    """
    if o_pts.shape[0] == 0 or s_rects.shape[0] == 0:
        return torch.zeros((0, 2), dtype=torch.int32, device=s_rects.device)
    if s_sig is None:
        s_sig = ref.or_fold(s_bm)
    capacity = SUB_PAIRS_CAPACITY if capacity is None else int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity={capacity} is negative")
    pairs, count = _sub_pairs(o_pts, o_bm, s_rects, s_bm, s_sig, capacity)
    n = int(count)
    if n > capacity:
        pairs, _ = _sub_pairs(o_pts, o_bm, s_rects, s_bm, s_sig, n)
    return pairs[:n]


def match_subscriptions(obj_pts, obj_bm, sub_rects, sub_bm, sub_sig=None):
    """(N, S) int8 continuous-filter match matrix on the block's device.

    ``obj_pts`` (N, 2) and ``obj_bm`` (N, W) are the arriving objects on the
    host (the bitmaps as u32 numpy, or an int32 tensor): their bitmaps are
    packed to their nonzero words here with ``pack_query_words``, as the
    reference does, and folded into one-word signatures. ``sub_rects``
    (S, 4) f32, ``sub_bm`` (S, W) int32 and ``sub_sig`` (S,) int32 are the
    compiled subscription block; ``sub_sig`` is folded from ``sub_bm`` when
    not given. Padding is inert: an object with no keyword has a zero
    signature, an empty slot carries ``NEVER_RECT`` and a zero bitmap. The
    subscription stream runs ``match_subscription_pairs`` instead.
    """
    dev = sub_rects.device
    pts = np.asarray(obj_pts, np.float32).reshape(-1, 2)
    words = host_words(obj_bm).reshape(pts.shape[0], -1)
    N, S = pts.shape[0], sub_rects.shape[0]
    if N == 0 or S == 0:
        return torch.zeros((N, S), dtype=torch.int8, device=dev)
    wids, bits = pack_query_words(words)
    o_sig = np.bitwise_or.reduce(words, axis=1)
    if sub_sig is None:
        sub_sig = ref.or_fold(sub_bm)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return sub_match(up(pts), up(wids), up(bits.view(np.int32)), up(o_sig.view(np.int32)),
                     sub_rects, sub_bm, sub_sig)


CDF_PARAMS = ("w0", "b0", "w1", "b1", "w2", "b2", "w3", "b3")
# hidden widths the CUDA kernel is instantiated for, and points per block
CDF_HIDDEN_WIDTHS = (4, 8, 16, 32)
_CDF_POINTS_PER_BLOCK = 2048


def cdf_params_from_reference(params: Mapping[str, object], device=None) -> Dict[str, torch.Tensor]:
    """The port's CDF bank from the JAX package's ``CDFBank.nn_params``: a
    mapping of ``w0`` (B,1,H) ... ``b3`` (B,1) arrays (numpy, or anything
    ``np.asarray`` takes) to contiguous f32 tensors on ``device`` (``cuda``
    unless the caller passes another). The bank must have three hidden
    layers, as ``build_cdf_bank(..., n_hidden_layers=3)`` makes it: the
    default two-layer bank has no ``w3`` and is not this function's input.
    """
    missing = [k for k in CDF_PARAMS if k not in params]
    if missing or len(params) != len(CDF_PARAMS):
        raise ValueError(
            f"a CDF bank of 1->H->H->H->1 MLPs needs exactly {CDF_PARAMS}, got "
            f"{sorted(params)} (build_cdf_bank(..., n_hidden_layers=3))"
        )
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(np.asarray(params[k], np.float32))).to(dev)
            for k in CDF_PARAMS}


def cdf_bank_forward(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(N, B) f32 CDF values of the whole MLP bank at the points ``x`` (N,).
    CUDA tensors run ``csrc/cdf_mlp.cu`` (hidden widths ``CDF_HIDDEN_WIDTHS``)."""
    if x.device.type == "cpu":
        return ref.cdf_mlp_ref(params, x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    B, _, H = params["w0"].shape
    N = x.shape[0]
    _check("x", x, torch.float32, (N,), dev)
    for name, shape in (("w0", (B, 1, H)), ("b0", (B, H)), ("w1", (B, H, H)), ("b1", (B, H)),
                        ("w2", (B, H, H)), ("b2", (B, H)), ("w3", (B, H, 1)), ("b3", (B, 1))):
        _check(name, params[name], torch.float32, shape, dev)
    if H not in CDF_HIDDEN_WIDTHS:
        raise ValueError(f"hidden width H={H} is not one of the kernel's {CDF_HIDDEN_WIDTHS}")
    if -(-N // _CDF_POINTS_PER_BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"N={N} points exceed the CDF kernel's grid")
    out = torch.empty((N, B), dtype=torch.float32, device=dev)
    KERNELS["cdf_mlp_bank"](
        x.data_ptr(), *(params[k].data_ptr() for k in CDF_PARAMS), out.data_ptr(),
        N, B, H, dev.index, _stream(dev),
    )
    return out
