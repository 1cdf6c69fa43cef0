"""Seeded numpy operands shared by the port's kernel tests; this module holds
no tests of its own. It imports no JAX, so the CUDA tests that use it also
run where JAX is not installed.

Bitmaps are made as the reference's ``uint32`` words, about half of them
zero and many with bit 31 set; ``to_torch`` hands them to the port as their
``int32`` views.
"""
import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.serve.snapshot import encode_leaf_vocab, encode_mbr_planes


def words(rng, *shape):
    return (rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
            * rng.integers(0, 2, shape, dtype=np.uint32))


def rand_rects(rng, n):
    lo = rng.uniform(0, 0.8, (n, 2)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 0.2, (n, 2)).astype(np.float32)
    return np.concatenate([lo, hi], axis=1)


def to_torch(a, device="cpu"):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_numpy(t, like=None):
    """A port tensor as numpy; int32 bitmaps read back as ``like``'s u32."""
    a = t.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


FRONTIER_ARGS = ("q_rects", "q_bits", "f_codes", "f_bm", "f_valid", "dict_x", "dict_y")


def frontier_case(rng, m, f, w):
    """Narrow-descent operands: rank-coded MBR planes gathered at random
    frontier slots + packed query word planes, plus the f32/full-width
    twins ``(q_bm, f_mbrs, f_bm_full)`` for cross-checks."""
    n = max(2 * f, 4)
    lo = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    mbrs = np.concatenate([lo, lo + rng.uniform(0, 0.3, (n, 2)).astype(np.float32)], axis=1)
    codes, dicts_x, dicts_y = encode_mbr_planes([mbrs])
    n_bm = words(rng, n, w)
    qb = words(rng, m, w)
    wids, bits = ops.pack_query_words(qb)
    idx = rng.integers(0, n, (m, f))
    case = dict(
        q_rects=rand_rects(rng, m),
        q_bits=bits,
        f_codes=codes[0][idx],
        f_bm=n_bm[idx[:, :, None], wids[:, None, :]],
        f_valid=rng.integers(0, 2, (m, f)).astype(np.int8),
        dict_x=dicts_x[0],
        dict_y=dicts_y[0],
    )
    return case, (qb, mbrs[idx], n_bm[idx])


KNN_ARGS = ("q_pts",) + FRONTIER_ARGS[1:]


def knn_case(rng, m, f, w):
    """``frontier_case`` plus query points ``q_pts`` for the kNN filters;
    with more than one query, the last query's slots are all invalid."""
    case, wide = frontier_case(rng, m, f, w)
    case["q_pts"] = rng.uniform(0, 1, (m, 2)).astype(np.float32)
    if m > 1:
        case["f_valid"][-1] = 0
    return case, wide


def wide_args(case, wide, q="q_rects"):
    """The f32 full-width operands ``(q, q_bm, f_mbrs, f_bm, f_valid)`` of
    a ``frontier_case``/``knn_case``; ``q`` names the query operand."""
    qb, f_mbrs, f_bm_full = wide
    return (case[q], qb, f_mbrs, f_bm_full, case["f_valid"])


def clustered_bank(rng, k, obj, w, pool_size=24, max_kw=6):
    """A leaf bank whose objects draw terms from a small per-leaf pool, so
    the leaf dictionaries genuinely compress (Wl well below W)."""
    nbits = 32 * w
    ob = np.zeros((k, obj, w), np.uint32)
    for c in range(k):
        pool = rng.choice(nbits, size=min(pool_size, nbits), replace=False)
        for o in range(obj):
            picks = pool[: rng.integers(0, min(max_kw, pool.size) + 1)]
            np.bitwise_or.at(
                ob[c, o], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32)
            )
    return ob


def fused_case(rng, m, t, k, obj, w, max_kw=6):
    """Fused-verify operands: dirty leaf ids (-1 and past K), invalid slots,
    -1 id pads, a clustered bank and its compact encoding. Objects carry up
    to ``max_kw`` terms of their leaf's pool, so ``max_kw`` > 32 gives
    leaf dictionaries past one word (Wl > 1)."""
    ob = clustered_bank(rng, k, obj, w, pool_size=max(24, max_kw + 8), max_kw=max_kw)
    lt, cbm, sig = encode_leaf_vocab(ob)
    assert lt is not None, "clustered pools must never overflow the cap"
    return dict(
        q_rects=rand_rects(rng, m),
        q_bm=words(rng, m, w),
        top_leaf=rng.integers(-1, k + 2, (m, t)).astype(np.int32),
        leaf_ok=rng.integers(0, 2, (m, t)).astype(np.int8),
        obj_x=rng.uniform(0, 1, (k, obj)).astype(np.float32),
        obj_y=rng.uniform(0, 1, (k, obj)).astype(np.float32),
        obj_bm=ob,
        obj_id=np.where(rng.integers(0, 4, (k, obj)) > 0,
                        rng.integers(0, 10 * k * obj, (k, obj)), -1).astype(np.int32),
        leaf_terms=lt,
        obj_cbm=cbm,
        obj_sig=sig,
    )


def fused_args(case, device="cpu"):
    """The port's fused-verify operands on ``device``, with the query words
    remapped by the port's ``remap_query_words``."""
    t = {k: to_torch(v, device) for k, v in case.items()}
    q_cbm, q_sig = ops.remap_query_words(t["q_bm"], t["leaf_terms"], t["top_leaf"])
    return (t["q_rects"], q_cbm, q_sig, t["top_leaf"], t["leaf_ok"], t["obj_x"],
            t["obj_y"], t["obj_cbm"], t["obj_sig"], t["obj_id"])


def fused_wide_args(case, device="cpu"):
    """The port's full-width fused-verify operands on ``device``."""
    return tuple(to_torch(case[k], device) for k in (
        "q_rects", "q_bm", "top_leaf", "leaf_ok", "obj_x", "obj_y", "obj_bm", "obj_id"))


def _points_near(rng, rects, n):
    """(m, n) x and y: half inside each query's rectangle (some exactly on
    its closed edges), half anywhere in the unit square."""
    m = rects.shape[0]
    u = rng.uniform(0, 1, (2, m, n)).astype(np.float32)
    x = np.where(u[0] < 0.5, rects[:, 0:1] + u[0] * 2 * (rects[:, 2:3] - rects[:, 0:1]),
                 rng.uniform(0, 1, (m, n))).astype(np.float32)
    y = np.where(u[1] < 0.5, rects[:, 1:2] + u[1] * 2 * (rects[:, 3:4] - rects[:, 1:2]),
                 rng.uniform(0, 1, (m, n))).astype(np.float32)
    edge = rng.integers(0, 8, (m, n)) == 0
    x = np.where(edge, np.broadcast_to(rects[:, 2:3], (m, n)), x)
    y = np.where(rng.integers(0, 8, (m, n)) == 0, np.broadcast_to(rects[:, 1:2], (m, n)), y)
    return x, y


# ------------------------------------- packed query words (pack_query_words)
def term_bitmaps(rng, n, w, pool, lo, hi):
    """(n, w) u32 bitmaps, each row with ``lo`` to ``hi - 1`` terms drawn
    from ``pool`` (term ids below 32 * w): sparse rows that share terms."""
    bm = np.zeros((n, w), np.uint32)
    for r in range(n):
        picks = rng.choice(pool, size=min(int(rng.integers(lo, hi)), pool.size), replace=False)
        np.bitwise_or.at(bm[r], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32))
    return bm


def packed_words(q_bm, device="cpu"):
    """The (wids, bits) int32 tensors ``pack_query_words`` makes of ``q_bm``."""
    wids, bits = ops.pack_query_words(q_bm)
    return to_torch(wids, device), to_torch(bits, device)


LEVEL_ARGS = ("q_pts", "q_wids", "q_bits", "level_mbrs", "level_bms", "frontier")


def level_case(rng, m, f, n, w, q_terms=None):
    """``knn_level_dist`` operands: one level of ``n`` nodes with sparse
    bitmaps over a shared term pool, an (m, f) frontier of node ids with
    -1 pads and dirty ids past n - 1 (clamped), and query points with the
    queries' words packed. Queries carry random dense words, or up to
    ``q_terms`` pool terms each (MIX-like: Wp below W at wide W). With more
    than one query, the first has no nonzero word and the last a frontier
    of padding only."""
    pool = rng.choice(32 * w, size=min(32 * w, 48), replace=False)
    q_bm = words(rng, m, w) if q_terms is None else term_bitmaps(rng, m, w, pool, 1, q_terms + 1)
    frontier = rng.integers(0, n + 3, (m, f)).astype(np.int32)
    frontier[rng.uniform(0, 1, (m, f)) < 0.3] = -1
    if m > 1:
        q_bm[0] = 0
        frontier[-1] = -1
    wids, bits = ops.pack_query_words(q_bm)
    lo = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    return dict(
        q_pts=rng.uniform(0, 1, (m, 2)).astype(np.float32), q_bm=q_bm, q_wids=wids, q_bits=bits,
        level_mbrs=np.concatenate([lo, lo + rng.uniform(0, 0.3, (n, 2)).astype(np.float32)], 1),
        level_bms=term_bitmaps(rng, n, w, pool, 0, 7), frontier=frontier,
    )


def gathered_level(case):
    """The TPU kernel's operands ``(q_pts, q_bm, f_mbrs, f_bm, f_valid)`` of
    a ``level_case``: the level arrays gathered at the clamped frontier."""
    fr = case["frontier"]
    safe = np.clip(fr, 0, case["level_mbrs"].shape[0] - 1)
    return (case["q_pts"], case["q_bm"], case["level_mbrs"][safe], case["level_bms"][safe],
            (fr >= 0).astype(np.int8))


LEVEL_NARROW_ARGS = ("q_pts", "q_wids", "q_bits", "level_codes", "level_bms", "frontier",
                     "dict_x", "dict_y")


def level_narrow_case(rng, m, f, n, w, q_terms=None, single=False):
    """``knn_level_dist_narrow`` operands: a ``level_case`` with its MBRs
    rank-coded by the snapshot's ``encode_mbr_planes`` (lossless, so
    ``level_mbrs`` stays the f32 twin of the codes). ``single`` gives every
    node one degenerate MBR: dictionaries of one entry each."""
    case = level_case(rng, m, f, n, w, q_terms)
    if single:
        case["level_mbrs"][:] = case["level_mbrs"][0, [0, 1, 0, 1]]
    codes, dicts_x, dicts_y = encode_mbr_planes([case["level_mbrs"]])
    case.update(level_codes=codes[0], dict_x=dicts_x[0], dict_y=dicts_y[0])
    return case


def gathered_level_narrow(case):
    """The TPU kernel's narrow operands ``(q_pts, q_bits, f_codes, f_bm,
    f_valid, dict_x, dict_y)`` of a ``level_narrow_case``: the codes and the
    node words at the packed word ids gathered at the clamped frontier."""
    fr = case["frontier"]
    safe = np.clip(fr, 0, case["level_codes"].shape[0] - 1)
    f_bm = case["level_bms"][safe[:, :, None], case["q_wids"][:, None, :]]
    return (case["q_pts"], case["q_bits"], case["level_codes"][safe], f_bm,
            (fr >= 0).astype(np.int8), case["dict_x"], case["dict_y"])


FRONTIER_LEVEL_ARGS = ("q_rects", "q_bm", "level_mbrs", "level_bms", "frontier")
FRONTIER_LEVEL_NARROW_ARGS = ("q_rects", "q_bm", "level_codes", "level_bms", "frontier",
                              "dict_x", "dict_y")


def frontier_level_case(rng, m, f, n, w, q_terms=None, single=False):
    """``frontier_level(_narrow)`` operands: a ``level_narrow_case`` (dirty
    ids, -1 pads, with more than one query a first query with no nonzero
    word and a last frontier of padding only) with query rectangles. With
    more than two queries the second rectangle is ``NEVER_RECT`` (it meets
    nothing); the third covers every node whose MBR is a point (``single``).
    Past 2,048 words (one round of the kernels' word compaction) the nodes'
    terms lie in the last 100 words, on both sides of the round's edge."""
    case = level_narrow_case(rng, m, f, n, w, q_terms, single)
    if w > 2048:  # past one compaction round: node terms on both sides of its edge
        pool = 32 * (w - 100) + rng.choice(3200, size=48, replace=False)
        case["level_bms"] = term_bitmaps(rng, n, w, pool, 0, 7)
    rects = rand_rects(rng, m)
    rects[:, 2:] += np.float32(0.1)  # wider than rand_rects: more slots meet
    if m > 2:
        rects[1] = ops.NEVER_RECT
        rects[2] = (-1.0, -1.0, 2.0, 2.0)
    case["q_rects"] = rects
    return case


def gathered_frontier_level(case):
    """The TPU kernels' operands of a ``frontier_level_case``, gathered at
    the clamped frontier: the f32 ``(q_rects, q_bm, f_mbrs, f_bm, f_valid)``
    (all W words) and the narrow ``(q_rects, q_bits, f_codes, f_bm, f_valid,
    dict_x, dict_y)`` (the node words at the packed word ids)."""
    fr = case["frontier"]
    safe = np.clip(fr, 0, case["level_mbrs"].shape[0] - 1)
    valid = (fr >= 0).astype(np.int8)
    wide = (case["q_rects"], case["q_bm"], case["level_mbrs"][safe], case["level_bms"][safe],
            valid)
    f_bm = case["level_bms"][safe[:, :, None], case["q_wids"][:, None, :]]
    narrow = (case["q_rects"], case["q_bits"], case["level_codes"][safe], f_bm, valid,
              case["dict_x"], case["dict_y"])
    return wide, narrow


FRONTIER_LEVEL_SWEEP = [  # m, f, n, w, q_terms, single
    (1, 1, 1, 1, None, True),       # N = 1, W = 1, one-entry dictionaries
    (5, 37, 23, 3, None, False),    # nothing a multiple of a warp; W = 3
    (3, 257, 9, 1, None, False),    # W = 1, F one past a block of 256
    (9, 130, 300, 40, None, False),  # dense query words: 32 nonzero of 40
    (33, 257, 64, 256, 5, False),   # MIX-like at the osm width: 5 terms of W = 256
    (6, 40, 17, 4, None, True),     # several nodes on one point: one-entry dictionaries
]


# W past one compaction round, dense query words
FRONTIER_LEVEL_ROUNDS = (6, 300, 40, 2100, None, False)


LEVEL_NARROW_SWEEP = [  # m, f, n, w, q_terms, single
    (1, 1, 1, 1, None, True),       # N = 1, W = Wp = 1, one-entry dictionaries
    (5, 37, 23, 3, None, False),    # nothing a multiple of a warp; Wp = W = 3
    (9, 130, 300, 40, None, False),  # dense query words: Wp = 32 past the 4-word bucket
    (33, 257, 64, 256, 5, False),   # MIX-like at the osm width: Wp = 8 of W = 256
    (4, 64, 50, 8, 2, False),       # two terms a query: Wp = 4 with zero padding words
    (6, 40, 17, 4, None, True),     # several nodes on one point: one-entry dictionaries
]


LEVEL_SWEEP = [  # m, f, n, w, q_terms
    (1, 1, 1, 1, None),       # degenerate: one slot, W = Wp = 1
    (5, 37, 23, 3, None),     # nothing a multiple of a warp; Wp = W = 3
    (9, 130, 300, 40, None),  # dense query words: Wp = 32 past the 4-word bucket
    (33, 257, 64, 256, 5),    # MIX-like at the osm width: Wp = 8 of W = 256
    (4, 64, 50, 8, 2),        # two terms a query: Wp = 4 with zero padding words
]


VERIFY_ARGS = ("q_rects", "q_bm", "cand_x", "cand_y", "cand_bm", "cand_valid")


def verify_case(rng, m, c, w):
    """``skr_verify`` operands: (m, c) gathered candidates near the query
    rectangles, sparse random words, random validity and an all-invalid
    last row."""
    rects = rand_rects(rng, m)
    x, y = _points_near(rng, rects, c)
    valid = rng.integers(0, 2, (m, c)).astype(np.int8)
    if m > 1:
        valid[-1] = 0
    return dict(q_rects=rects, q_bm=words(rng, m, w), cand_x=x, cand_y=y,
                cand_bm=words(rng, m, c, w), cand_valid=valid)


VERIFY_COMPACT_ARGS = ("q_rects", "q_cbm", "q_sig", "cand_x", "cand_y", "cand_cbm", "cand_sig",
                       "cand_valid")


def verify_compact_case(rng, m, t, obj, wl):
    """``skr_verify_compact`` operands: T slots of OBJ leaf-slot-major
    candidates, per-slot query words and their OR-fold signatures."""
    rects = rand_rects(rng, m)
    x, y = _points_near(rng, rects, t * obj)
    q_cbm = words(rng, m, t, wl)
    cand_cbm = words(rng, m, t * obj, wl)
    valid = rng.integers(0, 2, (m, t * obj)).astype(np.int8)
    if m > 1:
        valid[-1] = 0
    return dict(q_rects=rects, q_cbm=q_cbm, q_sig=np.bitwise_or.reduce(q_cbm, axis=-1),
                cand_x=x, cand_y=y, cand_cbm=cand_cbm,
                cand_sig=np.bitwise_or.reduce(cand_cbm, axis=-1), cand_valid=valid)


FRONTIER_SWEEP = [
    (1, 1, 1),     # degenerate single-slot frontier
    (5, 37, 3),    # nothing a multiple of a tile
    (9, 130, 4),   # frontier just past 128 slots
    (33, 257, 8),  # queries and frontier both off-tile
    (8, 128, 15),  # the fs-profile word width
]

FUSED_SWEEP = [  # m, t, k, obj, w, max_kw
    (1, 1, 1, 1, 1, 6),      # fully degenerate
    (5, 3, 9, 16, 3, 6),     # nothing tile-aligned
    (9, 8, 36, 64, 15, 6),   # the fs-profile word width
    (33, 4, 17, 32, 8, 6),   # queries past the 8-query tile
    (7, 3, 5, 24, 4, 70),    # leaf dictionaries of up to 70 terms: Wl = 4
]

REMAP_ARGS = ("q_rects", "q_bm", "leaf_terms", "top_leaf", "leaf_ok", "obj_x", "obj_y",
              "obj_cbm", "obj_sig", "obj_id")

REMAP_SWEEP = [  # m, t, k, obj, w, wl
    (1, 1, 1, 1, 1, 1),      # degenerate: one pair, one word each
    (13, 5, 11, 37, 3, 2),   # the smoke's ragged edge: nothing a multiple of a warp
    (9, 4, 6, 1, 1, 8),      # OBJ = 1, W = 1 under eight dictionary words
    (7, 3, 5, 37, 3, 8),     # Wl = 8: more words than the (M, T) launch's warps
    (6, 6, 4, 16, 2, 1),     # dictionaries of one word over a two-word bitmap
]


def remap_case(rng, m, t, k, obj, w, wl):
    """Operands of the remapping fused verify (``REMAP_ARGS``) with every
    edge of its remap: leaf dictionaries of ``32 * wl`` entries, a quarter
    ``-1`` pads, the rest even term ids below ``32 * w`` or entries past
    it (the remap clamps them to bit ``32 * w - 1``), and with two leaves or
    more an all-``-1`` last dictionary; dirty leaf ids (-2 to past K) and
    random ``leaf_ok`` with, for two queries or more, a last query of
    ``leaf_ok = 0`` only; a first query whose bits are odd term ids below
    ``32 * w - 1``, which no dictionary holds (``q_sig == 0`` in every
    slot), and an all-ones second one that meets the clamped entries;
    random compact object words with their OR-fold signatures, -1 id pads,
    and wide query rectangles with points near them, so many keyword hits
    also match."""
    nbits = 32 * w
    terms = 2 * rng.integers(0, max(nbits // 2, 1), (k, 32 * wl))
    terms = np.where(rng.integers(0, 10, terms.shape) == 0,
                     nbits + rng.integers(0, 64, terms.shape), terms)
    terms = np.where(rng.integers(0, 4, terms.shape) == 0, -1, terms)
    if k > 1:
        terms[-1] = -1
    q_bm = words(rng, m, w)
    if m > 1:
        odd = np.arange(1, nbits - 1, 2)
        picks = odd[rng.integers(0, 2, odd.size) > 0] if odd.size else odd
        q_bm[0] = 0
        np.bitwise_or.at(q_bm[0], picks >> 5, np.uint32(1) << (picks & 31).astype(np.uint32))
    if m > 2:
        q_bm[1] = np.uint32(0xFFFFFFFF)
    leaf_ok = rng.integers(0, 2, (m, t)).astype(np.int8)
    if m > 1:
        leaf_ok[-1] = 0
    lo = rng.uniform(0, 0.5, (m, 2)).astype(np.float32)
    rects = np.concatenate([lo, lo + rng.uniform(0.2, 0.5, (m, 2)).astype(np.float32)], axis=1)
    ox, oy = _points_near(rng, rects[rng.integers(0, m, k)], obj)
    obj_cbm = words(rng, k, obj, wl)
    return dict(
        q_rects=rects, q_bm=q_bm, leaf_terms=terms.astype(np.int32),
        top_leaf=rng.integers(-2, k + 3, (m, t)).astype(np.int32), leaf_ok=leaf_ok,
        obj_x=ox, obj_y=oy, obj_cbm=obj_cbm, obj_sig=np.bitwise_or.reduce(obj_cbm, axis=-1),
        obj_id=np.where(rng.integers(0, 4, (k, obj)) > 0,
                        rng.integers(0, 10 * k * obj, (k, obj)), -1).astype(np.int32),
    )


VERIFY_SWEEP = [  # m, c, w
    (1, 1, 1),       # degenerate
    (5, 37, 3),      # nothing a multiple of a warp or a block
    (13, 185, 1),    # one word: T = 5 slots of OBJ = 37
    (9, 130, 4),     # candidates just past one block's 128
    (33, 257, 40),   # words past one 32-word warp stride
]

VERIFY_COMPACT_SWEEP = [  # m, t, obj, wl
    (1, 1, 1, 1),
    (5, 3, 16, 1),
    (13, 5, 37, 2),  # the ragged edge of the smoke
    (9, 8, 8, 4),    # OBJ = 8: delta insert slots at MIN_SLOTS_PER_LEAF
    (33, 4, 32, 3),
]


SLOT_SWEEP = [  # m, t, k, b, w
    (1, 1, 1, 1, 1),      # degenerate: one slot, one word
    (5, 3, 9, 16, 3),     # nothing a multiple of a warp
    (13, 5, 11, 8, 1),    # W = 1, B = MIN_SLOTS_PER_LEAF
    (9, 8, 36, 16, 40),   # words past one warp stride
    (33, 4, 17, 32, 8),   # T * B past one block pass
]


def slot_bank(rng, m, t, k, b, w, compact, device="cpu"):
    """Slot-entry operands (``ops.verify_slots``, or ``compact``
    ``ops.verify_slots_compact``) on ``device``: a bank of k leaves x b
    slots, about a third of them empty, with points near the query
    rectangles (edges included); dirty leaf ids (-2 to past K), ``leaf_ok =
    0`` slots and an all-zero last row; with three queries or more, a first
    query with no nonzero word and a ``NEVER_RECT`` second one. Compact:
    per-slot query words and OR-fold signatures."""
    rects = rand_rects(rng, m)
    xs, ys = _points_near(rng, rects[rng.integers(0, m, k)], b)
    ids = np.where(rng.integers(0, 3, (k, b)) > 0, rng.integers(0, 10 * k * b, (k, b)), -1)
    top_leaf = rng.integers(-2, k + 3, (m, t)).astype(np.int32)
    leaf_ok = rng.integers(0, 2, (m, t)).astype(np.int8)
    if m > 1:
        leaf_ok[-1] = 0
    q_words = words(rng, m, t, w) if compact else words(rng, m, w)
    if m > 2:
        q_words[0] = 0
        rects[1] = ops.NEVER_RECT
    fold = lambda a: np.bitwise_or.reduce(a, axis=-1)  # noqa: E731
    bank = (xs, ys, words(rng, k, b, w))
    if compact:
        head = (rects, q_words, fold(q_words), top_leaf, leaf_ok)
        bank = bank + (fold(bank[2]),)
    else:
        head = (rects, q_words, top_leaf, leaf_ok)
    return tuple(to_torch(a, device) for a in head + bank + (ids.astype(np.int32),))


# ------------------------------------------------- the dense A/B filter
FILTER_ARGS = ("q_rects", "q_bm", "n_mbrs", "n_bm")


def sparse_words(rng, n, w, k=3):
    """(n, w) u32 rows of at most ``k`` nonzero words at random ids, one of
    four low bits each: a keyword hit needs the same word and bit, so most
    tests of a row against another read all of its nonzero words."""
    out = np.zeros((n, w), np.uint32)
    for i in range(n):
        ids = rng.choice(w, size=min(k, w), replace=False)
        out[i, ids] = np.uint32(1) << rng.integers(0, 4, ids.size).astype(np.uint32)
    return out


def filter_case(rng, m, k, w, sparse=False):
    """``skr_filter`` operands: query rectangles against node MBRs of one
    level, words (half of them zero, or ``sparse_words``), and the
    degenerate rows where the sizes allow: a ``NEVER_RECT`` node, a node
    and a query with all-zero bitmaps, and a zero-area query rectangle on a
    node's corner."""
    make = sparse_words if sparse else words
    n_mbrs = rand_rects(rng, k)
    case = dict(q_rects=rand_rects(rng, m), q_bm=make(rng, m, w), n_mbrs=n_mbrs,
                n_bm=make(rng, k, w))
    if k > 1:
        case["n_mbrs"][0] = ops.NEVER_RECT
        case["n_bm"][-1] = 0
    if m > 1:
        case["q_bm"][-1] = 0
        corner = n_mbrs[k // 2, 2:]
        case["q_rects"][0] = np.concatenate([corner, corner])
        case["q_bm"][0] = case["n_bm"][k // 2]
    return case


FILTER_SWEEP = [  # m, k, w
    (1, 1, 1),       # degenerate
    (5, 37, 3),      # nothing a multiple of a tile
    (13, 130, 4),    # nodes just past 128
    (33, 257, 8),    # queries past the 8-query tile, nodes past a 256 strip
    (9, 300, 256),   # the osm profile's word width
]

FILTER_RAGGED = [  # m, k, w, sparse: the redesigned kernel's edges
    (3, 1, 1, False),       # one node, one word
    (17, 15, 3, False),     # a node run short of 16
    (9, 17, 3, True),       # a node past a 16-node run
    (5, 7833, 3, False),    # one past the leaf level's width: rows not 16-byte aligned
    (7, 33, 1, True),       # W = 1
    (6, 17, 2100, True),    # W past a 256-word compaction round, few words
    (4, 40, 2100, False),   # W past a round, half the words nonzero
]

# the dense scan's five level widths on the smoke's index (osm, n = 1M,
# STR leaf 128, fanout 8): M = 1024 queries of W = 256 words
FILTER_LEVELS = [(1024, k, 256) for k in (4, 19, 131, 991, 7832)]


# ------------------------------------------------- standing subscriptions
def rand_sub_rect(rng):
    c = rng.random(2)
    h = rng.random(2) * 0.35
    return np.concatenate([np.maximum(c - h, 0), np.minimum(c + h, 1)]).astype(np.float32)


def rand_kw(rng, v, lo=0, hi=4):
    """A -1-padded keyword id list of ``lo`` to ``hi - 1`` distinct ids."""
    k = rng.integers(lo, hi)
    kw = np.full(max(hi, 1), -1, np.int64)
    if k:
        kw[:k] = rng.choice(v, size=k, replace=False)
    return kw


def sub_case(rng, n, s, v, obj_hi=4):
    """Subscriptions and arriving objects with adversarial members: an empty
    keyword set, a zero-area rect and the whole unit square among the
    subscriptions; objects without keywords, one on a rectangle's corner and
    one on the zero-area rect. Objects carry up to ``obj_hi - 1`` keywords.
    Returns ``(locs, obj_kw, rects, sub_kw)`` with ``sub_kw`` an (s, 4)
    -1-padded array."""
    rects = np.stack([rand_sub_rect(rng) for _ in range(s)])
    kws = np.stack([rand_kw(rng, v, lo=1) for _ in range(s)])
    if s >= 3:
        kws[0][:] = -1
        pt = rng.random(2).astype(np.float32)
        rects[1] = np.concatenate([pt, pt])
        rects[2] = (0.0, 0.0, 1.0, 1.0)
    locs = rng.random((n, 2)).astype(np.float32)
    okw = np.stack([rand_kw(rng, v, hi=obj_hi) for _ in range(n)])
    locs[0] = rects[0][:2]
    if s >= 2:
        locs[min(1, n - 1)] = rects[1][:2]
    return locs, okw, rects, kws


SUB_SWEEP = [  # seed, n, s, v
    (0, 1, 1, 7),        # a single pair
    (1, 7, 5, 33),       # ragged everywhere
    (2, 40, 13, 64),     # ragged against every block size
    (3, 130, 129, 200),  # past a tile on both axes
    (4, 37, 300, 8192),  # the osm vocabulary: W = 256 words, subscriptions past a block
]

def late_word_case(rng, n, s, w):
    """Objects with all ``w`` words nonzero (one random bit each) and
    subscriptions with one word past the 32nd, half of them an object's bit
    there, a third of them over the whole square: each match is decided by
    a word past the ones the pairs instance stages per object. Returns
    ``(locs, obj_bm, rects, sub_bm)`` with u32 bitmaps."""
    obm = np.uint32(1) << rng.integers(0, 32, (n, w)).astype(np.uint32)
    cols = rng.integers(32, w, s)
    own = obm[rng.integers(0, n, s), cols]
    other = np.uint32(1) << rng.integers(0, 32, s).astype(np.uint32)
    sbm = np.zeros((s, w), np.uint32)
    sbm[np.arange(s), cols] = np.where(rng.random(s) < 0.5, own, other)
    rects = np.stack([rand_sub_rect(rng) for _ in range(s)])
    rects[::3] = (0.0, 0.0, 1.0, 1.0)
    return rng.random((n, 2)).astype(np.float32), obm, rects, sbm


def nan_case(rng, n, s, v):
    """``sub_case`` with NaN coordinates: every 7th object's x (the first
    object's among them) and every 11th's y are NaN, and when ``s > 5``
    subscription 4's left and subscription 5's right edge are NaN. A NaN
    is inside no rectangle, so those objects and subscriptions match
    nothing; with many keywords shared (small ``v``) the rest still match.
    Returns ``(locs, obj_kw, rects, sub_kw)`` as ``sub_case``."""
    locs, okw, rects, kws = sub_case(rng, n, s, v)
    locs[::7, 0] = np.nan
    locs[3::11, 1] = np.nan
    if s > 5:
        rects[4, 0] = np.nan
        rects[5, 2] = np.nan
    return locs, okw, rects, kws


# (seed, n, s, v) of the NaN cases: one tile of objects, and three tiles
SUB_NAN_SWEEP = [(8, 40, 13, 16), (9, 300, 70, 24)]


# the pairs entry's cases: (seed, n, s, v, obj_hi); objects with up to 79
# keywords have more nonzero words than the kernel stages per object (32),
# so the rest of their rows is read where a pair needs it
SUB_PAIRS_SWEEP = [case + (4,) for case in SUB_SWEEP] + [
    (6, 50, 70, 2048, 80),   # W = 64, most objects with 33 or more nonzero words
    (7, 9, 40, 256, 80),     # W = 8: every object's words fit the staged pairs
]


# ----------------------------------------------------------- the CDF bank
CDF_SWEEP = [  # n, b, h
    (1, 1, 16),
    (65, 23, 16),
    (301, 64, 16),
    (256, 130, 8),
    (77, 5, 32),
]


def cdf_params(rng, b, h):
    """A bank of ``b`` random 1->h->h->h->1 MLPs as f64 numpy arrays, at the
    scales of the reference's own kernel test."""
    return {
        "w0": rng.normal(0, 1, (b, 1, h)), "b0": rng.normal(0, 1, (b, h)),
        "w1": rng.normal(0, 0.5, (b, h, h)), "b1": rng.normal(0, 0.5, (b, h)),
        "w2": rng.normal(0, 0.5, (b, h, h)), "b2": rng.normal(0, 0.5, (b, h)),
        "w3": rng.normal(0, 0.5, (b, h, 1)), "b3": rng.normal(0, 0.5, (b, 1)),
    }


# Points for the bank at its edges: NaN, both infinities, both zeros, and
# finite points far enough out that every model's output is saturated or no
# longer depends on x. (At |x| near 1e3 the hidden sums reach ~1e3, where a
# change of summation order moves an unsaturated sigmoid past 2e-6.)
CDF_EDGE_X = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e6, -1e6, 3e7, -3e7], np.float32)


def with_edge_points(rng, x):
    """``x`` with ``CDF_EDGE_X`` written over as many of its points, at
    random places."""
    x = np.array(x, np.float32)
    k = min(x.size, CDF_EDGE_X.size)
    x[rng.choice(x.size, k, replace=False)] = CDF_EDGE_X[:k]
    return x


# ------------------------------------------- non-finite query coordinates
# Written over finite query rows, None keeping a coordinate: a NaN edge, an
# all-NaN rectangle, the whole plane, an infinite edge, a rectangle at +inf,
# a -inf edge; and points with NaN or infinite coordinates.
_NAN, _INF = float("nan"), float("inf")
NONFINITE_RECTS = [(_NAN, None, None, None), (_NAN,) * 4, (-_INF, -_INF, _INF, _INF),
                   (None, None, _INF, None), (_INF,) * 4, (None, -_INF, None, None)]
NONFINITE_POINTS = [(_NAN, None), (_NAN, _NAN), (_INF, None), (-_INF, -_INF), (None, -_INF),
                    (None, _NAN)]


def with_nonfinite(a):
    """A copy of the (M, 4) query rectangles or (M, 2) query points ``a``
    with ``NONFINITE_RECTS`` / ``NONFINITE_POINTS`` written over
    ``min(M, 6)`` rows spread over the batch."""
    a = np.array(a, np.float32)
    patterns = NONFINITE_RECTS if a.shape[-1] == 4 else NONFINITE_POINTS
    m = a.shape[0]
    k = min(m, len(patterns))
    for row, pat in zip((np.arange(k) * m) // k, patterns):
        for c, v in enumerate(pat):
            if v is not None:
                a[row, c] = v
    return a


def cdf_params_he(rng, b, h):
    """A bank of ``b`` random 1->h->h->h->1 MLPs at ``mlp_init``'s He scale
    (weights N(0, 2 / fan_in)) with biases N(0, 0.1^2), as ``chip_smoke.py``
    draws its bank: hidden sums of order 1 at every width. (At H = 32 the
    scales of ``cdf_params`` grow the sums to where float32 in another
    summation order is off by up to 1.8e-6 on the outputs.)"""
    fan_in = dict(w0=1, w1=h, w2=h, w3=h)
    shapes = dict(w0=(b, 1, h), b0=(b, h), w1=(b, h, h), b1=(b, h), w2=(b, h, h), b2=(b, h),
                  w3=(b, h, 1), b3=(b, 1))
    return {k: rng.normal(0, (2.0 / fan_in[k]) ** 0.5 if k in fan_in else 0.1, s)
            for k, s in shapes.items()}
