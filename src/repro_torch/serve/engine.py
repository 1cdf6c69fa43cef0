"""Executor layer: batched SKR and Boolean kNN retrieval over an ``IndexSnapshot``.

The port of the JAX package's ``serve/engine.py`` frontier paths. SKR
(``retrieve``):

1. ``pack_query_words`` packs each query bitmap to its nonzero words on the
   host (the batch's bitmaps are there before the descent starts), only
   for the full-width fused verify's query-tile launch.
2. ``_descend_frontier``: each query carries a padded int32 frontier of
   candidate node ids. Per level, ``_filter_level`` runs the
   ``frontier_level_narrow`` CUDA kernel on the level's int16 MBR rank
   codes, coordinate dictionaries and bitmaps -- or, for
   ``quantized=False``, a snapshot without narrow planes (a coordinate
   dictionary overflowed int16) or a live delta, ``frontier_level`` on its
   f32 MBRs (the f32 descent; identical survivors). Both read the level at
   the frontier themselves, the node words only at the query's nonzero
   words, which the kernel compacts from the (M, W) bitmap: no per-slot
   plane is made. Survivors' children are expanded through the CSR child
   table into the next frontier, compacted with a prefix sum and a
   scatter. Widths come from the caller's ``PlanCache``.
3. ``_select_leaves_frontier`` keeps up to ``max_leaves`` surviving leaves
   per query, lowest leaf id first (the spill is counted in ``overflow``).
4. ``_verify_leaves`` verifies the selected leaves. By default
   (``fused=None``) one fused gather+verify kernel runs on the compact leaf
   bank (``ops.fused_verify_leaf_words``: the kernel remaps the query's
   bitmap into each selected leaf's vocabulary itself), or on the
   full-width bank for ``compact=False`` or a snapshot without a compact
   bank (its query-tile launch reading each row only at the query's packed
   words). ``fused=False`` gathers the candidates first, remaps the query
   words with ``remap_query_words`` and runs the unfused
   ``skr_verify_compact`` / ``skr_verify`` kernels on them (the A/B
   baseline). Each verify kernel returns the per-query counts.

Boolean kNN (``retrieve_knn``) is a distance-bounded frontier descent:
a beam-1 probe descends greedily to one leaf and seeds a padded top-kb
buffer of (dist^2, object id) pairs; the bounded sweep runs the same
frontier machinery with the ``knn_level_dist_narrow`` kernel (or, on the
f32 descent, ``knn_level_dist``), which reads the level's MBR codes (or
MBRs) and its node words at the query's packed words itself, and prunes
slots whose squared MBR min-distance exceeds the current k-th best; the
surviving leaves are verified in ascending (distance, leaf id) chunks of
four, re-tightening the bound after each chunk. The reference runs that
chunk loop as one ``lax.scan``; here it is a Python loop of tensor
operations.

Live updates: both paths take an optional ``delta`` (serve/delta.py
``DeltaBuffer``). The descents then filter against its insert-widened
level arrays (always the f32 descent: the widened MBRs are not in the
snapshot's coordinate dictionaries), deleted snapshot objects are masked
out of verification and the kNN top-k, and each selected leaf's
insert-buffer slots are verified beside its object block, by a kernel
that reads the delta's buffers itself (``ops.verify_slots_compact`` /
``ops.verify_slots``): on the compact words while the delta carries them
(the fused verify writes the remapped query words out for it), else on all
W words. SKR ids are
(M, T*OBJ + T*B) with a delta: the base blocks first, then the insert
slots, leaf-slot-major.

``mode="dense"`` is the dense A/B scan: every level is scored whole
against every query by the ``skr_filter`` kernel (``ops.filter_pairs``),
the hits are masked by the parents' hits pushed down through the
snapshot's dense child matrices (``IndexSnapshot.build(..., dense=True)``),
and up to ``max_leaves`` hit leaves per query, smallest leaf id first, go
to the same verify stage; a live delta swaps in its widened level arrays.

Every output key and dtype equals the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.query import round_up_bucket  # noqa: F401  (re-export, as in the reference)
from ..core.types import Workload
from ..kernels import ops
from .delta import DeltaBuffer
from .plan import ExecutionPlan, PlanCache, default_plan_cache
from .snapshot import IndexSnapshot, to_device


def _check_knobs(snap: IndexSnapshot, mode, delta) -> None:
    if mode not in ("frontier", "dense"):
        raise ValueError(f"unknown retrieve mode {mode!r}")
    _check_delta(snap, delta)


def _check_delta(snap: IndexSnapshot, delta) -> None:
    """A live delta must be a ``DeltaBuffer`` over this snapshot, on its device."""
    if delta is None:
        return
    if not isinstance(delta, DeltaBuffer):
        raise TypeError(f"delta must be a DeltaBuffer or None, got {type(delta).__name__}")
    if delta.device != snap.device:
        raise ValueError(f"the delta is on {delta.device}, the snapshot on {snap.device}")
    if delta.n_levels != snap.n_levels or delta.ins_id.shape[0] != snap.n_leaves:
        raise ValueError("the delta was not made over this snapshot")


def _level_arrays(snap: IndexSnapshot, delta: Optional[DeltaBuffer], li: int):
    """The (mbrs, bitmaps) a descent filters level ``li`` against: the
    delta's insert-widened arrays when a delta is live, else the frozen
    snapshot arrays."""
    if delta is not None:
        return delta.aug_mbrs[li], delta.aug_bms[li]
    return snap.level_mbrs[li], snap.level_bms[li]


# ------------------------------------------------------------ frontier steps
def _clamped(snap: IndexSnapshot, li: int, frontier):
    """The frontier's node ids clamped into level ``li`` (int64, for
    gathers) and the mask of its real (non -1) slots."""
    return frontier.clamp(0, snap.level_mbrs[li].shape[0] - 1).long(), frontier >= 0


def _filter_level(snap: IndexSnapshot, li: int, q_rects, q_bm, narrow: bool, frontier, delta):
    """Run the frontier filter on level ``li``: ``frontier_level_narrow`` on
    the level's narrow planes, or on the f32 descent ``frontier_level`` on
    its f32 MBRs (the delta's widened arrays when one is live). Both read
    the level at the frontier themselves, so no per-slot plane is made
    (identical survivors). Returns the (M, F) survivors, the per-query count
    of real slots, and the clamped frontier."""
    safe, valid = _clamped(snap, li, frontier)
    if narrow:
        surv = ops.frontier_level_narrow(
            q_rects, q_bm, snap.level_mbr_codes[li], snap.level_bms[li], frontier,
            snap.level_dict_x[li], snap.level_dict_y[li],
        )
    else:
        mbrs, bms = _level_arrays(snap, delta, li)
        surv = ops.frontier_level(q_rects, q_bm, mbrs, bms, frontier)
    return surv, valid.sum(dim=1, dtype=torch.int32), safe


def _expand_frontier(child_table, safe, surv, f_next: int):
    """CSR gather of survivors' children + prefix-sum compaction.

    The hierarchy is a tree, so gathered child rows are disjoint and the
    compacted frontier has no duplicates. ``f_next`` must be >= the max
    per-query child count (the caller's planning guarantees it, or the
    overflow check retries). Children past ``f_next`` all land in the extra
    trash column ``f_next`` (their writes collide there), which is sliced off.
    """
    M = safe.shape[0]
    cand = torch.where((surv > 0)[:, :, None], child_table[safe], -1).reshape(M, -1)
    validc = cand >= 0
    pos = validc.cumsum(dim=1) - 1
    pos = torch.where(validc & (pos < f_next), pos, f_next)
    nxt = torch.full((M, f_next + 1), -1, dtype=torch.int32, device=cand.device)
    nxt.scatter_(1, pos, cand)
    return nxt[:, :f_next].contiguous()


def _select_leaves_frontier(frontier, surv, take: int, n_leaf: int):
    """Up to ``take`` surviving leaves per query, smallest leaf id first.

    Keys ``n_leaf - leaf_id`` are distinct and positive for survivors, so
    the sorted top-k fixes the slot order; non-survivors key 0 and come out
    as ``top_leaf=0`` with ``leaf_ok=False``.
    """
    key = torch.where(surv > 0, n_leaf - frontier, 0)
    val = torch.topk(key, take, dim=1, sorted=True).values
    leaf_ok = val > 0
    top_leaf = torch.where(leaf_ok, n_leaf - val, 0).to(torch.int32)
    overflow = ((surv > 0).sum(dim=1, dtype=torch.int32) - take).clamp_min(0)
    return top_leaf, leaf_ok, overflow


# ------------------------------------ index-parallel collectives (multi-rank)
def _gather_cat(x, axis):
    """All-gather over the mesh's ``index`` axis, shards concatenated along
    dimension 1: the (M, F) per-shard view becomes the (M, S*F) global
    view."""
    g = axis.all_gather(x)  # (S, M, F)
    return g.permute(1, 0, 2).reshape(x.shape[0], -1)


def _select_leaves_indexed(frontier, surv, leaf_gid, take_g: int, take_loc: int, axis):
    """Index-parallel twin of ``_select_leaves_frontier``: keep the globally
    ``take_g`` smallest-GLOBAL-id surviving leaves, exactly the
    single-device selection (and therefore its ``overflow`` drops).

    One bound exchange: each shard gathers its ``take_loc`` smallest
    surviving global leaf ids, the all-gathered (S*take_loc) candidates are
    sorted, and the ``take_g``-th smallest becomes the keep threshold. A
    shard can hold at most ``take_loc`` (at least its survivor count: the
    caller passes its leaf frontier width) of the global winners, so the
    threshold is exact. ``overflow`` is the summed global survivor count
    beyond ``take_g``, per query the single-device counter.
    """
    K = leaf_gid.shape[0]
    ok = (surv > 0) & (frontier >= 0)
    gid = torch.where(ok, leaf_gid[frontier.clamp(0, K - 1).long()], _ID_SENTINEL)
    small = torch.sort(gid, dim=1).values[:, :take_loc]  # ascending, sentinel-padded
    g = torch.sort(_gather_cat(small, axis), dim=1).values
    thr = g[:, min(take_g, axis.size * take_loc) - 1]
    keep = (ok & (gid <= thr[:, None])).to(torch.int8)
    top_leaf, leaf_ok, _ = _select_leaves_frontier(frontier, keep, take_loc, K)
    total = axis.psum(ok.sum(dim=1, dtype=torch.int32))
    overflow = (total - take_g).clamp_min(0)
    return top_leaf, leaf_ok, overflow


def _root_frontier(snap: IndexSnapshot, M: int) -> torch.Tensor:
    n_root = int(snap.level_mbrs[0].shape[0])
    root = torch.full((snap.root_width(),), -1, dtype=torch.int32, device=snap.device)
    root[:n_root] = torch.arange(n_root, dtype=torch.int32, device=snap.device)
    return root[None, :].expand(M, -1).contiguous()


def _local_root_frontier(width: int, n_root_local: int, M: int, device) -> torch.Tensor:
    """Shard-local root frontier for the index-parallel descent: the first
    ``n_root_local`` (this shard's real root count; shards own different
    numbers of root subtrees) slots hold local root ids, the rest ``-1``
    pads. Masking by the real local count keeps the summed
    ``nodes_checked`` equal to the single-device root scan."""
    slot = torch.arange(width, dtype=torch.int32, device=device)
    root = torch.where(slot < n_root_local, slot, -1)
    return root[None, :].expand(M, -1).contiguous()


def _descend_frontier(snap: IndexSnapshot, q_rects, q_bm, narrow: bool, plan: ExecutionPlan,
                      delta, root=None):
    """The range-query frontier descent (on the narrow planes, or the f32
    descent for ``narrow=False``; ``delta`` swaps in the widened level
    arrays).

    ``plan.widths=None``: exact mode -- bucket each next frontier on the
    batch's actual occupancy, one host sync per level. ``plan.widths=(...)``:
    cached mode -- no per-level syncs; the per-level child-count maxima stay
    on the device for the caller's single batched overflow check. ``root``
    overrides the level-0 frontier: the index-parallel regime starts each
    shard from its masked local root frontier (``_local_root_frontier``).
    """
    M = q_rects.shape[0]
    frontier = root if root is not None else _root_frontier(snap, M)
    nodes_checked = torch.zeros((M,), dtype=torch.int32, device=snap.device)
    used = []
    needs = []
    surv = None
    for li in range(snap.n_levels):
        used.append(int(frontier.shape[1]))
        surv, n_valid, safe = _filter_level(snap, li, q_rects, q_bm, narrow, frontier, delta)
        nodes_checked = nodes_checked + n_valid
        if li < snap.n_levels - 1:
            need = torch.where(surv > 0, snap.child_counts[li][safe], 0).sum(dim=1)
            f_next = plan.pick_width(need, li, needs)
            frontier = _expand_frontier(snap.child_table[li], safe, surv, f_next)
    return frontier, surv, nodes_checked, used, needs


def _snap_cbank(snap: IndexSnapshot, compact: Optional[bool]):
    """The snapshot's compact leaf bank as a ``(leaf_terms, obj_cbm,
    obj_sig)`` triple, or None. ``compact=None`` (auto) uses it whenever the
    snapshot carries one; ``False`` forces the full-width leaf bank."""
    if compact is False or not snap.has_compact_bank:
        return None
    return (snap.leaf_terms, snap.leaf_obj_cbm, snap.leaf_obj_sig)


def _count(mask) -> torch.Tensor:
    """(M,) int32 row sums of a boolean or int8 (M, C) mask."""
    return mask.to(torch.int32).sum(dim=1, dtype=torch.int32)


def _verify_delta_slots(q_rects, q_bm, top_leaf, ok8, delta: DeltaBuffer, q_cbm, q_sig):
    """Verify the selected leaves' insert-buffer slots in one kernel call
    that reads the delta's buffers itself: ``verify_slots_compact`` when the
    compact bank is in play (``q_cbm``) and the delta carries remapped
    insert bitmaps (exact: ``DeltaLog`` drops them at the first
    out-of-dictionary term), else the full-width ``verify_slots``. No
    (M, T*B, ...) plane is gathered. Returns ``(ids (M, T*B), counts,
    kw_scanned)`` for the insert slots alone."""
    if q_cbm is not None and delta.ins_cbm is not None:
        return ops.verify_slots_compact(q_rects, q_cbm, q_sig, top_leaf, ok8, delta.ins_x,
                                        delta.ins_y, delta.ins_cbm, delta.ins_sig, delta.ins_id)
    return ops.verify_slots(q_rects, q_bm, top_leaf, ok8, delta.ins_x, delta.ins_y, delta.ins_bm,
                            delta.ins_id)


def _verify_leaves(
    snap: IndexSnapshot, q_rects, q_bm, words, top_leaf, leaf_ok, delta, fused, variant: str,
    compact,
):
    """Verify the selected leaves; returns ``(ids, counts, verified)``.

    ``fused`` (None or True): one fused gather+verify kernel on the base
    leaf blocks -- the compact bank when ``compact`` allows and the
    snapshot has one (``fused_verify_leaf_words``, which remaps the query
    words inside the kernel and writes them out only for a delta with
    compact insert bitmaps), else the full-width bank -- on an id bank
    masked by ``base_alive`` when a delta is live. ``fused=False``: the
    unfused A/B baseline -- the base blocks are gathered into candidate
    planes first (invalid and deleted objects as id -1) and verified by
    ``verify_candidates_compact_counted`` on the words
    ``remap_query_words`` gives or, at full width,
    ``verify_candidates_counted``. Either way a live delta's insert slots
    then go through ``_verify_delta_slots``. Every kernel returns its
    per-query counts, so nothing is recounted here. Candidate order is
    [base blocks T*OBJ, insert slots T*B], leaf-slot-major, in every
    combination, and every combination gives identical outputs. ``words``
    are the batch's packed query words, which the full-width fused verify's
    query-tile launch reads rows at (None where it does not run:
    ``_tile_reads_words``).
    """
    cbank = _snap_cbank(snap, compact)
    q_cbm = q_sig = None  # the remapped query words, where the insert slots need them
    M = q_rects.shape[0]
    ok8 = leaf_ok.to(torch.int8)
    if fused is not False:
        base_id = snap.leaf_obj_id
        if delta is not None:  # deleted objects become pad slots
            base_id = base_id.masked_fill(delta.base_alive == 0, -1)
        if cbank is not None:
            ids, kwv, *q_words = ops.fused_verify_leaf_words(
                q_rects, q_bm, cbank[0], top_leaf, ok8,
                snap.leaf_obj_x, snap.leaf_obj_y, cbank[1], cbank[2], base_id, variant=variant,
                words=delta is not None and delta.ins_cbm is not None,
            )
            if q_words:
                q_cbm, q_sig = q_words
        else:
            ids, kwv = ops.fused_gather_verify(
                q_rects, q_bm, top_leaf, ok8,
                snap.leaf_obj_x, snap.leaf_obj_y, snap.leaf_obj_bm, base_id, variant=variant,
                q_words=words,
            )
        counts = _count(ids >= 0)
        verified = kwv.sum(dim=1, dtype=torch.int32)
    else:
        tl = top_leaf.long()
        keep = ok8.repeat_interleave(snap.obj_per_leaf, dim=1) > 0
        if delta is not None:
            keep = keep & (delta.base_alive[tl].reshape(M, -1) > 0)
        cid = torch.where(keep, snap.leaf_obj_id[tl].reshape(M, -1), -1)
        cx = snap.leaf_obj_x[tl].reshape(M, -1)
        cy = snap.leaf_obj_y[tl].reshape(M, -1)
        if cbank is None:
            cbm = snap.leaf_obj_bm[tl].reshape(M, -1, q_bm.shape[1])
            ids, counts, verified = ops.verify_candidates_counted(q_rects, q_bm, cx, cy, cbm, cid)
        else:
            q_cbm, q_sig = ops.remap_query_words(q_bm, cbank[0], top_leaf)
            ccbm = cbank[1][tl].reshape(M, -1, cbank[1].shape[2])
            csig = cbank[2][tl].reshape(M, -1)
            ids, counts, verified = ops.verify_candidates_compact_counted(
                q_rects, q_cbm, q_sig, cx, cy, ccbm, csig, cid
            )
    if delta is not None:
        d_ids, d_counts, d_kw = _verify_delta_slots(q_rects, q_bm, top_leaf, ok8, delta, q_cbm,
                                                    q_sig)
        ids = torch.cat([ids, d_ids], dim=1)
        counts = counts + d_counts
        verified = verified + d_kw
    return ids, counts, verified


def _query_tensors(snap: IndexSnapshot, q, q_bm, pack: bool):
    """The batch on the snapshot's device: ``q`` (rects or points) as f32,
    the bitmap as its int32 view, and with ``pack`` its packed words
    ``(wids, bits)`` as (M, Wp) int32 (else None). Packing runs on the host,
    where the bitmaps are before the descent starts, because Wp sets a
    shape; it costs host time, so only a batch whose kernels read the packed
    words packs them."""
    dev = snap.device
    words = ops.host_words(q_bm)
    if not isinstance(q, torch.Tensor):
        q = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    q = q.to(dev, torch.float32).contiguous()
    packed = None
    if pack:
        wids, bits = ops.pack_query_words(words)
        packed = (to_device(wids, dev), to_device(bits, dev))
    return q, to_device(words, dev), packed


def _narrow_descent(snap: IndexSnapshot, quantized: Optional[bool], delta) -> bool:
    """Whether the descent runs on the narrow planes: unless the caller
    forces the f32 one, the snapshot has no narrow planes, or a live delta
    widened MBRs past the dictionaries."""
    return quantized is not False and delta is None and snap.has_narrow_planes


def _tile_reads_words(snap: IndexSnapshot, fused, variant: str, compact) -> bool:
    """Whether verification runs the full-width fused verify's query-tile
    launch, the one verify kernel that reads the packed query words."""
    return fused is not False and variant == "vmem" and _snap_cbank(snap, compact) is None


# ---------------------------------------------------------------- dense path
def _retrieve_dense(
    snap: IndexSnapshot, q_rects, q_bm, words, max_leaves: int, delta, fused, variant: str,
    compact,
) -> Dict[str, np.ndarray]:
    """The dense A/B scan: ``filter_pairs`` on every whole level, hits
    pushed down to the children through the dense child matrices, up to
    ``max_leaves`` hit leaves per query (smallest leaf id first), then
    ``_verify_leaves``."""
    if len(snap.child_matrix) != snap.n_levels - 1:
        raise ValueError("dense mode needs IndexSnapshot.build(..., dense=True)")
    M = q_rects.shape[0]
    active = torch.ones((M, snap.level_mbrs[0].shape[0]), dtype=torch.bool, device=snap.device)
    nodes_checked = torch.zeros((M,), dtype=torch.int32, device=snap.device)
    for li in range(snap.n_levels):
        mbrs, bms = _level_arrays(snap, delta, li)
        rel = ops.filter_pairs(q_rects, q_bm, mbrs, bms)
        nodes_checked = nodes_checked + _count(active)
        hit = (rel > 0) & active
        if li < snap.n_levels - 1:
            # each child has one parent, so the product is 0 or 1: exact in
            # f32 (CUDA has no int8 matrix product)
            active = (hit.to(torch.float32) @ snap.child_matrix[li].to(torch.float32)) > 0
    score = hit.to(torch.int32)
    take = min(max_leaves, score.shape[1])
    # a stable descending sort of the 0/1 scores: the hit leaves in
    # ascending id, then the misses in ascending id (lax.top_k's tie order)
    top_val, top_leaf = torch.sort(score, dim=1, descending=True, stable=True)
    top_val, top_leaf = top_val[:, :take], top_leaf[:, :take].to(torch.int32).contiguous()
    leaf_ok = top_val > 0
    overflow = (score.sum(dim=1, dtype=torch.int32) - take).clamp_min(0)
    ids, counts, verified = _verify_leaves(
        snap, q_rects, q_bm, words, top_leaf, leaf_ok, delta, fused, variant, compact
    )
    return dict(
        ids=ids.cpu().numpy(),
        counts=counts.cpu().numpy(),
        nodes_checked=nodes_checked.cpu().numpy().astype(np.int64),
        # the widths the reference's tiled filter scores, as it reports them
        nodes_scanned=np.full(
            (M,), sum(ops.padded_tile_len(int(m.shape[0])) for m in snap.level_mbrs), np.int64
        ),
        verified=verified.cpu().numpy(),
        overflow=overflow.cpu().numpy(),
    )


def retrieve(
    snap: IndexSnapshot,
    q_rects,
    q_bm,
    max_leaves: int = 32,
    mode: str = "frontier",
    plan_cache: Optional[PlanCache] = None,
    delta: Optional[DeltaBuffer] = None,
    fused: Optional[bool] = None,
    quantized: Optional[bool] = None,
    fused_variant: Optional[str] = None,
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Batched SKR retrieval on the snapshot's device. Exact as long as at
    most ``max_leaves`` leaves are relevant per query (the spill is counted
    in ``overflow``).

    ``q_rects`` (M, 4) f32 and ``q_bm`` (M, W) u32 (numpy, or tensors with
    the bitmap as its int32 view). ``plan_cache`` carries the frontier width
    state across calls (None: the per-snapshot default). ``delta`` (a
    ``DeltaBuffer`` over this snapshot) merges buffered inserts and deletes
    on the fly. ``quantized=None`` descends on the snapshot's narrow planes
    when it has them and no delta is live; ``False`` forces the f32
    full-width descent. ``fused=False`` forces the unfused verify (the A/B
    baseline); ``compact=False`` verifies on the full-width leaf bank;
    ``fused_variant`` picks the fused verify kernel (None/"auto", "vmem",
    "prefetch"). Every combination gives identical results. ``mode`` is
    ``"frontier"`` (the sparse descent) or ``"dense"`` (the dense A/B scan
    on whole levels, which needs ``IndexSnapshot.build(..., dense=True)``;
    it honours ``delta``, ``fused``, ``compact`` and ``fused_variant``, and
    has no narrow descent to pick with ``quantized``).
    """
    _check_knobs(snap, mode, delta)
    variant = "auto" if fused_variant is None else fused_variant
    if variant not in ops.FUSED_VARIANTS:
        raise ValueError(f"unknown fused-verify variant: {variant!r}")
    # only the full-width fused verify's query-tile launch reads packed words
    q_rects, q_bm_dev, words = _query_tensors(
        snap, q_rects, q_bm, _tile_reads_words(snap, fused, variant, compact)
    )
    if mode == "dense":
        return _retrieve_dense(snap, q_rects, q_bm_dev, words, max_leaves, delta, fused, variant,
                               compact)
    narrow = _narrow_descent(snap, quantized, delta)
    M = q_rects.shape[0]

    cache = plan_cache if plan_cache is not None else default_plan_cache(snap)
    plan = cache.plan("skr", snap.n_levels - 1)
    descend = lambda p: _descend_frontier(  # noqa: E731
        snap, q_rects, q_bm_dev, narrow, p, delta
    )
    out = descend(plan)
    retried = cache.check_and_retry(plan, out[-1], descend)
    frontier, surv, nodes_checked, used, _ = retried or out

    n_leaf = snap.n_leaves
    take = min(max_leaves, n_leaf, int(frontier.shape[1]))
    top_leaf, leaf_ok, overflow = _select_leaves_frontier(frontier, surv, take, n_leaf)
    ids, counts, verified = _verify_leaves(
        snap, q_rects, q_bm_dev, words, top_leaf, leaf_ok, delta, fused, variant, compact
    )
    return dict(
        ids=ids.cpu().numpy(),
        counts=counts.cpu().numpy(),
        nodes_checked=nodes_checked.cpu().numpy().astype(np.int64),
        nodes_scanned=np.full((M,), sum(used), np.int64),
        verified=verified.cpu().numpy(),
        overflow=overflow.cpu().numpy(),
        frontier_widths=np.asarray(used, np.int32),
    )


def retrieve_workload(
    snap: IndexSnapshot,
    workload: Workload,
    max_leaves: int = 32,
    **kw,
) -> Dict[str, np.ndarray]:
    return retrieve(snap, workload.rects, workload.kw_bitmap, max_leaves, **kw)


# ------------------------------------------------------- kNN (Boolean)
_ID_SENTINEL = int(np.iinfo(np.int32).max)

# bf16 carries an 8-bit mantissa: rounding a finite f32 distance to bf16
# perturbs it by at most 2^-9 relative. The retry guard divides by a 2^-6
# margin -- comfortably conservative -- to lower-bound what the true f32
# distance of a bf16-pruned node could have been.
_BF16_RISK_TOL = 2.0 ** -6

KNN_DTYPES = ("f32", "bf16")


def _quantize_dist(d, knn_dtype: str):
    """Round the sweep's f32 squared distances to bf16 (round to nearest
    even, as the reference) for ``knn_dtype="bf16"``."""
    if knn_dtype == "bf16":
        return d.to(torch.bfloat16).to(torch.float32)
    return d


def _sort2(key1, key2):
    """Sort each row lexicographically on (key1, key2) -- the reference's
    two-key ``lax.sort`` -- as two stable passes: on key2, then on key1.
    Returns both keys permuted."""
    k2, o = torch.sort(key2, dim=1, stable=True)
    k1, o2 = torch.sort(torch.gather(key1, 1, o), dim=1, stable=True)
    return k1, torch.gather(k2, 1, o2)


def _merge_topk(top_d, top_id, cand_d, cand_id, kb: int):
    """Merge candidates into the padded top-k buffer: sorted on (dist^2,
    object id), so equal-distance ties keep the smallest id."""
    d_s, id_s = _sort2(torch.cat([top_d, cand_d], dim=1), torch.cat([top_id, cand_id], dim=1))
    return d_s[:, :kb], id_s[:, :kb]


def _knn_dist_level(snap: IndexSnapshot, li: int, points, words, narrow: bool, frontier, delta):
    """Squared MBR min-distances of level ``li`` at the frontier:
    ``knn_level_dist_narrow`` on the level's narrow planes, or on the f32
    descent ``knn_level_dist`` on its f32 MBRs (the delta's widened arrays
    when one is live). Both read the level at the frontier themselves, so
    no per-slot plane is made (bit-identical distances). Returns the (M, F)
    distances, the per-query count of real slots, and the clamped
    frontier."""
    safe, valid = _clamped(snap, li, frontier)
    if narrow:
        d = ops.knn_level_dist_narrow(
            points, words[0], words[1], snap.level_mbr_codes[li], snap.level_bms[li], frontier,
            snap.level_dict_x[li], snap.level_dict_y[li],
        )
    else:
        mbrs, bms = _level_arrays(snap, delta, li)
        d = ops.knn_level_dist(points, words[0], words[1], mbrs, bms, frontier)
    return d, valid.sum(dim=1, dtype=torch.int32), safe


def _probe_children(child_table, cur):
    safe = cur.clamp(0, child_table.shape[0] - 1).long()
    return torch.where(cur[:, None] >= 0, child_table[safe], -1)


def _probe_select(d, cand):
    best = torch.argmin(d, dim=1, keepdim=True)  # ties: the first (lowest) slot
    bd = torch.gather(d, 1, best)[:, 0]
    nxt = torch.gather(cand, 1, best)[:, 0]
    return torch.where(torch.isfinite(bd), nxt, -1)


def _chunk_kw(q_bm, obj_bm, delta, cbank, leaves2d):
    """Keyword overlap of each query with the objects of the (M, T) leaves
    ``leaves2d`` (clamped here): ``(kw (M, T, OBJ), ikw (M, T, B) or
    None)``, ``ikw`` for the delta's insert slots. With ``cbank=(leaf_terms,
    obj_cbm, obj_sig)`` the test runs on the leaf-local compact bank --
    query words remapped per (query, leaf slot), a one-word signature gating
    the ``Wl``-word AND -- else on the full-width ``(K, OBJ, W)`` bank; the
    two are identical. Insert slots use the delta's remapped ``ins_cbm``
    when the compact bank is in play and the delta carries it, else the
    full-width ``ins_bm``."""
    full = lambda bank, safe: ((bank[safe] & q_bm[:, None, None, :]) != 0).any(dim=-1)  # noqa: E731
    if cbank is None:
        safe = leaves2d.clamp(0, obj_bm.shape[0] - 1).long()
        return full(obj_bm, safe), (None if delta is None else full(delta.ins_bm, safe))
    leaf_terms, obj_cbm, obj_sig = cbank
    safe = leaves2d.clamp(0, obj_cbm.shape[0] - 1).long()
    q_cbm, q_sig = ops.remap_query_words(q_bm, leaf_terms, leaves2d)

    def compact(cbm, sig):
        sig_hit = (sig[safe] & q_sig[:, :, None]) != 0
        return sig_hit & ((cbm[safe] & q_cbm[:, :, None, :]) != 0).any(dim=-1)

    kw = compact(obj_cbm, obj_sig)
    if delta is None:
        return kw, None
    if delta.ins_cbm is not None:
        return kw, compact(delta.ins_cbm, delta.ins_sig)
    return kw, full(delta.ins_bm, safe)


def _score_leaves(snap: IndexSnapshot, points, q_bm, delta, cbank, leaves2d, live):
    """Candidates of the (M, T) leaves ``leaves2d`` where ``live`` (M, T):
    every keyword-matching object's exact f32 squared distance (op by op,
    as the host oracle) and id, +inf / sentinel elsewhere, flattened to
    (M, T*(OBJ+B)); plus the validity mask. With a live delta each leaf's
    insert slots follow its object block and deleted objects never match."""
    M = points.shape[0]
    safe = leaves2d.clamp(0, snap.leaf_obj_x.shape[0] - 1).long()
    ox, oy, oid = snap.leaf_obj_x[safe], snap.leaf_obj_y[safe], snap.leaf_obj_id[safe]
    kw, ikw = _chunk_kw(q_bm, snap.leaf_obj_bm, delta, cbank, leaves2d)
    ok = oid >= 0
    if delta is not None:
        iid = delta.ins_id[safe]
        ok = torch.cat([ok & (delta.base_alive[safe] > 0), iid >= 0], dim=2)
        ox = torch.cat([ox, delta.ins_x[safe]], dim=2)
        oy = torch.cat([oy, delta.ins_y[safe]], dim=2)
        oid = torch.cat([oid, iid], dim=2)
        kw = torch.cat([kw, ikw], dim=2)
    dx = ox - points[:, 0, None, None]
    dy = oy - points[:, 1, None, None]
    od2 = dx * dx + dy * dy
    valid = ok & kw & live[:, :, None]
    cd = torch.where(valid, od2, float("inf")).reshape(M, -1)
    cid = torch.where(valid, oid, _ID_SENTINEL).reshape(M, -1)
    return cd, cid, valid


def _knn_probe_verify(snap: IndexSnapshot, points, q_bm, delta, cbank, leaf, top_d, top_id,
                      kb: int):
    """Verify the probe leaf's object block (and insert slots) and seed the
    top-k buffer."""
    cd, cid, valid = _score_leaves(snap, points, q_bm, delta, cbank, leaf[:, None],
                                   (leaf >= 0)[:, None])
    top_d, top_id = _merge_topk(top_d, top_id, cd, cid, kb)
    return top_d, top_id, valid.sum(dim=(1, 2), dtype=torch.int32)


def _bound_prune(d, top_d, k: int):
    """Frontier slots that survive the current k-th-best bound. ``<=`` keeps
    nodes at exactly the bound: they may hold an equal-distance object with
    a smaller id."""
    bound = top_d[:, k - 1]
    fin = torch.isfinite(d)
    alive = fin & (d <= bound[:, None])
    pruned = (fin & ~alive).sum(dim=1, dtype=torch.int32)
    return alive, pruned


def _risk(d, alive):
    """Per-query minimum of ``d * (1 - tol)`` over the finite slots bounded
    out: what a bf16-pruned node could at least still hold."""
    lower = torch.where(torch.isfinite(d) & ~alive, d * (1.0 - _BF16_RISK_TOL), float("inf"))
    return lower.min(dim=1).values


def _knn_leaf_phase(
    snap: IndexSnapshot, points, q_bm, delta, cbank, leaf_d, frontier, probe_leaf,
    top_d, top_id, k: int, kb: int, ch: int,
):
    """Distance-ordered chunked leaf verification.

    Leaves are sorted ascending by (min-dist, leaf id); each chunk of ``ch``
    leaves is checked against the bound as tightened by every previous
    chunk, so later (farther) chunks are usually bounded out entirely. The
    probe leaf is masked to +inf: its objects are already in the buffer.
    One Python iteration per chunk, where the reference runs a ``lax.scan``.
    With a live delta each chunk leaf's insert slots are verified beside its
    object block, and deleted objects stay out of the merge.

    Returns the buffer, the per-query leaves verified / objects verified /
    leaves bounded out, and the bf16 retry guard's risk over the chunks.
    """
    M, F = leaf_d.shape
    d = torch.where(frontier == probe_leaf[:, None], float("inf"), leaf_d)
    d_s, leaf_s = _sort2(d, frontier)
    lv = torch.zeros((M,), dtype=torch.int32, device=d.device)
    ver, pr = lv.clone(), lv.clone()
    rm = torch.full((M,), float("inf"), device=d.device)
    for c in range(0, F, ch):
        dc, lc = d_s[:, c:c + ch], leaf_s[:, c:c + ch]
        bound = top_d[:, k - 1]
        fin = torch.isfinite(dc)
        active = fin & (dc <= bound[:, None])
        cd, cid, valid = _score_leaves(snap, points, q_bm, delta, cbank, lc, active)
        top_d, top_id = _merge_topk(top_d, top_id, cd, cid, kb)
        lv += active.sum(dim=1, dtype=torch.int32)
        ver += valid.sum(dim=(1, 2), dtype=torch.int32)
        pr += (fin & ~active).sum(dim=1, dtype=torch.int32)
        rm = torch.minimum(rm, _risk(dc, active))
    return top_d, top_id, lv, ver, pr, rm


def _descend_knn(
    snap: IndexSnapshot, points, q_bm, words, narrow: bool, delta, cbank, k: int, kb: int,
    plan: ExecutionPlan, knn_dtype: str,
):
    """Distance-bounded kNN descent (probe -> bounded sweep -> leaf chunks).

    Width discipline is ``_descend_frontier``'s: exact mode syncs per level,
    cached mode runs sync-free and returns device maxima for the caller's
    batched overflow check. ``narrow`` switches the level filters to the
    narrow planes (bit-identical distances; leaf scoring stays on the exact
    f32 object bank either way); both read node words at the packed query
    words ``words``. ``delta`` swaps in the widened level
    arrays and merges insert slots and deletes into the probe and the leaf
    chunks. ``knn_dtype="bf16"`` rounds the sweep's
    node distances to bf16 before pruning and tracks ``risk``, the minimum
    conservative lower bound over everything pruned.
    """
    M = int(points.shape[0])
    L = snap.n_levels
    dev = snap.device

    def dist_level(li, fr):
        return _knn_dist_level(snap, li, points, words, narrow, fr, delta)

    top_d = torch.full((M, kb), float("inf"), device=dev)
    top_id = torch.full((M, kb), _ID_SENTINEL, dtype=torch.int32, device=dev)
    nodes_checked = torch.zeros((M,), dtype=torch.int32, device=dev)
    pruned = torch.zeros((M,), dtype=torch.int32, device=dev)

    # probe: beam-1 greedy descent to a leaf seeds the buffer, so the sweep
    # below starts with a finite bound and can prune before expansion
    cand = _root_frontier(snap, M)
    cur = None
    for li in range(L):
        if li > 0:
            cand = _probe_children(snap.child_table[li - 1], cur)
        d, nv, _ = dist_level(li, cand)
        nodes_checked = nodes_checked + nv
        cur = _probe_select(d, cand)
    probe_leaf = cur
    top_d, top_id, verified = _knn_probe_verify(
        snap, points, q_bm, delta, cbank, probe_leaf, top_d, top_id, kb
    )
    leaves_verified = (probe_leaf >= 0).to(torch.int32)

    # bounded sweep: full frontier descent, pruning against the k-th best
    frontier = _root_frontier(snap, M)
    used: List[int] = []
    needs: List = []
    leaf_d = None
    risk = torch.full((M,), float("inf"), device=dev)
    for li in range(L):
        used.append(int(frontier.shape[1]))
        d, nv, safe = dist_level(li, frontier)
        d = _quantize_dist(d, knn_dtype)
        nodes_checked = nodes_checked + nv
        if li < L - 1:
            alive, pr = _bound_prune(d, top_d, k)
            pruned = pruned + pr
            risk = torch.minimum(risk, _risk(d, alive))
            need = torch.where(alive, snap.child_counts[li][safe], 0).sum(dim=1)
            f_next = plan.pick_width(need, li, needs)
            frontier = _expand_frontier(snap.child_table[li], safe, alive, f_next)
        else:
            leaf_d = d

    F = int(frontier.shape[1])
    ch = 4 if F % 4 == 0 else 1
    top_d, top_id, lv, ver, pr, rm = _knn_leaf_phase(
        snap, points, q_bm, delta, cbank, leaf_d, frontier, probe_leaf, top_d, top_id, k, kb,
        ch,
    )
    result = (
        top_d, top_id, nodes_checked, verified + ver, leaves_verified + lv, pruned + pr,
        used, torch.minimum(risk, rm),
    )
    return result, needs


def _lex_order(key1, key2):
    """Per row, the permutation sorting (key1, key2) lexicographically (two
    stable passes; NaN keys last)."""
    o = torch.sort(key2, dim=1, stable=True).indices
    o2 = torch.sort(torch.gather(key1, 1, o), dim=1, stable=True).indices
    return torch.gather(o, 1, o2)


def _gather_pairs(d, ids, axis):
    """``_gather_cat`` of an f32 (M, F) and an int32 (M, F) tensor in one
    all-gather (the distances travel as their bits)."""
    M, F = d.shape
    g = _gather_cat(torch.cat([d.view(torch.int32), ids], dim=1), axis).reshape(M, axis.size, 2, F)
    return g[:, :, 0].reshape(M, -1).view(torch.float32), g[:, :, 1].reshape(M, -1)


def _global_rank(gd, gg, index: int, F: int):
    """(M, F) rank of shard ``index``'s keys -- columns ``[index*F,
    (index+1)*F)`` of the gathered (M, T) keys ``(gd, gg)`` -- under the
    (dist, gid) order: each key's position in a lexicographic sort of its
    row. For a finite key with a unique gid that is the count of keys
    strictly below it; NaN and +inf keys sort after every finite one. Memory
    is O(M*T); no (M, F, T) compare is built."""
    M, T = gd.shape
    order = _lex_order(gd, gg)
    pos = torch.empty((M, T), dtype=torch.int64, device=gd.device)
    pos.scatter_(1, order, torch.arange(T, device=gd.device).expand(M, -1))
    return pos[:, index * F:(index + 1) * F]


def _knn_leaf_phase_indexed(
    snap: IndexSnapshot, points, q_bm, delta, cbank, leaf_d, frontier, probe_leaf, leaf_gid,
    top_d, top_id, k: int, kb: int, ch: int, axis,
):
    """Index-parallel twin of ``_knn_leaf_phase``.

    Parity with the single-device leaf phase needs the *global* ascending
    (min-dist, global leaf id) chunk order, because each chunk's bound is
    tightened by every previous chunk. Each shard ranks its local leaves
    within the all-gathered global (dist, gid) keys and scatters them into
    their global-rank slots; slots owned by other shards stay ``(inf, -1)``
    locally, so every shard walks the same global chunk sequence with
    exactly its own leaves materialized. After each chunk the shards
    exchange their local top-kb candidates and merge them into a shared
    buffer -- the truncation is lossless (a chunk contributes at most kb of
    the new top-kb) -- so the bound sequence, and therefore which leaves are
    verified and which bounded out, is the single-device scan's. Counters
    are per shard (each real leaf counted by its owner only); the caller
    sums them over the ``index`` axis.

    The rank of a leaf is its position in a lexicographic sort of the
    gathered keys: a real leaf's global id is unique, so that position is
    the count of keys strictly below it (the reference's (M, F, S*F)
    compare, which this never builds), and NaN and +inf keys sort after
    every finite one, where the compare never counts them either.
    """
    M, F = leaf_d.shape
    K = leaf_gid.shape[0]
    inf = float("inf")
    d = torch.where(frontier == probe_leaf[:, None], inf, leaf_d)
    gid = torch.where(frontier >= 0, leaf_gid[frontier.clamp(0, K - 1).long()], _ID_SENTINEL)
    gid = torch.where(torch.isfinite(d), gid, _ID_SENTINEL)
    o = _lex_order(d, gid)
    d_s, gid_s, leaf_s = (torch.gather(t, 1, o) for t in (d, gid, frontier))

    T = axis.size * F
    rank = _global_rank(*_gather_pairs(d_s, gid_s, axis), axis.index, F)

    nch = -(-T // ch)
    fin = torch.isfinite(d_s)
    tgt = torch.where(fin, rank, nch * ch)  # non-finite keys land in the dump slot
    buf_d = torch.full((M, nch * ch + 1), inf, device=d.device)
    buf_l = torch.full((M, nch * ch + 1), -1, dtype=torch.int32, device=d.device)
    buf_d.scatter_(1, tgt, torch.where(fin, d_s, inf))
    buf_l.scatter_(1, tgt, torch.where(fin, leaf_s, -1))
    lv = torch.zeros((M,), dtype=torch.int32, device=d.device)
    ver, pr = lv.clone(), lv.clone()
    for c in range(0, nch * ch, ch):
        dc, lc = buf_d[:, c:c + ch], buf_l[:, c:c + ch]
        bound = top_d[:, k - 1]
        fin = torch.isfinite(dc)
        active = fin & (dc <= bound[:, None])
        cd, cid, valid = _score_leaves(snap, points, q_bm, delta, cbank, lc, active)
        loc_d, loc_id = _merge_topk(torch.full_like(top_d, inf),
                                    torch.full_like(top_id, _ID_SENTINEL), cd, cid, kb)
        g_d, g_id = _gather_pairs(loc_d, loc_id, axis)  # (M, S*kb)
        top_d, top_id = _merge_topk(top_d, top_id, g_d, g_id, kb)
        lv += active.sum(dim=1, dtype=torch.int32)
        ver += valid.sum(dim=(1, 2), dtype=torch.int32)
        pr += (fin & ~active).sum(dim=1, dtype=torch.int32)
    return top_d, top_id, lv, ver, pr


def _descend_knn_indexed(
    snap: IndexSnapshot, root_gid, leaf_gid, n_root_local: int, points, q_bm, words,
    narrow: bool, delta, cbank, k: int, kb: int, plan: ExecutionPlan, axis,
):
    """Index-parallel kNN descent: one rank's shard of the hierarchy.

    ``snap`` is this rank's slab (``PartitionedSnapshot.shard``);
    ``root_gid``/``leaf_gid`` map its local slots to global ids and
    ``n_root_local`` is its real root count; ``axis`` is the mesh's
    ``index`` axis. Three exchanges keep exact parity with ``_descend_knn``:

    1. *Probe*: every shard scans its local roots (their summed count
       equals the global root scan), then the shards exchange their best
       ``(dist, root gid)`` -- the lexicographic minimum elects the one
       *canonical* shard whose greedy chain is the single-device probe's
       (smallest-id argmin tie-break). Only the canonical shard counts the
       probe's lower levels and verifies its probe leaf; the seeded top-k
       buffer is then shared by an all-gather and a sort.
    2. *Sweep*: shard-local -- the bound does not move during the sweep, so
       per-node prune decisions are the single-device sweep's and the
       counters sum exactly.
    3. *Leaf phase*: ``_knn_leaf_phase_indexed`` walks the global
       (dist, gid)-ordered chunk sequence with a shared bound.

    Always exact f32. Returns the 7-tuple result (no risk) and this
    shard's ``needs``.
    """
    M = int(points.shape[0])
    L = snap.n_levels
    dev = snap.device
    inf = float("inf")

    def dist_level(li, fr):
        return _knn_dist_level(snap, li, points, words, narrow, fr, delta)

    top_d = torch.full((M, kb), inf, device=dev)
    top_id = torch.full((M, kb), _ID_SENTINEL, dtype=torch.int32, device=dev)
    nodes_checked = torch.zeros((M,), dtype=torch.int32, device=dev)
    pruned = torch.zeros((M,), dtype=torch.int32, device=dev)

    # probe: local root scan, then one (dist, gid) exchange elects the
    # canonical shard that owns the single-device greedy chain
    cand = _local_root_frontier(snap.root_width(), n_root_local, M, dev)
    d0, nv0, _ = dist_level(0, cand)
    nodes_checked = nodes_checked + nv0
    best = torch.argmin(d0, dim=1, keepdim=True)  # ties: the lowest slot, the smallest gid
    bd = torch.gather(d0, 1, best)[:, 0]
    bslot = torch.gather(cand, 1, best)[:, 0]
    fin_bd = torch.isfinite(bd)
    bgid = torch.where((bslot >= 0) & fin_bd,
                       root_gid[bslot.clamp(0, root_gid.shape[0] - 1).long()], _ID_SENTINEL)
    g = axis.all_gather(torch.stack([torch.where(fin_bd, bd, inf).view(torch.int32), bgid]))
    g_bd, g_bg = g[:, 0].view(torch.float32), g[:, 1]  # (S, M)
    win_d = g_bd.min(dim=0).values
    win_gid = torch.where(g_bd == win_d, g_bg, _ID_SENTINEL).min(dim=0).values
    canonical = fin_bd & (bd == win_d) & (bgid == win_gid)
    cur = torch.where(fin_bd, bslot, -1)
    for li in range(1, L):
        cand = _probe_children(snap.child_table[li - 1], cur)
        d, nv, _ = dist_level(li, cand)
        nodes_checked = nodes_checked + torch.where(canonical, nv, 0)
        cur = _probe_select(d, cand)
    probe_leaf = torch.where(canonical, cur, -1)
    top_d, top_id, verified = _knn_probe_verify(
        snap, points, q_bm, delta, cbank, probe_leaf, top_d, top_id, kb
    )
    leaves_verified = (probe_leaf >= 0).to(torch.int32)
    # share the canonical shard's seed so every shard sweeps the same bound
    top_d, top_id = _sort2(*_gather_pairs(top_d, top_id, axis))
    top_d, top_id = top_d[:, :kb], top_id[:, :kb]

    # bounded sweep: shard-local (the bound is fixed until the leaf phase)
    frontier = _local_root_frontier(snap.root_width(), n_root_local, M, dev)
    used: List[int] = []
    needs: List = []
    leaf_d = None
    for li in range(L):
        used.append(int(frontier.shape[1]))
        d, nv, safe = dist_level(li, frontier)
        nodes_checked = nodes_checked + nv
        if li < L - 1:
            alive, pr = _bound_prune(d, top_d, k)
            pruned = pruned + pr
            need = torch.where(alive, snap.child_counts[li][safe], 0).sum(dim=1)
            f_next = plan.pick_width(need, li, needs)
            frontier = _expand_frontier(snap.child_table[li], safe, alive, f_next)
        else:
            leaf_d = d

    F = int(frontier.shape[1])
    ch = 4 if F % 4 == 0 else 1
    top_d, top_id, lv, ver, pr = _knn_leaf_phase_indexed(
        snap, points, q_bm, delta, cbank, leaf_d, frontier, probe_leaf, leaf_gid, top_d, top_id,
        k, kb, ch, axis,
    )
    result = (top_d, top_id, nodes_checked, verified + ver, leaves_verified + lv, pruned + pr,
              used)
    return result, needs


def retrieve_knn(
    snap: IndexSnapshot,
    points,
    q_bm,
    k: int,
    min_topk_bucket: int = 8,
    plan_cache: Optional[PlanCache] = None,
    delta: Optional[DeltaBuffer] = None,
    quantized: Optional[bool] = None,
    knn_dtype: str = "f32",
    compact: Optional[bool] = None,
) -> Dict[str, np.ndarray]:
    """Batched Boolean kNN on the snapshot's device.

    ``points`` (M, 2) f32 and ``q_bm`` (M, W) u32 (numpy, or tensors with
    the bitmap as its int32 view). Returns per-query ``ids``/``dist2`` of
    the exact k nearest keyword-matching objects (ascending (dist^2, id);
    ``-1``-padded when fewer than k objects match) plus the counters
    ``nodes_checked``, ``verified`` (keyword-matching objects scored),
    ``leaves_verified`` (leaf blocks verified), ``pruned`` (keyword-matching
    frontier slots bounded out) and ``frontier_widths``.

    ``delta`` (a ``DeltaBuffer`` over this snapshot) merges buffered
    inserts and deletes on the fly. ``quantized=None`` descends on the
    snapshot's narrow planes when it has them and no delta is live;
    ``False`` forces the f32 full-width descent. ``compact=None`` runs
    every leaf keyword test on the compact leaf bank when the snapshot has
    one; ``False`` forces the full-width bank. Results are identical every
    way. ``knn_dtype="bf16"`` prunes the bounded sweep on bf16-rounded node
    distances and retries the whole batch in exact f32 whenever the tracked
    risk reaches the final k-th bound; the output gains
    ``knn_dtype_retried`` and ids always equal the f32 path's.
    """
    if knn_dtype not in KNN_DTYPES:
        raise ValueError(f"knn_dtype must be 'f32' or 'bf16', got {knn_dtype!r}")
    _check_delta(snap, delta)
    # both descents read the node words at the packed query words
    points_t, q_bm_dev, words = _query_tensors(snap, points, q_bm, True)
    narrow = _narrow_descent(snap, quantized, delta)
    M = int(points_t.shape[0])
    if k <= 0:
        z = np.zeros(M, np.int64)
        return dict(
            ids=np.zeros((M, 0), np.int32), dist2=np.zeros((M, 0), np.float32),
            nodes_checked=z, verified=z.copy(), leaves_verified=z.copy(),
            pruned=z.copy(), frontier_widths=np.zeros(0, np.int32),
        )
    kb = round_up_bucket(k, min_topk_bucket)
    cache = plan_cache if plan_cache is not None else default_plan_cache(snap)
    cbank = _snap_cbank(snap, compact)
    plan = cache.plan("knn", snap.n_levels - 1)
    descend = lambda p: _descend_knn(  # noqa: E731
        snap, points_t, q_bm_dev, words, narrow, delta, cbank, k, kb, p, knn_dtype
    )
    out = descend(plan)
    retried = cache.check_and_retry(plan, out[-1], descend)
    (top_d, top_id, nodes_checked, verified, leaves_verified,
     pruned, used, risk) = (retried or out)[0]
    if knn_dtype == "bf16":
        bound = top_d[:, k - 1]
        if bool((torch.isfinite(risk) & (risk <= bound)).any()):
            exact = retrieve_knn(
                snap, points, q_bm, k, min_topk_bucket=min_topk_bucket,
                plan_cache=cache, delta=delta, quantized=quantized, knn_dtype="f32",
                compact=compact,
            )
            exact["knn_dtype_retried"] = True
            return exact
    ids = torch.where(torch.isfinite(top_d[:, :k]), top_id[:, :k], -1)
    result = dict(
        ids=ids.cpu().numpy(),
        dist2=top_d[:, :k].cpu().numpy(),
        nodes_checked=nodes_checked.cpu().numpy().astype(np.int64),
        verified=verified.cpu().numpy().astype(np.int64),
        leaves_verified=leaves_verified.cpu().numpy().astype(np.int64),
        pruned=pruned.cpu().numpy().astype(np.int64),
        frontier_widths=np.asarray(used, np.int32),
    )
    if knn_dtype == "bf16":
        result["knn_dtype_retried"] = False
    return result
