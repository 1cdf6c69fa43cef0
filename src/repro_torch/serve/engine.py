"""Executor layer: batched SKR retrieval over an ``IndexSnapshot``.

The port of the JAX package's ``serve/engine.py`` frontier path on its
default knobs -- the serving main path:

1. ``pack_query_words`` packs each query bitmap to its nonzero words on the
   host (the batch's bitmaps are there before the descent starts).
2. ``_descend_frontier``: each query carries a padded int32 frontier of
   candidate node ids. Per level, the int16 MBR rank codes and the packed
   word planes of the frontier are gathered, the ``frontier_narrow`` CUDA
   kernel filters them, and the survivors' children are expanded through
   the CSR child table into the next frontier, compacted with a prefix sum
   and a scatter. Widths come from the caller's ``PlanCache``.
3. ``_select_leaves_frontier`` keeps up to ``max_leaves`` surviving leaves
   per query, lowest leaf id first (the spill is counted in ``overflow``).
4. ``_verify_leaves`` remaps the query words into each selected leaf's
   local vocabulary and runs the fused gather+verify CUDA kernel on the
   compact leaf bank.

Every output key and dtype equals the reference's: ``ids``, ``counts``,
``verified``, ``overflow`` (int32), ``nodes_checked``, ``nodes_scanned``
(int64) and ``frontier_widths`` (int32). The other knobs of the reference
(``mode="dense"``, ``quantized=False``, ``compact=False``, ``fused=False``,
a live ``delta``) and snapshots without narrow planes or a compact bank
raise ``NotImplementedError``: they need kernels this port does not have
yet, and the path never routes around the ported ones.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..core.query import round_up_bucket  # noqa: F401  (re-export, as in the reference)
from ..core.types import Workload
from ..kernels import ops
from .plan import ExecutionPlan, PlanCache, default_plan_cache
from .snapshot import IndexSnapshot, to_device


def _check_knobs(snap: IndexSnapshot, mode, delta, fused, quantized, compact) -> None:
    if mode == "dense":
        raise NotImplementedError("mode='dense' (the dense A/B scan) is not ported: ROADMAP A.6")
    if mode != "frontier":
        raise ValueError(f"unknown retrieve mode {mode!r}")
    if delta is not None:
        raise NotImplementedError("live deltas are not ported: ROADMAP A.8")
    if quantized is False:
        raise NotImplementedError(
            "quantized=False (the f32 full-width descent) is not ported: ROADMAP A.6, B.4"
        )
    if fused is False:
        raise NotImplementedError("fused=False (unfused verify) is not ported: ROADMAP A.6, B.9")
    if compact is False:
        raise NotImplementedError(
            "compact=False (full-width verify) is not ported: ROADMAP A.6, B.5-B.6"
        )
    if not snap.has_narrow_planes:
        raise NotImplementedError(
            "the snapshot has no narrow MBR planes (a level overflowed NARROW_DICT_MAX); "
            "the f32 descent is not ported: ROADMAP A.6, B.4"
        )
    if not snap.has_compact_bank:
        raise NotImplementedError(
            "the snapshot has no compact leaf bank (a leaf overflowed LEAF_DICT_MAX); "
            "full-width verify is not ported: ROADMAP A.6, B.5-B.6"
        )


# ------------------------------------------------------------ frontier steps
def _filter_level(snap: IndexSnapshot, li: int, q_rects, wids, bits, frontier):
    """Gather the frontier's rank codes and packed word planes, then run the
    narrow frontier kernel. Returns the (M, F) survivors, the per-query
    count of real slots, and the clamped frontier used for the gathers."""
    codes = snap.level_mbr_codes[li]
    valid = frontier >= 0
    safe = frontier.clamp(0, codes.shape[0] - 1).long()
    f_bm = snap.level_bms[li][safe[:, :, None], wids[:, None, :]]  # (M, F, Wp)
    surv = ops.filter_frontier_narrow(
        q_rects, bits, codes[safe], f_bm, valid.to(torch.int8),
        snap.level_dict_x[li], snap.level_dict_y[li],
    )
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


def _root_frontier(snap: IndexSnapshot, M: int) -> torch.Tensor:
    n_root = int(snap.level_mbrs[0].shape[0])
    root = torch.full((snap.root_width(),), -1, dtype=torch.int32, device=snap.device)
    root[:n_root] = torch.arange(n_root, dtype=torch.int32, device=snap.device)
    return root[None, :].expand(M, -1).contiguous()


def _descend_frontier(snap: IndexSnapshot, q_rects, wids, bits, plan: ExecutionPlan):
    """The range-query frontier descent on the narrow planes.

    ``plan.widths=None``: exact mode -- bucket each next frontier on the
    batch's actual occupancy, one host sync per level. ``plan.widths=(...)``:
    cached mode -- no per-level syncs; the per-level child-count maxima stay
    on the device for the caller's single batched overflow check.
    """
    M = q_rects.shape[0]
    frontier = _root_frontier(snap, M)
    nodes_checked = torch.zeros((M,), dtype=torch.int32, device=snap.device)
    used = []
    needs = []
    surv = None
    for li in range(snap.n_levels):
        used.append(int(frontier.shape[1]))
        surv, n_valid, safe = _filter_level(snap, li, q_rects, wids, bits, frontier)
        nodes_checked = nodes_checked + n_valid
        if li < snap.n_levels - 1:
            need = torch.where(surv > 0, snap.child_counts[li][safe], 0).sum(dim=1)
            f_next = plan.pick_width(need, li, needs)
            frontier = _expand_frontier(snap.child_table[li], safe, surv, f_next)
    return frontier, surv, nodes_checked, used, needs


def _verify_leaves(snap: IndexSnapshot, q_rects, q_bm, top_leaf, leaf_ok, variant: str):
    """Remap the query words into the selected leaves' vocabularies, then
    gather + verify the leaves' compact blocks in one kernel."""
    q_cbm, q_sig = ops.remap_query_words(q_bm, snap.leaf_terms, top_leaf)
    ids, kwv = ops.fused_gather_verify_compact(
        q_rects, q_cbm, q_sig, top_leaf, leaf_ok.to(torch.int8),
        snap.leaf_obj_x, snap.leaf_obj_y, snap.leaf_obj_cbm, snap.leaf_obj_sig,
        snap.leaf_obj_id, variant=variant,
    )
    counts = (ids >= 0).sum(dim=1, dtype=torch.int32)
    return ids, counts, kwv.sum(dim=1, dtype=torch.int32)


def _host_words(q_bm) -> np.ndarray:
    """The batch's u32 bitmap words on the host (an int32 tensor is read as
    the bit view it is)."""
    if isinstance(q_bm, torch.Tensor):
        if q_bm.dtype != torch.int32:
            raise TypeError(f"bitmap tensors are int32 bit views, got {q_bm.dtype}")
        return q_bm.detach().cpu().numpy().view(np.uint32)
    return np.asarray(q_bm, np.uint32)


def retrieve(
    snap: IndexSnapshot,
    q_rects,
    q_bm,
    max_leaves: int = 32,
    mode: str = "frontier",
    plan_cache: Optional[PlanCache] = None,
    delta=None,
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
    state across calls (None: the per-snapshot default). ``fused_variant``
    picks the fused verify kernel (None/"auto", "vmem", "prefetch"); every
    variant gives identical results. The remaining knobs accept only their
    defaults (see the module docstring).
    """
    _check_knobs(snap, mode, delta, fused, quantized, compact)
    variant = "auto" if fused_variant is None else fused_variant
    if variant not in ops.FUSED_VARIANTS:
        raise ValueError(f"unknown fused-verify variant: {variant!r}")
    dev = snap.device
    words = _host_words(q_bm)
    wids, bits = ops.pack_query_words(words)
    if not isinstance(q_rects, torch.Tensor):
        q_rects = torch.from_numpy(np.ascontiguousarray(q_rects, np.float32))
    q_rects = q_rects.to(dev, torch.float32).contiguous()
    q_bm_dev = to_device(words, dev)
    wids = to_device(wids, dev).long()
    bits = to_device(bits, dev)
    M = q_rects.shape[0]

    cache = plan_cache if plan_cache is not None else default_plan_cache(snap)
    plan = cache.plan("skr", snap.n_levels - 1)
    descend = lambda p: _descend_frontier(snap, q_rects, wids, bits, p)  # noqa: E731
    out = descend(plan)
    retried = cache.check_and_retry(plan, out[-1], descend)
    frontier, surv, nodes_checked, used, _ = retried or out

    n_leaf = snap.n_leaves
    take = min(max_leaves, n_leaf, int(frontier.shape[1]))
    top_leaf, leaf_ok, overflow = _select_leaves_frontier(frontier, surv, take, n_leaf)
    ids, counts, verified = _verify_leaves(snap, q_rects, q_bm_dev, top_leaf, leaf_ok, variant)
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
