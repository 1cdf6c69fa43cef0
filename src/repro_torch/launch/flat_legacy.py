"""The flat leaf-sharded serving fallback (the legacy regime).

The hierarchy-free scan: the leaf rows (with their object blocks) are split
over the mesh's leaf axis, every rank filters its local leaves against its
query rows, verifies the best ``TOP_LEAVES_LOCAL`` of them, and the
per-query counts are summed over the leaf axis. Retired from the serving
front door -- the index-parallel regime (``serve_index_sharded``) serves
large indexes with the hierarchy at exact parity -- it stays as the A/B
floor a hierarchical descent must beat (a flat scan touches every leaf).
The port of the JAX package's ``launch/flat_legacy.py``, its dry-run
surface included: ``make_inputs`` gives the step's operands as ``meta``
tensors and ``trace_wisk_serve`` traces one rank's step on a mesh of
placeholder ranks (``launch/mesh.py:make_abstract_mesh``), the counterpart
of the reference's ``lower_wisk_serve``.

On CUDA tensors the filter is the ``skr_filter`` kernel
(``ops.filter_pairs``) and the single-stage verify the ``skr_verify``
kernel (``ops.verify_candidates``); CPU and meta tensors run their plain
versions (the reference's dry run lowers its plain math too).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.wisk import WiskServeConfig
from ..kernels import ops
from ..roofline.op_stats import OpStats
from ..sharding.rules import default_rules, shard_tensor
from .mesh import collective_census

OBJ_PER_LEAF = 512
TOP_LEAVES_LOCAL = 4


def _top_cols(score: torch.Tensor, take: int) -> torch.Tensor:
    """Per row, the columns of the ``take`` largest scores, lowest column
    first among equals (``lax.top_k``'s order)."""
    return torch.sort(score, dim=1, descending=True, stable=True).indices[:, :take]


def wisk_serve_step(q_rects, q_bm, leaf_mbrs, leaf_bm, obj_x, obj_y, obj_bm, obj_valid,
                    two_stage: bool = False, stage2_cap: int = 512, axis=None):
    """Local (per-rank) filter + verify; counts, scanned and overflow summed
    over ``axis`` (the mesh axis the leaves are split over, e.g.
    ``mesh.axis("index")``; None: one rank).

    ``q_*``: this rank's query rows (``q_bm`` int32 views of the u32
    words); ``leaf_*``/``obj_*``: its leaf rows, ``OBJ_PER_LEAF`` object
    slots a leaf, ``obj_valid`` int8.

    ``two_stage``: verify in-rectangle membership on the (x, y) pairs first
    and read the keyword bitmaps only for the (capacity-bounded) spatial
    survivors. ``overflow`` counts the spatial survivors beyond
    ``stage2_cap`` whose matches the capacity bound dropped -- the counts
    are a lower bound wherever it is nonzero.
    """
    M = q_rects.shape[0]
    rel = ops.filter_pairs(q_rects, q_bm, leaf_mbrs, leaf_bm)  # (M, K) int8
    sizes = (obj_valid > 0).sum(dim=1)  # (K,)
    score = rel.to(torch.int32) * (1 + sizes[None, :]).to(torch.int32)
    top_leaf = _top_cols(score, TOP_LEAVES_LOCAL)  # (M, L)
    cx = obj_x[top_leaf].reshape(M, -1)
    cy = obj_y[top_leaf].reshape(M, -1)
    cval = obj_valid[top_leaf].reshape(M, -1)
    leaf_ok = torch.gather(rel, 1, top_leaf)  # irrelevant leaves contribute nothing
    cval = cval * leaf_ok.repeat_interleave(OBJ_PER_LEAF, dim=1)
    if two_stage:
        inr = ((cx >= q_rects[:, 0:1]) & (cx <= q_rects[:, 2:3])
               & (cy >= q_rects[:, 1:2]) & (cy <= q_rects[:, 3:4]) & (cval > 0))
        cap = min(stage2_cap, inr.shape[1])
        idx2 = _top_cols(inr.to(torch.int32), cap)  # (M, cap)
        val2 = torch.gather(inr, 1, idx2)
        # the surviving candidate slots back to (leaf, slot) for a narrow gather
        leaf_of = top_leaf.repeat_interleave(OBJ_PER_LEAF, dim=1)
        slot_of = torch.arange(OBJ_PER_LEAF, device=q_rects.device).repeat(M, TOP_LEAVES_LOCAL)
        sel_leaf = torch.gather(leaf_of, 1, idx2)
        sel_slot = torch.gather(slot_of, 1, idx2)
        cbm2 = obj_bm[sel_leaf, sel_slot]  # (M, cap, W): the survivors' bitmaps only
        kw = ((cbm2 & q_bm[:, None, :]) != 0).any(dim=-1)
        counts = (kw & val2).sum(dim=1, dtype=torch.int32)
        overflow = (inr.sum(dim=1, dtype=torch.int32) - cap).clamp_min(0)
    else:
        cbm = obj_bm[top_leaf].reshape(M, -1, q_bm.shape[1])
        match = ops.verify_candidates(q_rects, q_bm, cx, cy, cbm, cval.to(torch.int8))
        counts = match.to(torch.int32).sum(dim=1, dtype=torch.int32)
        overflow = torch.zeros_like(counts)
    scanned = rel.to(torch.int32).sum(dim=1, dtype=torch.int32)
    if axis is not None:
        counts, scanned, overflow = axis.psum(counts), axis.psum(scanned), axis.psum(overflow)
    return counts, scanned, overflow


# the operands' logical names, in the step's argument order
INPUT_NAMES = dict(
    q_rects=("query", None), q_bm=("query", None),
    leaf_mbrs=("leaf", None), leaf_bm=("leaf", None),
    obj_x=("leaf", None), obj_y=("leaf", None),
    obj_bm=("leaf", "obj_slot", "word"), obj_valid=("leaf", None),
)


def make_inputs(cfg: WiskServeConfig) -> Dict[str, torch.Tensor]:
    """The flat step's whole operands as ``meta`` tensors (nothing is
    allocated): the reference's shapes, the u32 bitmap words as int32."""
    W = cfg.vocab // 32
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")  # noqa: E731
    return dict(
        q_rects=meta((cfg.n_queries, 4), torch.float32),
        q_bm=meta((cfg.n_queries, W), torch.int32),
        leaf_mbrs=meta((cfg.n_nodes, 4), torch.float32),
        leaf_bm=meta((cfg.n_nodes, W), torch.int32),
        obj_x=meta((cfg.n_nodes, OBJ_PER_LEAF), torch.float32),
        obj_y=meta((cfg.n_nodes, OBJ_PER_LEAF), torch.float32),
        obj_bm=meta((cfg.n_nodes, OBJ_PER_LEAF, W), torch.int32),
        obj_valid=meta((cfg.n_nodes, OBJ_PER_LEAF), torch.int8),
    )


def trace_wisk_serve(mesh, cfg: WiskServeConfig = None, two_stage: bool = False) -> Dict:
    """Trace (never execute) one rank's flat step on ``mesh`` (an abstract
    ``("data", "model")`` mesh): the queries split over the data axes and
    the leaves with their object blocks over ``model`` by the rules, the
    counts summed over ``model``. Returns the rank's ``argument_bytes``,
    its ``op_census`` (``roofline/op_stats.py``) and its collective census
    (``collective_bytes_by_axis`` / ``collective_counts_by_axis``). Host
    only: every tensor is ``meta``."""
    cfg = cfg or WiskServeConfig()
    rules = default_rules(mesh)
    args = [shard_tensor(t, INPUT_NAMES[k], mesh, rules) for k, t in make_inputs(cfg).items()]
    with collective_census() as census, OpStats() as stats:
        wisk_serve_step(*args, two_stage=two_stage, axis=mesh.axis("model"))
    return dict(argument_bytes=sum(t.numel() * t.element_size() for t in args),
                op_census=stats.as_dict(), collective_bytes_by_axis=census.bytes,
                collective_counts_by_axis=census.counts)
