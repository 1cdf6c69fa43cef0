"""WISK construction (paper Alg. 1): end-to-end orchestration.

Step 1: mine frequent itemsets, fit the CDF bank, learn the bottom clusters
        with SGD split learning (Alg. 2).
Step 2: label bottom clusters with (sampled) training queries and pack them
        level by level with the DQN (Alg. 3).

``accelerated=True`` enables the §6 accelerations: stratified query sampling
(default 30%) and spectral-clustering grouping of bottom clusters (default
20% ratio), matching the "Accelerated WISK" row of Table 4.

``construction`` selects the execution strategy for both learned phases:
``"batched"`` (default) runs frontier-parallel split learning and packing
episodes with no host sync inside; ``"sequential"`` keeps the per-subspace /
per-env-step host loops. Per-phase timings (host clock after the device
finished) plus round/dispatch counters land in ``BuildArtifacts.timings`` /
``.counters``, with the JAX package's keys.

The bank, the split learner and the DQN train on ``device`` (``cuda``
unless the caller names another) in full float32; mining, the heap walk,
labelling and assembly are host numpy, as in the JAX package's
``core/build.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import full_f32_matmul, resolve_device
from .cdf import CDFBank, bank_from_reference, build_cdf_bank
from .drift import leaf_cost_profile, regressed_leaves
from .index import assemble_index
from .itemsets import expand_queries, mine_frequent_itemsets
from .packing import HierarchyResult, PackingConfig, build_hierarchy
from .partition import (
    PartitionConfig,
    PartitionResult,
    generate_bottom_clusters,
    refine_partition,
)
from .types import ClusterSet, GeoTextDataset, Workload, WiskIndex, rects_intersect
from ..data.workloads import stratified_sample


@dataclasses.dataclass
class BuildConfig:
    partition: PartitionConfig = dataclasses.field(default_factory=PartitionConfig)
    packing: PackingConfig = dataclasses.field(default_factory=PackingConfig)
    use_itemsets: bool = True
    itemset_min_support: float = 1e-5  # paper §7.6.3: 0.01 per-mille
    itemset_max_size: int = 3
    cdf_force_class: Optional[str] = None  # None | "gauss" | "nn" (Fig. 19 ablation)
    cdf_high_thresh: float = 0.001
    cdf_low_thresh: float = 0.00001
    cdf_train_steps: int = 300
    accelerated: bool = False
    sample_ratio: float = 0.3  # query sampling for training (Fig. 13a)
    cluster_ratio: float = 0.2  # spectral grouping ratio (Fig. 13b)
    build_hierarchy: bool = True
    construction: str = "batched"  # "batched" | "sequential"
    seed: int = 0


@dataclasses.dataclass
class BuildArtifacts:
    index: WiskIndex
    bank: CDFBank
    partition: PartitionResult
    hierarchy: Optional[HierarchyResult]
    timings: Dict[str, float]
    # execution-strategy counters: learner calls / rounds / host syncs per
    # learned phase, for the batched-vs-sequential A/B
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # reuse state for warm-start rebuilds (DESIGN.md §7): the mined itemsets
    # (so expand_queries need not re-mine) and the workload the layout was
    # trained on (the drift baseline the regressed-leaf detection compares
    # observed traffic against)
    itemsets: list = dataclasses.field(default_factory=list)
    train_workload: Optional[Workload] = None


def cluster_query_labels(index_or_clusters, workload: Workload) -> np.ndarray:
    """(K, m) bool: cluster intersects query rect AND shares a keyword."""
    clusters = index_or_clusters
    inter = rects_intersect(clusters.mbrs[:, None, :], workload.rects[None, :, :])
    kw = np.any(
        clusters.bitmaps[:, None, :] & workload.kw_bitmap[None, :, :] != 0, axis=-1
    )
    return inter & kw


def _clock(dev: torch.device) -> float:
    """The host clock once the device has finished its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@full_f32_matmul()
def build_wisk(
    dataset: GeoTextDataset,
    workload: Workload,
    config: Optional[BuildConfig] = None,
    device=None,
) -> BuildArtifacts:
    """Alg. 1 on ``device``: the bank, the partition and the packing trained
    there; raises when CUDA is asked for (the default) and absent."""
    dev = resolve_device(device)
    cfg = config or BuildConfig()
    rng = np.random.default_rng(cfg.seed)
    timings: Dict[str, float] = {}

    train_wl = workload
    if cfg.accelerated and workload.m > 8:
        idx = stratified_sample(workload, cfg.sample_ratio, seed=cfg.seed)
        train_wl = workload.subset(idx)

    t0 = _clock(dev)
    itemsets, members = ([], [])
    if cfg.use_itemsets:
        itemsets, members = mine_frequent_itemsets(
            dataset, min_support=cfg.itemset_min_support, max_size=cfg.itemset_max_size
        )
    timings["itemset_mining"] = _clock(dev) - t0

    t0 = _clock(dev)
    bank = build_cdf_bank(
        dataset,
        itemsets=itemsets,
        itemset_members=members,
        high_thresh=cfg.cdf_high_thresh,
        low_thresh=cfg.cdf_low_thresh,
        n_steps=cfg.cdf_train_steps,
        seed=cfg.seed,
        force_class=cfg.cdf_force_class,
        device=dev,
    )
    timings["cdf_training"] = _clock(dev) - t0

    t0 = _clock(dev)
    q_entries, q_signs = expand_queries(
        train_wl, itemsets, dataset.vocab_size, use_itemsets=cfg.use_itemsets
    )
    part = generate_bottom_clusters(
        dataset, train_wl, bank, q_entries, q_signs, cfg.partition, mode=cfg.construction
    )
    timings["partitioning"] = _clock(dev) - t0

    hierarchy = None
    if cfg.build_hierarchy and part.clusters.k > cfg.packing.min_nodes:
        t0 = _clock(dev)
        # label clusters with (sampled) queries for the packing state
        mq = min(cfg.packing.max_label_queries, train_wl.m)
        sel = rng.choice(train_wl.m, size=mq, replace=False) if train_wl.m > mq else np.arange(train_wl.m)
        lbl_wl = train_wl.subset(np.sort(sel))
        labels = cluster_query_labels(part.clusters, lbl_wl)
        pk = cfg.packing
        if cfg.accelerated:
            pk = dataclasses.replace(pk, spectral_ratio=cfg.cluster_ratio)
        hierarchy = build_hierarchy(labels, part.clusters.mbrs, pk, mode=cfg.construction,
                                    device=dev)
        timings["packing"] = _clock(dev) - t0

    t0 = _clock(dev)
    index = assemble_index(
        dataset,
        part.clusters,
        hierarchy,
        meta=dict(
            n_clusters=part.clusters.k,
            n_itemsets=len(itemsets),
            accelerated=cfg.accelerated,
            cdf_loss=bank.train_loss,
        ),
    )
    timings["assembly"] = _clock(dev) - t0
    timings["total"] = sum(timings.values())
    counters = dict(
        partition_rounds=part.n_rounds,
        partition_dispatches=part.n_dispatches,
        partition_problems=part.n_sgd_calls,
        packing_dispatches=hierarchy.n_dispatches if hierarchy else 0,
        packing_env_steps=hierarchy.n_env_steps if hierarchy else 0,
        construction_dispatches=part.n_dispatches + (hierarchy.n_dispatches if hierarchy else 0),
    )
    return BuildArtifacts(
        index=index,
        bank=bank,
        partition=part,
        hierarchy=hierarchy,
        timings=timings,
        counters=counters,
        itemsets=itemsets,
        train_workload=train_wl,
    )


@full_f32_matmul()
def warm_start_rebuild(
    dataset: GeoTextDataset,
    workload: Workload,
    prev: BuildArtifacts,
    config: Optional[BuildConfig] = None,
    regressed: Optional[np.ndarray] = None,
    regress_ratio: float = 1.5,
    assign: Optional[np.ndarray] = None,
    device=None,
) -> BuildArtifacts:
    """Drift-triggered partial rebuild (DESIGN.md §7), the split learner on
    ``device`` (``cuda`` unless the caller names another; ``prev``'s bank
    moves there).

    Instead of re-running the full Alg. 1 pipeline, reuse everything the
    shift did not invalidate:

    * the **CDF bank and mined itemsets** are pure functions of the dataset
      -- reused verbatim (when ``dataset`` grew via buffered inserts the
      bank is a slightly stale estimator of the grown collection; the
      accept/reject decisions it drives remain sound because both sides of
      Alg. 2 line 10 use the same estimates);
    * the **bottom partition** is re-learned only for leaves whose per-leaf
      Eq.1 verification cost regressed under the observed workload
      (``regressed``: explicit bool mask, or detected by comparing
      ``core.drift.leaf_cost_profile`` between ``prev.train_workload`` and
      ``workload`` at ``regress_ratio``); all other clusters keep their
      learned splits (``core.partition.refine_partition``);
    * the **hierarchy is grafted**, not re-trained: new sub-clusters
      inherit the parent slot of the leaf they refined, upper levels keep
      the DQN-learned packing verbatim, and ``assemble_index`` recomputes
      level MBRs/bitmaps bottom-up. No RL episodes run at all.

    Args:
        dataset: the (possibly grown/tombstoned) object collection -- e.g.
            ``DeltaLog.merged_dataset()``.
        workload: the observed (post-shift) workload to adapt to.
        prev: the artifacts of the build being refreshed.
        config: build config for the refinement (None: ``BuildConfig()``).
        regressed: optional (K,) bool mask of leaves to re-split.
        regress_ratio: detection threshold when ``regressed`` is None.
        assign: (dataset.n,) cluster assignment extending ``prev``'s
            partition over ``dataset`` (required when the dataset grew;
            ``DeltaLog.merged_assignment()`` provides it).
        device: where the split learner runs.

    Returns fresh ``BuildArtifacts`` whose ``counters`` record how much was
    reused (``refined_leaves`` / ``kept_clusters``); ``timings["total"]``
    is the warm build's cost.
    """
    dev = resolve_device(device)
    cfg = config or BuildConfig()
    timings: Dict[str, float] = {}
    bank = prev.bank.to(dev)

    t0 = _clock(dev)
    if assign is None:
        assign = prev.partition.clusters.assign
    if assign.shape[0] != dataset.n:
        raise ValueError(
            f"assignment covers {assign.shape[0]} objects, dataset has {dataset.n}; "
            "pass DeltaLog.merged_assignment() when rebuilding over a grown dataset"
        )
    clusters0 = ClusterSet.from_assignment(dataset, np.asarray(assign, np.int32))
    if regressed is None:
        if prev.train_workload is None:
            raise ValueError("prev.train_workload missing; pass regressed explicitly")
        trained_prof = leaf_cost_profile(dataset, clusters0, prev.train_workload)
        observed_prof = leaf_cost_profile(dataset, clusters0, workload)
        regressed = regressed_leaves(trained_prof, observed_prof, ratio=regress_ratio)
    timings["drift_localization"] = _clock(dev) - t0

    t0 = _clock(dev)
    q_entries, q_signs = expand_queries(
        workload, prev.itemsets, dataset.vocab_size, use_itemsets=cfg.use_itemsets
    )
    refined = refine_partition(
        dataset, workload, bank, q_entries, q_signs,
        clusters0, regressed, cfg.partition, mode=cfg.construction,
    )
    timings["partitioning"] = _clock(dev) - t0

    t0 = _clock(dev)
    hierarchy = graft_hierarchy(prev.hierarchy, refined.source)
    index = assemble_index(
        dataset,
        refined.clusters,
        hierarchy,
        meta=dict(
            n_clusters=refined.clusters.k,
            warm_start=True,
            refined_leaves=refined.n_refined,
            kept_clusters=refined.n_kept,
        ),
    )
    timings["assembly"] = _clock(dev) - t0
    timings["total"] = sum(timings.values())
    counters = dict(
        refined_leaves=refined.n_refined,
        kept_clusters=refined.n_kept,
        partition_problems=refined.n_sgd_calls,
        partition_dispatches=refined.n_dispatches,
        packing_dispatches=0,  # the graft reuses the learned packing
        construction_dispatches=refined.n_dispatches,
    )
    part = PartitionResult(
        clusters=refined.clusters,
        n_splits=refined.n_splits,
        n_sgd_calls=refined.n_sgd_calls,
        history=[],
        n_rounds=0,
        n_dispatches=refined.n_dispatches,
        mode=cfg.construction,
    )
    return BuildArtifacts(
        index=index,
        bank=bank,
        partition=part,
        hierarchy=hierarchy,
        timings=timings,
        counters=counters,
        itemsets=prev.itemsets,
        train_workload=workload,
    )


def graft_hierarchy(
    prev: Optional[HierarchyResult], source: np.ndarray
) -> Optional[HierarchyResult]:
    """Reuse a learned hierarchy across a partial re-partition.

    ``source[c]`` names the previous bottom cluster each new cluster came
    from; every new cluster inherits that leaf's parent slot in the first
    packed level, and all upper levels keep their DQN-learned assignment
    verbatim (``assemble_index`` recomputes the level MBRs/bitmaps, so the
    grafted nodes stay consistent). Refining a leaf therefore only fans out
    its own parent -- the rest of the learned packing is untouched.
    """
    if prev is None or not prev.parents:
        return None
    new_p0 = prev.parents[0][np.asarray(source, np.int64)].astype(np.int32)
    return HierarchyResult(parents=[new_p0, *prev.parents[1:]])


def artifacts_from_reference(
    dataset: GeoTextDataset,
    bank: Dict,
    itemsets: List,
    assign: np.ndarray,
    parents: Optional[List[np.ndarray]],
    train_workload: Optional[Workload],
    device=None,
) -> BuildArtifacts:
    """``BuildArtifacts`` from a JAX-package build as numpy: its bank's
    fields (``cdf.bank_from_reference``), itemsets, the partition's
    ``assign``, the hierarchy's ``parents`` (None: no hierarchy) and the
    training workload -- what ``warm_start_rebuild`` reads, so a reference
    build can be warm-rebuilt by the port."""
    clusters = ClusterSet.from_assignment(dataset, np.asarray(assign, np.int32))
    hierarchy = None if parents is None else HierarchyResult(
        parents=[np.asarray(p) for p in parents])
    part = PartitionResult(clusters=clusters, n_splits=0, n_sgd_calls=0, history=[])
    return BuildArtifacts(
        index=assemble_index(dataset, clusters, hierarchy),
        bank=bank_from_reference(bank, device=device),
        partition=part,
        hierarchy=hierarchy,
        timings={},
        itemsets=list(itemsets),
        train_workload=train_workload,
    )
