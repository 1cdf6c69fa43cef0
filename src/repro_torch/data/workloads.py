"""SKR query workload generation (paper §7.2).

Queries are generated by sampling a *center object* from the dataset, then a
rectangle of a given area fraction centered on it, then keywords taken from
the center object (topped up from the global keyword set):

* UNI -- centers uniformly sampled from the dataset;
* LAP -- center index from a Laplace distribution (mu=n/2, b=n/10) over the
  dataset ordered by location (spatially skewed);
* GAU -- Gaussian (mu=n/2, sigma=100) -- heavily skewed;
* MIX -- 50/50 UNI + LAP (paper default).

``make_update_stream`` makes live-update traffic for serve/delta.py:
inserts near existing objects. ``stratified_sample`` is construction-time
query sampling (paper §6, ``BuildConfig.accelerated``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.query import _mbr_dist2_f32
from ..core.types import GeoTextDataset, Workload

DISTRIBUTIONS = ("UNI", "LAP", "GAU", "MIX")


def _centers(dist: str, n: int, m: int, rng: np.random.Generator) -> np.ndarray:
    if dist == "UNI":
        return rng.integers(0, n, size=m)
    if dist == "LAP":
        idx = rng.laplace(loc=n / 2, scale=n / 10, size=m)
    elif dist == "GAU":
        idx = rng.normal(loc=n / 2, scale=100.0, size=m)
    elif dist == "MIX":
        half = m // 2
        return np.concatenate([_centers("UNI", n, half, rng), _centers("LAP", n, m - half, rng)])
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.clip(np.round(idx), 0, n - 1).astype(np.int64)


def make_workload(
    dataset: GeoTextDataset,
    m: int = 200,
    dist: str = "MIX",
    region_frac: float = 0.0005,  # paper default region size 0.05% of space
    n_keywords: int = 5,  # paper default
    seed: int = 0,
    spatial_order: bool = True,
) -> Workload:
    rng = np.random.default_rng(seed)
    n = dataset.n
    # order objects by Hilbert-ish (interleaved) spatial order so index-space
    # skew (LAP/GAU over indices) is spatial skew, as in the paper's setup
    if spatial_order:
        xy = (dataset.locs * 1023).astype(np.int64)
        code = 0
        for b in range(10):
            code = code | (((xy[:, 0] >> b) & 1) << (2 * b)) | (((xy[:, 1] >> b) & 1) << (2 * b + 1))
        order = np.argsort(code)
    else:
        order = np.arange(n)
    centers = order[_centers(dist, n, m, rng)]

    side = np.sqrt(region_frac)
    half = side / 2
    c = dataset.locs[centers]
    rects = np.stack(
        [
            np.clip(c[:, 0] - half, 0, 1),
            np.clip(c[:, 1] - half, 0, 1),
            np.clip(c[:, 0] + half, 0, 1),
            np.clip(c[:, 1] + half, 0, 1),
        ],
        axis=1,
    ).astype(np.float32)

    kw_ids = np.full((m, n_keywords), -1, dtype=np.int32)
    zipf_pool = dataset.kw_freq / max(dataset.kw_freq.sum(), 1)
    for i, ci in enumerate(centers):
        own = dataset.kw_ids[ci][dataset.kw_ids[ci] >= 0]
        take = own[:n_keywords]
        kw_ids[i, : take.size] = take
        extra = n_keywords - take.size
        if extra > 0:
            fill = rng.choice(dataset.vocab_size, size=extra, replace=False, p=zipf_pool)
            kw_ids[i, take.size : take.size + extra] = fill
        row = np.unique(kw_ids[i][kw_ids[i] >= 0])
        kw_ids[i, :] = -1
        kw_ids[i, : row.size] = row
    return Workload.from_ids(rects, kw_ids, dataset.vocab_size)


def make_update_stream(
    dataset: GeoTextDataset,
    n: int,
    rng: np.random.Generator,
    jitter: float,
    leaf_mbrs: Optional[np.ndarray] = None,
    leaf_terms: Optional[np.ndarray] = None,
):
    """``(locs, kw_ids)`` of ``n`` inserts: random objects' locations moved
    by N(0, ``jitter``), clipped to the unit square, each with its source
    object's keywords -- a new shop near an old one, a repost. With
    ``leaf_mbrs``/``leaf_terms`` (an index's leaf MBRs and a snapshot's
    leaf dictionaries) each insert instead carries as many terms as its
    source, drawn from the dictionary of the leaf ``DeltaLog.insert`` will
    route it to (the same argmin), so every buffered term stays inside its
    leaf's vocabulary and the delta keeps its compact insert slots."""
    src = rng.choice(dataset.n, n)
    locs = np.clip(dataset.locs[src] + rng.normal(0, jitter, (n, 2)), 0, 1).astype(np.float32)
    kw = dataset.kw_ids[src].copy()
    if leaf_terms is not None:
        leaf = np.argmin(_mbr_dist2_f32(leaf_mbrs[None], locs[:, None]), axis=1)
        for i, lf in enumerate(leaf):
            terms = leaf_terms[lf][leaf_terms[lf] >= 0]
            k = min(max(int((kw[i] >= 0).sum()), 1), terms.size)
            kw[i] = -1
            kw[i, :k] = rng.choice(terms, k, replace=False)
    return locs, kw


def stratified_sample(workload: Workload, ratio: float, seed: int = 0, n_strata: int = 8) -> np.ndarray:
    """Stratified query sampling (paper §6): stratify by query-center cell so
    the sample preserves the spatial distribution of the workload."""
    rng = np.random.default_rng(seed)
    m = workload.m
    cx = (workload.rects[:, 0] + workload.rects[:, 2]) / 2
    cy = (workload.rects[:, 1] + workload.rects[:, 3]) / 2
    gx = np.minimum((cx * np.sqrt(n_strata)).astype(int), int(np.sqrt(n_strata)) - 1)
    gy = np.minimum((cy * np.sqrt(n_strata)).astype(int), int(np.sqrt(n_strata)) - 1)
    strata = gx * int(np.sqrt(n_strata)) + gy
    keep = []
    for s in np.unique(strata):
        ids = np.nonzero(strata == s)[0]
        k = max(1, int(round(ids.size * ratio)))
        keep.append(rng.choice(ids, size=k, replace=False))
    return np.sort(np.concatenate(keep))
