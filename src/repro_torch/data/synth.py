"""Synthetic geo-textual dataset generators.

Real datasets in the paper (FS/SP/BPD/OSM) are POI collections whose
keywords are Zipf-distributed and spatially correlated (restaurants cluster
downtown, trailheads in parks). We reproduce those statistics at laptop
scale:

* locations: mixture of 2-D Gaussians (hotspots) + uniform background;
* keywords: Zipf frequencies over a vocabulary ``V``; each keyword has a
  set of "topic centers" so its objects concentrate spatially -- this is
  what makes workload-aware layouts beat purely spatial ones (paper Fig. 2).

``make_dataset(profile)`` provides FS/SP/BPD/OSM-like presets (scaled).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..core.types import GeoTextDataset


@dataclasses.dataclass
class SynthConfig:
    n: int = 20_000
    vocab: int = 512
    max_kw: int = 6
    zipf_a: float = 1.2
    n_hotspots: int = 12
    hotspot_frac: float = 0.7  # fraction of objects in spatial hotspots
    kw_locality: float = 0.6  # prob a keyword is drawn from the local topic
    topic_centers_per_kw: int = 2
    seed: int = 0


PROFILES = {
    # scaled stand-ins for the paper's datasets (Table 1 ratios preserved-ish)
    "fs": SynthConfig(n=20_000, vocab=462, max_kw=2, zipf_a=1.1, n_hotspots=10),
    "sp": SynthConfig(n=30_000, vocab=2048, max_kw=3, zipf_a=1.3, n_hotspots=16),
    "bpd": SynthConfig(n=60_000, vocab=4096, max_kw=5, zipf_a=1.4, n_hotspots=24),
    "osm": SynthConfig(n=120_000, vocab=8192, max_kw=5, zipf_a=1.5, n_hotspots=32),
}


def make_dataset(profile: str = "fs", n: Optional[int] = None, seed: int = 0) -> GeoTextDataset:
    cfg = dataclasses.replace(PROFILES[profile], seed=seed)
    if n is not None:
        cfg = dataclasses.replace(cfg, n=n)
    return synth_dataset(cfg)


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def synth_dataset(cfg: SynthConfig) -> GeoTextDataset:
    rng = np.random.default_rng(cfg.seed)
    # --- locations ---
    n_hot = int(cfg.n * cfg.hotspot_frac)
    centers = rng.uniform(0.08, 0.92, size=(cfg.n_hotspots, 2))
    scales = rng.uniform(0.01, 0.06, size=(cfg.n_hotspots, 1))
    which = rng.integers(0, cfg.n_hotspots, size=n_hot)
    hot = centers[which] + rng.normal(0, 1, size=(n_hot, 2)) * scales[which]
    bg = rng.uniform(0, 1, size=(cfg.n - n_hot, 2))
    locs = np.clip(np.concatenate([hot, bg], axis=0), 0.0, 1.0).astype(np.float32)
    rng.shuffle(locs)

    # --- keyword topic fields ---
    topic_centers = rng.uniform(0, 1, size=(cfg.vocab, cfg.topic_centers_per_kw, 2))
    zipf = _zipf_probs(cfg.vocab, cfg.zipf_a)

    n_kw = rng.integers(1, cfg.max_kw + 1, size=cfg.n)
    kw_ids = np.full((cfg.n, cfg.max_kw), -1, dtype=np.int32)

    # global draws (vectorized) then local overrides
    total = int(n_kw.sum())
    glob = rng.choice(cfg.vocab, size=total, p=zipf)
    # local keyword per object: keyword whose topic center is nearest among a
    # random zipf-weighted candidate set (cheap approximation of locality)
    cand = rng.choice(cfg.vocab, size=(cfg.n, 8), p=zipf)
    d = np.linalg.norm(
        topic_centers[cand].reshape(cfg.n, 8 * cfg.topic_centers_per_kw, 2)
        - locs[:, None, :],
        axis=2,
    ).reshape(cfg.n, 8, cfg.topic_centers_per_kw).min(axis=2)
    local_kw = cand[np.arange(cfg.n), d.argmin(axis=1)]

    pos = 0
    use_local = rng.uniform(size=total) < cfg.kw_locality
    for i in range(cfg.n):
        k = int(n_kw[i])
        draws = glob[pos : pos + k].copy()
        draws[use_local[pos : pos + k]] = local_kw[i]
        uniq = np.unique(draws)[: cfg.max_kw]
        kw_ids[i, : uniq.size] = uniq
        pos += k

    return GeoTextDataset.from_ids(locs, kw_ids, cfg.vocab)
