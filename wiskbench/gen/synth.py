"""The benchmark's frozen copy of the port's synthetic geo-textual dataset.

A copy of ``repro_torch/data/synth.py`` (``make_dataset``, the ``osm``
profile and its siblings) that gives the same arrays for the same seed, so
that no change to the program can move the data the benchmark serves. The
per-object keyword loop of the original is vectorised here; the random
draws are the same calls in the same order.

Locations are a mixture of Gaussian hotspots and a uniform background in
the unit square; keywords are Zipf-distributed, and a share of each
object's keywords is drawn near the keyword's topic centres, so keywords
cluster in space.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class SynthConfig:
    n: int = 20_000
    vocab: int = 512
    max_kw: int = 6
    zipf_a: float = 1.2
    n_hotspots: int = 12
    hotspot_frac: float = 0.7
    kw_locality: float = 0.6
    topic_centers_per_kw: int = 2
    seed: int = 0


PROFILES = {
    "fs": SynthConfig(n=20_000, vocab=462, max_kw=2, zipf_a=1.1, n_hotspots=10),
    "sp": SynthConfig(n=30_000, vocab=2048, max_kw=3, zipf_a=1.3, n_hotspots=16),
    "bpd": SynthConfig(n=60_000, vocab=4096, max_kw=5, zipf_a=1.4, n_hotspots=24),
    "osm": SynthConfig(n=120_000, vocab=8192, max_kw=5, zipf_a=1.5, n_hotspots=32),
}


@dataclasses.dataclass
class Dataset:
    """Objects as plain arrays: ``locs`` (n, 2) f32 in the unit square,
    ``kw_ids`` (n, max_kw) i32 padded with -1, ``kw_bitmap`` (n, W) u32,
    ``kw_freq`` (vocab,) i64 objects per keyword."""

    locs: np.ndarray
    kw_ids: np.ndarray
    kw_bitmap: np.ndarray
    vocab_size: int
    kw_freq: np.ndarray

    @property
    def n(self) -> int:
        return int(self.locs.shape[0])

    @property
    def words(self) -> int:
        return int(self.kw_bitmap.shape[1])


def bitmap_words(vocab_size: int) -> int:
    return (vocab_size + 31) // 32


def ids_to_bitmap(kw_ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """(rows, k) id lists padded with -1 to (rows, W) u32 bitmaps. A row's
    ids are distinct, so one column at a time never sets a word twice."""
    bm = np.zeros((kw_ids.shape[0], bitmap_words(vocab_size)), np.uint32)
    for j in range(kw_ids.shape[1]):
        rows = np.flatnonzero(kw_ids[:, j] >= 0)
        ids = kw_ids[rows, j].astype(np.int64)
        bm[rows, ids // 32] |= np.uint32(1) << (ids % 32).astype(np.uint32)
    return bm


def dataset_from_ids(locs: np.ndarray, kw_ids: np.ndarray, vocab_size: int) -> Dataset:
    locs = np.asarray(locs, np.float32)
    kw_ids = np.asarray(kw_ids, np.int32)
    freq = np.bincount(kw_ids[kw_ids >= 0], minlength=vocab_size).astype(np.int64)
    return Dataset(locs, kw_ids, ids_to_bitmap(kw_ids, vocab_size), vocab_size, freq)


def make_dataset(profile: str = "fs", n: Optional[int] = None, seed: int = 0) -> Dataset:
    cfg = dataclasses.replace(PROFILES[profile], seed=seed)
    if n is not None:
        cfg = dataclasses.replace(cfg, n=n)
    return synth_dataset(cfg)


def _zipf_probs(v: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, v + 1) ** a
    return p / p.sum()


def synth_dataset(cfg: SynthConfig) -> Dataset:
    rng = np.random.default_rng(cfg.seed)
    n_hot = int(cfg.n * cfg.hotspot_frac)
    centers = rng.uniform(0.08, 0.92, size=(cfg.n_hotspots, 2))
    scales = rng.uniform(0.01, 0.06, size=(cfg.n_hotspots, 1))
    which = rng.integers(0, cfg.n_hotspots, size=n_hot)
    hot = centers[which] + rng.normal(0, 1, size=(n_hot, 2)) * scales[which]
    bg = rng.uniform(0, 1, size=(cfg.n - n_hot, 2))
    locs = np.clip(np.concatenate([hot, bg], axis=0), 0.0, 1.0).astype(np.float32)
    # shuffling the rows in place draws the same swaps as shuffling their
    # indices; moving the rows once is faster
    perm = np.arange(cfg.n)
    rng.shuffle(perm)
    locs = locs[perm]

    topic_centers = rng.uniform(0, 1, size=(cfg.vocab, cfg.topic_centers_per_kw, 2))
    zipf = _zipf_probs(cfg.vocab, cfg.zipf_a)
    n_kw = rng.integers(1, cfg.max_kw + 1, size=cfg.n)
    total = int(n_kw.sum())
    glob = rng.choice(cfg.vocab, size=total, p=zipf)
    cand = rng.choice(cfg.vocab, size=(cfg.n, 8), p=zipf)
    d = np.linalg.norm(
        topic_centers[cand].reshape(cfg.n, 8 * cfg.topic_centers_per_kw, 2)
        - locs[:, None, :],
        axis=2,
    ).reshape(cfg.n, 8, cfg.topic_centers_per_kw).min(axis=2)
    local_kw = cand[np.arange(cfg.n), d.argmin(axis=1)]
    use_local = rng.uniform(size=total) < cfg.kw_locality

    # object i draws glob[start_i : start_i + n_kw[i]], the local keyword
    # where use_local says so; its row is the sorted distinct draws
    start = np.cumsum(n_kw) - n_kw
    col = np.arange(cfg.max_kw)
    live = col[None, :] < n_kw[:, None]
    pos = np.minimum(start[:, None] + col[None, :], total - 1)
    pad = np.int64(cfg.vocab)  # sorts after every keyword
    draws = np.where(use_local[pos], local_kw[:, None], glob[pos]).astype(np.int64)
    draws = np.sort(np.where(live, draws, pad), axis=1)
    dup = np.zeros_like(live)
    dup[:, 1:] = draws[:, 1:] == draws[:, :-1]
    draws = np.sort(np.where(dup, pad, draws), axis=1)
    kw_ids = np.where(draws == pad, -1, draws).astype(np.int32)
    return dataset_from_ids(locs, kw_ids, cfg.vocab)
