"""The benchmark's frozen copy of the port's SKR query generator.

A copy of ``repro_torch/data/workloads.py``'s ``make_workload`` (paper
§7.2) that gives the same arrays for the same dataset and seed. A query
takes a centre object, a square of ``region_frac`` of the space around it
and the centre's keywords, topped up to ``n_keywords`` by Zipf draws
without replacement:

* UNI -- centres uniform over the dataset;
* LAP -- centre index Laplace(n/2, n/10) over the objects in Z order;
* GAU -- Gaussian (n/2, 100) over the same order;
* MIX -- the first half UNI, the second LAP.

The original calls ``Generator.choice(replace=False, p=...)`` once a
query. This copy replays that algorithm on one buffer of uniforms drawn
from the same stream (rounds of ``random(size - found)``, the cdf of the
probabilities with the keywords found so far zeroed, ``searchsorted``
right, first occurrences kept), which gives the same keywords without the
per-call validation of the probabilities.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synth import Dataset, ids_to_bitmap

DISTRIBUTIONS = ("UNI", "LAP", "GAU", "MIX")


@dataclasses.dataclass
class Queries:
    """``rects`` (m, 4) f32 ``(xlo, ylo, xhi, yhi)``, ``kw_ids`` (m, k) i32
    padded with -1, ``kw_bitmap`` (m, W) u32."""

    rects: np.ndarray
    kw_ids: np.ndarray
    kw_bitmap: np.ndarray
    vocab_size: int

    @property
    def m(self) -> int:
        return int(self.rects.shape[0])

    def subset(self, idx) -> "Queries":
        return Queries(self.rects[idx], self.kw_ids[idx], self.kw_bitmap[idx], self.vocab_size)


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


class _Uniforms:
    """The generator's stream of ``random()`` doubles, drawn in blocks: a
    block of N doubles is the same N values as N single draws."""

    def __init__(self, rng: np.random.Generator, block: int) -> None:
        self.rng, self.block = rng, block
        self.buf = np.zeros(0)
        self.pos = 0

    def take(self, k: int) -> np.ndarray:
        if self.pos + k > self.buf.size:
            self.buf = np.concatenate([self.buf[self.pos:], self.rng.random(max(self.block, k))])
            self.pos = 0
        out = self.buf[self.pos : self.pos + k]
        self.pos += k
        return out


def _choice_without_replacement(u: _Uniforms, p: np.ndarray, cdf0: np.ndarray, size: int):
    found = []
    cdf = cdf0
    while len(found) < size:
        x = u.take(size - len(found))
        if found:
            q = p.copy()
            q[found] = 0
            cdf = np.cumsum(q)
            cdf /= cdf[-1]
        for v in cdf.searchsorted(x, side="right").tolist():
            if v not in found:
                found.append(v)
    return found


def make_workload(
    dataset: Dataset,
    m: int = 200,
    dist: str = "MIX",
    region_frac: float = 0.0005,
    n_keywords: int = 5,
    seed: int = 0,
    spatial_order: bool = True,
) -> Queries:
    rng = np.random.default_rng(seed)
    n = dataset.n
    if spatial_order:
        xy = (dataset.locs * 1023).astype(np.int64)
        code = 0
        for b in range(10):
            code = code | (((xy[:, 0] >> b) & 1) << (2 * b)) | (((xy[:, 1] >> b) & 1) << (2 * b + 1))
        order = np.argsort(code)
    else:
        order = np.arange(n)
    centers = order[_centers(dist, n, m, rng)]

    half = np.sqrt(region_frac) / 2
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

    p = np.asarray(dataset.kw_freq / max(dataset.kw_freq.sum(), 1), np.float64)
    cdf0 = np.cumsum(p)
    cdf0 /= cdf0[-1]
    u = _Uniforms(rng, 4 * n_keywords * m)
    kw_ids = np.full((m, n_keywords), -1, dtype=np.int32)
    own_rows = dataset.kw_ids[centers].tolist()
    for i, own in enumerate(own_rows):
        take = [k for k in own if k >= 0][:n_keywords]
        extra = n_keywords - len(take)
        if extra > 0:
            take = take + _choice_without_replacement(u, p, cdf0, extra)
        row = sorted(set(take))
        kw_ids[i, : len(row)] = row
    return Queries(rects, kw_ids, ids_to_bitmap(kw_ids, dataset.vocab_size), dataset.vocab_size)
