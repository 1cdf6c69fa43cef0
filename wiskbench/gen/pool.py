"""A traffic mix's pool of query batches, made from the run's seed.

``pool_batches * batch`` queries come from the frozen query generator on
one stream of the seed; a second stream shuffles them, so that every batch
mixes the distribution's parts (MIX draws its UNI half first and its LAP
half second) and a window that covers part of the pool sees the whole mix.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .workloads import Queries, make_workload


def sub_seed(seed: int, stream: int) -> int:
    """An independent seed for one use of a run's ``--seed``."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0])


def make_pool(traffic: dict, data, seed: int) -> List[Queries]:
    B, P = int(traffic["batch"]), int(traffic["pool_batches"])
    q = make_workload(data, m=B * P, dist=traffic["dist"], region_frac=float(traffic["region_frac"]),
                      n_keywords=int(traffic["n_keywords"]), seed=sub_seed(seed, 1))
    q = q.subset(np.random.default_rng(sub_seed(seed, 2)).permutation(q.m))
    return [q.subset(slice(b * B, (b + 1) * B)) for b in range(P)]
