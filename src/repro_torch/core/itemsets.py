"""Frequent keyword itemset mining + multi-keyword count correction (§6).

The paper mines frequent keyword sets (FP-Tree) and learns CDF models for
them so that multi-keyword queries do not over-count objects containing
several query keywords. At our (synthetic, laptop-scale) vocabulary sizes a
vectorized Apriori over the object-keyword incidence produces identical
output (all itemsets with support >= min_support); we mine up to
``max_size`` and correct estimates by truncated inclusion-exclusion:

    |O(q)| ~= sum_k |O_k ∩ rect|  -  sum_{(a,b) ⊆ q, (a,b) frequent} |O_ab ∩ rect|

Higher-order frequent itemsets are still mined and exposed (the bank learns
their CDFs; benchmarks report their effect) but the default correction uses
pairs, which removes the bulk of the redundancy (Fig. 20's mechanism).

A numpy copy of the JAX package's ``core/itemsets.py``; the port keeps its
own so it never imports that package.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .types import GeoTextDataset, Workload


def mine_frequent_itemsets(
    dataset: GeoTextDataset,
    min_support: float = 1e-5,
    max_size: int = 3,
    max_itemsets: int = 4096,
) -> Tuple[List[Tuple[int, ...]], List[np.ndarray]]:
    """Apriori over the keyword incidence. Returns (itemsets, member object ids)
    for itemsets of size >= 2 (singletons are the base CDF entries)."""
    n = dataset.n
    min_count = max(2, int(np.ceil(min_support * n)))

    # keyword -> member rows (sorted)
    rows, cols = np.nonzero(dataset.kw_ids >= 0)
    ids = dataset.kw_ids[rows, cols]
    order = np.argsort(ids, kind="stable")
    ids_s, rows_s = ids[order], rows[order]
    uk, start = np.unique(ids_s, return_index=True)
    bounds = np.append(start, ids_s.size)
    members: Dict[Tuple[int, ...], np.ndarray] = {}
    frequent_1 = []
    for j, k in enumerate(uk):
        mem = np.sort(rows_s[bounds[j] : bounds[j + 1]])
        if mem.size >= min_count:
            frequent_1.append(int(k))
            members[(int(k),)] = mem

    itemsets: List[Tuple[int, ...]] = []
    out_members: List[np.ndarray] = []
    prev_level: List[Tuple[int, ...]] = [(k,) for k in frequent_1]
    for size in range(2, max_size + 1):
        cur: List[Tuple[int, ...]] = []
        prev_set = set(prev_level)
        # candidate generation: join prev-level sets sharing a (size-2)-prefix
        for i in range(len(prev_level)):
            for j in range(i + 1, len(prev_level)):
                a, b = prev_level[i], prev_level[j]
                if a[:-1] != b[:-1]:
                    continue
                cand = tuple(sorted(set(a) | set(b)))
                if len(cand) != size or cand in members:
                    continue
                # prune: all (size-1)-subsets must be frequent
                ok = all(cand[:t] + cand[t + 1 :] in prev_set for t in range(size))
                if not ok:
                    continue
                inter = np.intersect1d(members[a], members[b], assume_unique=True)
                if inter.size >= min_count:
                    members[cand] = inter
                    cur.append(cand)
                    itemsets.append(cand)
                    out_members.append(inter)
                    if len(itemsets) >= max_itemsets:
                        return itemsets, out_members
        prev_level = cur
        if not cur:
            break
    return itemsets, out_members


def expand_queries(
    workload: Workload,
    itemsets: List[Tuple[int, ...]],
    vocab_size: int,
    use_itemsets: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query CDF-entry expansion with inclusion-exclusion signs.

    Returns (entries (m, E) int32 padded -1, signs (m, E) float32). Entry ids
    >= vocab_size refer to itemset slots (vocab_size + itemset_index).
    """
    pair_index: Dict[Tuple[int, int], int] = {}
    if use_itemsets:
        for idx, s in enumerate(itemsets):
            if len(s) == 2:
                pair_index[(s[0], s[1])] = vocab_size + idx

    m = workload.m
    ent_rows: List[List[int]] = []
    sign_rows: List[List[float]] = []
    for qi in range(m):
        kws = [int(k) for k in workload.kw_ids[qi] if k >= 0]
        ents = list(kws)
        sgns = [1.0] * len(kws)
        if use_itemsets:
            for i in range(len(kws)):
                for j in range(i + 1, len(kws)):
                    a, b = sorted((kws[i], kws[j]))
                    slot = pair_index.get((a, b))
                    if slot is not None:
                        ents.append(slot)
                        sgns.append(-1.0)
        ent_rows.append(ents)
        sign_rows.append(sgns)
    E = max(1, max(len(r) for r in ent_rows) if ent_rows else 1)
    entries = np.full((m, E), -1, dtype=np.int32)
    signs = np.zeros((m, E), dtype=np.float32)
    for qi, (er, sr) in enumerate(zip(ent_rows, sign_rows)):
        entries[qi, : len(er)] = er
        signs[qi, : len(sr)] = sr
    return entries, signs
