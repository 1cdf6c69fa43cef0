"""Plain NumPy reference of a Boolean spatial-keyword range (SKR) query.

An object answers a query when its location lies in the query's closed
rectangle (``xlo <= x <= xhi`` and ``ylo <= y <= yhi``, in float32) and it
holds at least one of the query's keywords; a query with no keyword has no
answer. These are the semantics of the paper's serial traversal (a union of
the query keywords' posting lists, then the rectangle test), written here
as a scan over the objects sorted by x, with no index and nothing taken
from the program.
"""
from __future__ import annotations

from typing import List

import numpy as np


class SkrReference:
    """Answers SKR queries over ``locs`` (n, 2) f32 and ``kw_ids`` (n, k)
    i32 (-1 padded) by brute force over an x-sorted copy."""

    def __init__(self, locs: np.ndarray, kw_ids: np.ndarray) -> None:
        locs = np.asarray(locs, np.float32)
        self.order = np.argsort(locs[:, 0], kind="stable")
        self.xs = locs[self.order, 0]
        self.ys = locs[self.order, 1]
        self.kw = np.asarray(kw_ids, np.int32)[self.order]

    def answer(self, rect, q_kw) -> np.ndarray:
        """Sorted int32 ids of the objects answering one query: ``rect``
        (4,) f32, ``q_kw`` the query's keyword ids (-1 entries ignored)."""
        rect = np.asarray(rect, np.float32)
        q = np.asarray(q_kw)
        q = q[q >= 0]
        if q.size == 0:
            return np.zeros(0, np.int32)
        lo = np.searchsorted(self.xs, rect[0], side="left")
        hi = np.searchsorted(self.xs, rect[2], side="right")
        ys = self.ys[lo:hi]
        inside = lo + np.flatnonzero((ys >= rect[1]) & (ys <= rect[3]))
        hit = np.isin(self.kw[inside], q).any(axis=1)
        return np.sort(self.order[inside[hit]]).astype(np.int32)

    def answers(self, rects: np.ndarray, q_kw: np.ndarray) -> List[np.ndarray]:
        return [self.answer(r, k) for r, k in zip(rects, q_kw)]
