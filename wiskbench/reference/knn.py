"""Plain NumPy reference of a Boolean k-nearest-neighbour query.

The answer is the k objects holding at least one query keyword that lie
nearest the query point, ascending by squared distance and, at equal
distance, by object id (the smaller id first); fewer than k when fewer
objects match, none for a query with no keyword. The squared distance is
float32, computed operation by operation as ``dx * dx + dy * dy`` with
``dx = x - px`` and ``dy = y - py``, the arithmetic the paper's best-first
search defines.

The search scans a uniform grid over the unit square outward from the
query's cell, in square blocks that double in radius, and stops once the
k-th best distance lies strictly inside the block: every object outside
it is farther. Nothing is taken from the program.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


class KnnReference:
    """Boolean kNN over ``locs`` (n, 2) f32 and ``kw_ids`` (n, k) i32 (-1
    padded), by a scan of grid cells around the query point."""

    def __init__(self, locs: np.ndarray, kw_ids: np.ndarray, grid: int = 256) -> None:
        locs = np.asarray(locs, np.float32)
        self.g = int(grid)
        cx = np.clip((locs[:, 0].astype(np.float64) * self.g).astype(np.int64), 0, self.g - 1)
        cy = np.clip((locs[:, 1].astype(np.float64) * self.g).astype(np.int64), 0, self.g - 1)
        cell = cy * self.g + cx  # row-major, so a row of cells is one slice
        self.order = np.argsort(cell, kind="stable")
        self.start = np.searchsorted(cell[self.order], np.arange(self.g * self.g + 1))
        self.x = locs[self.order, 0]
        self.y = locs[self.order, 1]
        self.kw = np.asarray(kw_ids, np.int32)[self.order]

    def _block(self, x0: int, x1: int, y0: int, y1: int) -> np.ndarray:
        rows = [np.arange(self.start[y * self.g + x0], self.start[y * self.g + x1 + 1])
                for y in range(y0, y1 + 1)]
        return np.concatenate(rows)

    def answer(self, point, q_kw, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(ids int32, dist2 float32)`` of one query, ascending by
        (dist2, id), at most ``k`` long."""
        q = np.asarray(q_kw)
        q = q[q >= 0]
        if q.size == 0 or k <= 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        px, py = np.float32(point[0]), np.float32(point[1])
        g = self.g
        cx = min(max(int(np.float64(px) * g), 0), g - 1)
        cy = min(max(int(np.float64(py) * g), 0), g - 1)
        r = 0
        while True:
            x0, x1 = max(cx - r, 0), min(cx + r, g - 1)
            y0, y1 = max(cy - r, 0), min(cy + r, g - 1)
            rows = self._block(x0, x1, y0, y1)
            rows = rows[np.isin(self.kw[rows], q).any(axis=1)]
            dx = self.x[rows] - px
            dy = self.y[rows] - py
            d2 = dx * dx + dy * dy
            ids = self.order[rows]
            keep = np.lexsort((ids, d2))[:k]
            ids, d2 = ids[keep], d2[keep]
            whole = x0 == 0 and y0 == 0 and x1 == g - 1 and y1 == g - 1
            if whole:
                break
            if ids.size == k:
                # the nearest point outside the block, on a side that has one
                gaps = [np.float64(px) - x0 / g if x0 > 0 else np.inf,
                        (x1 + 1) / g - np.float64(px) if x1 < g - 1 else np.inf,
                        np.float64(py) - y0 / g if y0 > 0 else np.inf,
                        (y1 + 1) / g - np.float64(py) if y1 < g - 1 else np.inf]
                gap = max(min(gaps), 0.0)
                if gap * gap > np.float64(d2[-1]) * (1 + 1e-6) + 1e-30:
                    break
            r = 2 * r + 1
        return ids.astype(np.int32), d2.astype(np.float32)
