"""The control: the plain reference put in the program's place with the
coordinates stored one precision below the configuration's float32.

A later change that stores the index's coordinates in 16 bits would save
bytes on every level and every leaf; the control shows what that does to
the answers. Object locations and query rectangles or points are rounded
to bfloat16 (round to nearest even: 8 bits of mantissa) or to float16,
and the reference answers from them; its answers come back in the shape
of the port's result dicts, so the harness judges them exactly as it
judges the program's. The check has to find them wrong.
"""
from __future__ import annotations

import numpy as np

from .knn import KnnReference
from .skr import SkrReference


def round_to(a, precision: str) -> np.ndarray:
    """float32 ``a`` rounded to ``"bf16"`` or ``"f16"`` and widened again
    (``"f32"``: unchanged)."""
    a = np.ascontiguousarray(a, np.float32)
    if precision == "f32":
        return a
    if precision == "f16":
        return a.astype(np.float16).astype(np.float32)
    if precision != "bf16":
        raise ValueError(f"unknown precision {precision!r}")
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


class SkrControl:
    def __init__(self, locs, kw_ids, precision: str) -> None:
        self.precision = precision
        self.ref = SkrReference(round_to(locs, precision), kw_ids)

    def serve(self, rects, kw_ids) -> dict:
        answers = self.ref.answers(round_to(rects, self.precision), kw_ids)
        M = len(answers)
        width = max([a.size for a in answers] + [1])
        ids = np.full((M, width), -1, np.int32)
        for i, a in enumerate(answers):
            ids[i, : a.size] = a
        z = np.zeros(M, np.int64)
        counts = np.array([a.size for a in answers], np.int32)
        return dict(ids=ids, counts=counts, overflow=z.astype(np.int32), nodes_checked=z,
                    verified=z.copy())


class KnnControl:
    def __init__(self, locs, kw_ids, precision: str) -> None:
        self.precision = precision
        self.ref = KnnReference(round_to(locs, precision), kw_ids)

    def serve(self, points, kw_ids, k: int) -> dict:
        pts = round_to(points, self.precision)
        M = len(pts)
        ids = np.full((M, k), -1, np.int32)
        d2 = np.full((M, k), np.inf, np.float32)
        for i in range(M):
            a, d = self.ref.answer(pts[i], kw_ids[i], k)
            ids[i, : a.size], d2[i, : d.size] = a, d
        z = np.zeros(M, np.int64)
        return dict(ids=ids, dist2=d2, verified=z, nodes_checked=z.copy(), leaves_verified=z.copy())
