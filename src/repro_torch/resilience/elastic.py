"""Elastic scaling: the JAX package's ``resilience/elastic.py``.

``plan_remesh(n_devices)`` picks the largest (data, model) grid that fits
the surviving devices while keeping the model-parallel degree where
possible (changing it would change head and expert shard divisibility);
the checkpoint layer then restores the latest step onto the plan's mesh
(``ckpt/checkpoint.py:restore(..., shardings=)`` with the new mesh's
``Steps.state_shardings``): train on ``(2, 2)``, ``plan_remesh(2)``,
restore on ``(1, 2)``. The deterministic token pipeline skips to
``global_step * global_batch`` examples, so a restart sees the batches it
would have seen.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..launch.mesh import ServingMesh, make_host_mesh


@dataclasses.dataclass
class RemeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_devices: int

    def make_mesh(self, device=None) -> Optional[ServingMesh]:
        """The plan's ``("data", "model")`` mesh over the first ``data *
        model`` ranks of the started process group
        (``launch/mesh.py:make_host_mesh``, which clamps to the ranks
        there are), on ``device`` (``cuda`` unless the caller names
        another). Every rank of the group calls it; a rank the plan drops
        gets None."""
        return make_host_mesh(*self.shape, device=device, first=True)


def plan_remesh(n_devices: int, prefer_model: int = 16) -> RemeshPlan:
    """The largest usable (data, model) grid of at most ``n_devices``, the
    model degree the power of two at most ``prefer_model`` that drops the
    fewest devices."""
    best = (None, None)
    m = prefer_model
    while m >= 1:
        if n_devices >= m:
            drop = n_devices - (n_devices // m) * m
            if best[0] is None or drop < best[0]:
                best = (drop, m)
        m //= 2
    model = best[1] or 1
    data = n_devices // model
    # the ragged remainder is dropped (it rejoins at the next restart)
    used = data * model
    return RemeshPlan(shape=(data, model), axes=("data", "model"), dropped_devices=n_devices - used)


def data_skip_offset(global_step: int, global_batch: int) -> int:
    """Where the deterministic pipeline resumes after a restart, in examples."""
    return global_step * global_batch
