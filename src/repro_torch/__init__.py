"""PyTorch/CUDA port of WISK: index construction, and serving on one device or several ranks.

A second package beside the JAX reference: the same modules
(``core``, ``data``, ``baselines``, ``kernels``, ``serve``, ``launch``),
plain PyTorch on tensors, and hand-written CUDA kernels for Hopper
(``kernels/csrc``) where the reference runs Pallas kernels on a TPU.

Construction (``core.build.build_wisk`` and ``warm_start_rebuild``: the CDF
bank, learned split partitioning, DQN packing) trains on the device with
autograd; serving (SKR in both modes, Boolean kNN, live deltas, standing
subscriptions) runs on the CUDA kernels; ``launch.wisk_serve.LiveIndex``
ties them together as the live front door (updates, geofences, drift
detection, a warm rebuild and an atomic generation swap). Several
``torch.distributed`` ranks serve one batch together over a serving mesh
(``launch/mesh.py``): query-parallel with the snapshot replicated, or
index-parallel over a ``serve.snapshot.PartitionedSnapshot`` (the
front doors in ``launch/wisk_serve.py``). The baselines
(``baselines.conventional``, ``baselines.learned``) are host numpy. Entry
points that place data (``build_wisk``, ``warm_start_rebuild``,
``serve.snapshot.IndexSnapshot.build`` and ``from_reference_arrays``,
``serve.subscribe.SubscriptionIndex``, ``LiveIndex``) run on ``cuda``
unless the caller passes ``device="cpu"``; everything downstream follows
their device.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no CUDA device is present -- the port never drifts onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the host"
        )
    return dev


@contextlib.contextmanager
def full_f32_matmul():
    """Matrix products in full float32 on the card (no TF32) while inside;
    the caller's setting comes back afterwards. Also a decorator."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
