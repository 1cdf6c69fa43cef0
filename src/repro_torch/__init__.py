"""PyTorch/CUDA port of WISK's single-device SKR serving path.

A second package beside the JAX reference: the same modules
(``core``, ``data``, ``baselines``, ``kernels``, ``serve``, ``launch``),
plain PyTorch on tensors, and hand-written CUDA kernels for Hopper
(``kernels/csrc``) where the reference runs Pallas kernels on a TPU.

Entry points that place data (``serve.snapshot.IndexSnapshot.build`` and
``from_reference_arrays``) run on ``cuda`` unless the caller passes
``device="cpu"``; everything downstream follows the snapshot's device.
"""
from __future__ import annotations

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
