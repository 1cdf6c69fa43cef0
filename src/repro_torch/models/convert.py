"""Weights carried across from the JAX package: the reference's parameter
values (``state["params"]`` as numpy arrays) as a ``state_dict`` of the
port's model module (``DecoderOnlyLM``, ``EncDecLM`` or ``XLSTMLM``)."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    # JAX's bf16 arrays come out of np.asarray as ml_dtypes' bfloat16, which
    # torch.from_numpy refuses: carry the bits through int16
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_reference(values_tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The nested values dict flattened to ``"dense_blocks.attn.wq"``-style
    keys, each a CPU tensor with the array's dtype and bits."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in values_tree.items():
        if isinstance(v, dict):
            out.update(params_from_reference(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _tensor(v)
    return out
