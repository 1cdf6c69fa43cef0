"""Weights carried across from the JAX package: the reference's parameter
values (``state["params"]`` as numpy arrays) as a ``state_dict`` of the
port's model module (``DecoderOnlyLM``, ``EncDecLM`` or ``XLSTMLM``), whole
or, over a mesh of ranks, as this rank's blocks (``to_block``, which
``ckpt/checkpoint.py:restore`` also cuts a whole checkpoint leaf with)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


def _tensor(arr) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")  # owned and writable
    # JAX's bf16 arrays come out of np.asarray as ml_dtypes' bfloat16, which
    # torch.from_numpy refuses: carry the bits through int16
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def to_block(arr, sharding=None) -> torch.Tensor:
    """A whole array (numpy, any dtype JAX writes) as a CPU tensor with its
    dtype and bits: this rank's block of it by ``sharding`` (a
    ``sharding/rules.py`` ``Sharding``; None: the whole array)."""
    arr = np.asarray(arr)
    if sharding is not None:
        arr = arr[sharding.index(arr.shape)]
    return _tensor(arr)


def params_from_reference(values_tree: Dict, prefix: str = "",
                          shardings: Optional[Callable[[str], object]] = None
                          ) -> Dict[str, torch.Tensor]:
    """The nested values dict flattened to ``"dense_blocks.attn.wq"``-style
    keys, each a CPU tensor with the array's dtype and bits; with
    ``shardings`` (a parameter's dotted name -> its ``Sharding``, e.g. a
    model's ``specs`` through ``Steps.placement``), each is this rank's
    block (``to_block``)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in values_tree.items():
        if isinstance(v, dict):
            out.update(params_from_reference(v, f"{prefix}{k}.", shardings))
        else:
            name = f"{prefix}{k}"
            out[name] = to_block(v, None if shardings is None else shardings(name))
    return out
