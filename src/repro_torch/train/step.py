"""The serving half of the JAX package's ``train/step.py``: ``build_steps``
returns a ``Steps`` object with the model, its device, ``init_state``,
``prefill_step`` and ``decode_step``, and the abstract batch and cache of a
shape. ``train_step``, the optimizer state and its specs and the schedule
come with the training port (ROADMAP A.13b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.layers import split_params
from ..models.model import ModelBundle, build_model


class ShapeDtype(NamedTuple):
    """An abstract tensor: the port's ``jax.ShapeDtypeStruct``."""
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass
class Steps:
    cfg: ArchConfig
    bundle: ModelBundle
    device: torch.device

    init_state: Callable  # generator -> {"params": DecoderOnlyLM, "step": int32 0-d}
    prefill_step: Callable  # (params, batch) -> logits of the last position
    decode_step: Callable  # (params, cache, tokens, pos) -> (logits, cache)

    param_specs: Any  # logical-name tree mirroring the parameters

    def batch_spec(self, kind: str, seq: int, batch: int):
        """(abstract batch dict, logical specs) for a shape kind."""
        cfg = self.cfg
        if cfg.family == "vlm":
            P_ = min(cfg.n_patches, max(seq // 4, 16))
            b = dict(patches=ShapeDtype((batch, P_, cfg.d_model), torch.bfloat16),
                     tokens=ShapeDtype((batch, max(seq - P_, 8)), torch.int32))
            s = dict(patches=("batch", None, None), tokens=("batch", None))
        else:
            b = dict(tokens=ShapeDtype((batch, seq), torch.int32))
            s = dict(tokens=("batch", None))
        return b, s

    def cache_spec(self, batch: int, seq: int, long_ctx: bool = False):
        """(abstract cache dict, logical specs). ``long_ctx`` names the
        sequence dim over every mesh axis and replicates batch (batch=1)."""
        sds, specs = {}, {}
        for k, (shape, dtype, names) in self.bundle.cache_shape(batch, seq).items():
            names = tuple(names)
            if long_ctx:
                names = tuple("kv_seq_all" if n == "kv_seq" else (None if n == "batch" else n)
                              for n in names)
            sds[k] = ShapeDtype(tuple(shape), dtype)
            specs[k] = names
        return sds, specs

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_spec(batch, seq)`` on the steps' device."""
        sds, _ = self.cache_spec(batch, seq)
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=self.device)
                for k, s in sds.items()}


def build_steps(cfg: ArchConfig, device=None) -> Steps:
    """The serving steps of ``cfg``'s model on ``device`` (``cuda`` unless
    the caller passes another; raises when CUDA is absent)."""
    dev = resolve_device(device)
    bundle = build_model(cfg)
    # the specs from an init on the meta device: shapes only, nothing drawn
    _, pspecs = split_params(bundle.init_tree(torch.Generator(), device="meta"))

    def init_state(gen: torch.Generator) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` (on its own device), on the steps'
        device, and the step count."""
        return dict(params=bundle.init(gen, dev),
                    step=torch.zeros((), dtype=torch.int32, device=dev))

    @torch.no_grad()
    def prefill_step(params, batch):
        return bundle.prefill(params, batch)

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos):
        return bundle.decode(params, cache, tokens, pos)

    return Steps(cfg=cfg, bundle=bundle, device=dev, init_state=init_state,
                 prefill_step=prefill_step, decode_step=decode_step, param_specs=pspecs)
