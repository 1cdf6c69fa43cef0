"""Model assembly for the decoder-only dense families (``dense``, and
``vlm``, which prepends stub patch embeddings): init, the training loss,
prefill and KV-cache decode -- the JAX package's ``models/model.py`` for
these families.

A model is a ``DecoderOnlyLM``: an ``nn.Module`` whose parameters sit
under the reference's tree paths (``embed.table``, ``head.w``,
``final_norm``, ``dense_blocks.attn.wq``, ...), the layer stack with a
leading ``layers`` dimension, each parameter's logical spec kept beside it
in ``specs``. Where the reference scans over the stack, the port loops
over layers in Python; where it wraps the scan body in ``jax.checkpoint``
(``cfg.remat == "full"``), the port wraps each layer in
``torch.utils.checkpoint``. ``ModelBundle``'s functions keep the
reference's names and wrap the module. The parameters are registered
without gradients; the training steps turn them on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..tree import module_tree
from . import layers as L
from .layers import Param, split_params

# the families other slices port, and the ROADMAP item that ports each
UNPORTED_FAMILIES = {
    "moe": "A.13c (MoE)",
    "mla_moe": "A.13d (MLA + MoE + MTP)",
    "encdec": "A.13e (enc-dec)",
    "xlstm": "A.13f (xLSTM)",
    "hybrid": "A.13g (hybrid)",
}


# ----------------------------------------------------------------- helpers
def stack_init(init_fn: Callable, n: int, axis_name: str = "layers"):
    """``n`` independent inits stacked into one Param tree with a leading
    ``axis_name`` dimension. Each layer is written into the stack as it is
    drawn, so only one layer's temporaries exist at a time."""
    first = init_fn()
    stacked = L.tree_map(lambda p: Param(
        torch.empty((n,) + tuple(p.value.shape), dtype=p.value.dtype, device=p.value.device),
        (axis_name,) + tuple(p.spec)), first)

    def put(dst, src, i):
        if L.is_param(src):
            dst.value[i].copy_(src.value)
            return
        for k in src:
            put(dst[k], src[k], i)

    put(stacked, first, 0)
    del first
    for i in range(1, n):
        put(stacked, init_fn(), i)
    return stacked


def _norm(w, x):
    return L.rms_norm(x, w)


def _init_block(gen, cfg: ArchConfig, device=None):
    """A dense block: the reference's ``_init_block(kind="dense")``."""
    return dict(
        ln1=L.ones((cfg.d_model,), ("embed",), device=device or gen.device),
        ln2=L.ones((cfg.d_model,), ("embed",), device=device or gen.device),
        attn=L.init_attention(gen, cfg, device),
        ffn=L.init_ffn(gen, cfg, device=device),
    )


def _apply_block(p, x, cfg: ArchConfig):
    x = x + L.attention(p["attn"], _norm(p["ln1"], x), cfg)
    return x + L.ffn(p["ffn"], _norm(p["ln2"], x))


def _decode_block(p, x, cache_k, cache_v, pos, cfg):
    a, ck, cv = L.decode_attention(p["attn"], _norm(p["ln1"], x), cache_k, cache_v, pos, cfg)
    x = x + a
    return x + L.ffn(p["ffn"], _norm(p["ln2"], x)), ck, cv


# ------------------------------------------------------------------ module
def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class _Node(nn.Module):
    """A plain container: one level of the parameter tree."""


class DecoderOnlyLM(nn.Module):
    """The dense / vlm decoder-only model, its parameters under the
    reference's tree paths. ``tree`` is a Param tree (``bundle.init_tree``'s)."""

    def __init__(self, cfg: ArchConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        values, spec_tree = split_params(tree)
        self.specs: Dict[str, tuple] = dict(_flatten(spec_tree))
        for name, value in _flatten(values):
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, _Node())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict:
        """The parameters as the reference's nested values dict."""
        return module_tree(self)

    def _layers(self):
        """Each layer's parameters: views of the stack at its index. One
        ``unbind`` a leaf, so the backward stacks the layers' gradients
        once instead of adding a stack-sized gradient per layer."""
        blocks = self.tree()["dense_blocks"]
        per_leaf = _unbind(blocks)
        return [_index(per_leaf, i) for i in range(self.cfg.n_layers)]

    def embed_inputs(self, batch: Dict):
        """The embedded inputs and where the text region starts (the
        patches' count for ``vlm``, else 0)."""
        x = L.embed_lookup(dict(table=self.embed.table), batch["tokens"])
        loss_start = 0
        if self.cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
            loss_start = batch["patches"].shape[1]
        return x, loss_start

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        # remat only where a backward will run: serving keeps no activations
        remat = self.cfg.remat == "full" and torch.is_grad_enabled()
        for lp in self._layers():
            if remat:
                x = checkpoint(_apply_block, lp, x, self.cfg, use_reentrant=False)
            else:
                x = _apply_block(lp, x, self.cfg)
        return x

    def loss(self, batch: Dict) -> torch.Tensor:
        """The mean next-token cross entropy (0-d f32). For ``vlm`` with
        patches, over the text region only: the final norm and the head see
        ``x[:, loss_start:]``, as the reference. (The MTP term is the
        ``mla_moe`` family's, ROADMAP A.13d.)"""
        x, loss_start = self.embed_inputs(batch)
        x = self.backbone(x)
        if loss_start:
            h = _norm(self.final_norm, x[:, loss_start:])
            logits = L.lm_logits(dict(w=self.head.w), h)
            return L.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:])
        return _lm_losses(self, x, batch["tokens"])

    def prefill(self, batch: Dict) -> torch.Tensor:
        """The last position's logits (B, 1, vocab); fills no cache."""
        x = self.backbone(self.embed_inputs(batch)[0])
        h = _norm(self.final_norm, x[:, -1:])
        return L.lm_logits(dict(w=self.head.w), h)

    def decode(self, cache: Dict, tokens: torch.Tensor, pos: torch.Tensor):
        """One token per row at position ``pos`` (a 0-d tensor): logits
        (B, 1, vocab) and the cache, written in place."""
        x = L.embed_lookup(dict(table=self.embed.table), tokens)
        for i, lp in enumerate(self._layers()):
            x, _, _ = _decode_block(lp, x, cache["k"][i], cache["v"][i], pos, self.cfg)
        h = _norm(self.final_norm, x)
        return L.lm_logits(dict(w=self.head.w), h), cache


def _lm_losses(model: DecoderOnlyLM, x, tokens):
    logits = L.lm_logits(dict(w=model.head.w), _norm(model.final_norm, x))
    return L.softmax_xent(logits[:, :-1], tokens[:, 1:])


def _unbind(v):
    if isinstance(v, dict):
        return {k: _unbind(u) for k, u in v.items()}
    return torch.unbind(v, 0)


def _index(v, i):
    if isinstance(v, dict):
        return {k: _index(u, i) for k, u in v.items()}
    return v[i]


# ---------------------------------------------------------------- Bundle
@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable  # (generator, device=None) -> DecoderOnlyLM
    init_tree: Callable  # (generator, device=None) -> Param tree (``meta``: specs alone)
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> logits of the last position
    decode: Callable  # (params, cache, tokens, pos) -> (logits, cache)
    cache_shape: Callable  # (batch, seq) -> {name: (shape, dtype, logical names)}


def build_decoder_only(cfg: ArchConfig) -> ModelBundle:
    """The ``dense`` and ``vlm`` families."""

    def init_tree(gen: torch.Generator, device=None) -> Dict:
        dev = device or gen.device
        return dict(
            embed=L.init_embedding(gen, cfg, device),
            head=L.init_lm_head(gen, cfg, device),
            final_norm=L.ones((cfg.d_model,), ("embed",), device=dev),
            dense_blocks=stack_init(lambda: _init_block(gen, cfg, device), cfg.n_layers),
        )

    def init(gen: torch.Generator, device=None) -> DecoderOnlyLM:
        """Parameters drawn from ``gen`` on its device, then moved to
        ``device`` (default: the generator's)."""
        model = DecoderOnlyLM(cfg, init_tree(gen))
        return model if device is None else model.to(device)

    def cache_shape(batch: int, seq: int):
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        # bf16 whatever the model's dtype, as the reference
        return dict(k=(shape, torch.bfloat16, names), v=(shape, torch.bfloat16, names))

    def loss(params: DecoderOnlyLM, batch: Dict) -> torch.Tensor:
        return params.loss(batch)

    def prefill(params: DecoderOnlyLM, batch: Dict) -> torch.Tensor:
        return params.prefill(batch)

    def decode(params: DecoderOnlyLM, cache: Dict, tokens, pos):
        return params.decode(cache, tokens, pos)

    return ModelBundle(cfg, init, init_tree, loss, prefill, decode, cache_shape)


# ---------------------------------------------------------------- factory
def build_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family in ("dense", "vlm"):
        return build_decoder_only(cfg)
    if cfg.family in UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP {UNPORTED_FAMILIES[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family}")
