"""Gradient compression for the data-parallel reduction: top-k
sparsification with error feedback, and int8 quantization with a
per-tensor scale -- the JAX package's ``optim/compression.py``.

Both transform the gradient tree before the reduction; error feedback
carries what compression dropped into the next step, so the scheme stays
convergent. ``torch.topk`` with the ``>=`` threshold keeps ties, as
``lax.top_k`` does there, and ``torch.round`` rounds half to even, as
``jnp.round``: both functions give the reference's bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any  # same structure as the gradients, f32


def ef_init(grads_template: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template))


def topk_compress(g: torch.Tensor, frac: float) -> torch.Tensor:
    """The top ``frac`` of the entries by magnitude (the rest zeroed), in f32."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat, 0.0)
    return kept.reshape(g.shape)


def topk_with_error_feedback(grads: Any, ef: EFState, frac: float = 0.1) -> Tuple[Any, EFState]:
    """Each leaf plus its residual, top-k compressed (in the leaf's dtype);
    the new residual is what the compression dropped (f32)."""
    comp, res = [], []
    for g, r in zip(leaves(grads), leaves(ef.residual)):
        acc = g.float() + r
        c = topk_compress(acc, frac)
        comp.append(c.to(g.dtype))
        res.append(acc - c)
    return unflatten(grads, comp), EFState(residual=unflatten(ef.residual, res))


def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # the divisor as a tensor on g's device: CUDA divides by a host scalar
    # as a product with its reciprocal, which can round otherwise
    top = torch.clamp(torch.max(torch.abs(g.float())), min=1e-12)
    scale = top / torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_tree_roundtrip(grads: Any) -> Any:
    """Quantize and dequantize every leaf: what the compressed all-reduce sees."""

    def one(g):
        q, s = int8_quantize(g)
        return int8_dequantize(q, s, g.dtype)

    return tree_map(one, grads)
