"""Gradient compression for the data-parallel reduction: top-k
sparsification with error feedback, and int8 quantization with a
per-tensor scale -- the JAX package's ``optim/compression.py``.

Both transform the gradient tree before the reduction; error feedback
carries what compression dropped into the next step, so the scheme stays
convergent. ``torch.topk`` with the ``>=`` threshold keeps ties, as
``lax.top_k`` does there, and ``torch.round`` rounds half to even, as
``jnp.round``: both functions give the reference's bits.

Over a mesh of ranks a leaf may be this rank's block (``block``, its
``sharding/rules.py`` ``Sharding``; ``blocks`` for a list of leaves, None
where whole): the threshold and the scale are still the whole leaf's. The
k-th largest magnitude of the whole leaf is the k-th largest of the union
of each block's own k largest (gathered over the axes that split it), and
the int8 scale is the maximum over those ranks; the residuals are blocks
as the gradients are.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from ..tree import leaves, tree_map, unflatten


class EFState(NamedTuple):
    residual: Any  # same structure as the gradients, f32


def ef_init(grads_template: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template))


def topk_compress(g: torch.Tensor, frac: float, block=None) -> torch.Tensor:
    """The top ``frac`` of the entries by magnitude (the rest zeroed), in
    f32; of the whole leaf where ``g`` is a ``block`` of it."""
    flat = g.reshape(-1).float()
    if block is None:
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(torch.abs(flat), k).values[-1]
    else:
        k = max(1, int(math.prod(block.global_shape(g.shape)) * frac))
        mine = torch.topk(torch.abs(flat), min(k, flat.numel())).values
        union = block.mesh.over(block.axes).all_gather(mine).reshape(-1)
        thresh = torch.topk(union, k).values[-1]
    kept = torch.where(torch.abs(flat) >= thresh, flat, 0.0)
    return kept.reshape(g.shape)


def _each(blocks: Optional[Sequence], n: int) -> Sequence:
    return [None] * n if blocks is None else blocks


def topk_with_error_feedback(grads: Any, ef: EFState, frac: float = 0.1,
                             blocks: Optional[Sequence] = None) -> Tuple[Any, EFState]:
    """Each leaf plus its residual, top-k compressed (in the leaf's dtype);
    the new residual is what the compression dropped (f32). ``blocks``: per
    leaf, its ``Sharding`` where it is a rank's block."""
    comp, res = [], []
    flat = leaves(grads)
    for g, r, b in zip(flat, leaves(ef.residual), _each(blocks, len(flat))):
        acc = g.float() + r
        c = topk_compress(acc, frac, b)
        comp.append(c.to(g.dtype))
        res.append(acc - c)
    return unflatten(grads, comp), EFState(residual=unflatten(ef.residual, res))


def int8_quantize(g: torch.Tensor, block=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: ``g`` in int8 steps of ``scale``, the largest
    magnitude (of the whole leaf where ``g`` is a ``block``) over 127."""
    top = torch.max(torch.abs(g.float()))
    if block is not None:
        top = block.mesh.over(block.axes).pmax(top)
    # the divisor as a tensor on g's device: CUDA divides by a host scalar
    # as a product with its reciprocal, which can round otherwise
    top = torch.clamp(top, min=1e-12)
    scale = top / torch.full((), 127.0, device=g.device)
    q = torch.clamp(torch.round(g.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_tree_roundtrip(grads: Any, blocks: Optional[Sequence] = None) -> Any:
    """Quantize and dequantize every leaf: what the compressed all-reduce
    sees. ``blocks`` as ``topk_with_error_feedback``'s."""
    flat = leaves(grads)
    out = []
    for g, b in zip(flat, _each(blocks, len(flat))):
        q, s = int8_quantize(g, b)
        out.append(int8_dequantize(q, s, g.dtype))
    return unflatten(grads, out)
