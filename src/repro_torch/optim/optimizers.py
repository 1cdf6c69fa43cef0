"""Optimizers written out in PyTorch: AdamW, Adafactor, SGD and the cosine
schedule -- the JAX package's ``optim/optimizers.py``.

Every optimizer is a pair of tree-level functions, as the reference::

    state = init(params)
    updates, state = update(grads, state, params, lr, step)

``params`` and ``grads`` are trees of tensors (a module's parameter dict);
``lr`` and ``step`` are 0-d tensors. The moments are f32 whatever the
parameters' dtype, and each formula is the reference's, operation by
operation: AdamW adds ``wd * p`` inside the ``-lr * (...)`` term and
``eps`` outside ``sqrt(vh)``. (``torch.optim`` keeps bf16 moments for bf16
parameters and decays before the step, which gives other values.)
``update`` writes the new moments into the state's tensors in place and
returns that state: a caller that keeps an older state copies it first.
Each update is cast to its parameter's dtype.

``update`` also takes ``scale``: the gradients are then the unclipped ones
and each is used as ``g.float() * scale``, the clip's own f32 product,
fused into the update so that no f32 copy of every gradient exists at
once. Adafactor makes a leaf's f32 temporaries, and ``global_norm`` its
squares, ``CHUNK`` elements at a time (a stacked expert weight is many
such blocks; most leaves are one).

Over a mesh of ranks ``update`` takes a leaf's ``block``: the
``sharding/rules.py`` ``Sharding`` of a leaf that is this rank's block of
the whole (None for a leaf every rank holds whole). AdamW and SGD are
elementwise and ignore it. Adafactor's factors and its update's RMS are
means over whole rows, columns and leaves: it sums each partial sum over
the ranks that hold the leaf's other blocks along the reduced dimensions
(``Sharding.psum``) and divides by the whole leaf's extent.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from ..tree import leaves, tree_map


CHUNK = 1 << 28  # elements: above it a leaf's f32 temporaries are made in blocks


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of ``x``'s squares, ``CHUNK`` elements at a time."""
    return torch.stack([torch.sum(torch.square(b.float()))
                        for b in x.reshape(-1).split(CHUNK)]).sum()


def global_norm(tree, blocks=None) -> torch.Tensor:
    """The f32 norm of every leaf. Over a mesh, ``blocks`` (a list in
    ``leaves(tree)``'s order) gives each leaf that is a rank's block its
    ``Sharding`` (None: whole on every rank): the whole leaves' squares
    count once, the blocks' are summed over every rank (each block once)."""
    xs = leaves(tree)
    if blocks is None or not any(b is not None for b in blocks):
        return torch.sqrt(torch.sum(torch.stack([_sq_sum(x) for x in xs])))
    whole = [_sq_sum(x) for x, b in zip(xs, blocks) if b is None]
    parts = [_sq_sum(x) / b.holders() for x, b in zip(xs, blocks) if b is not None]
    mesh = next(b for b in blocks if b is not None).mesh
    total = mesh.everyone.psum(torch.stack(parts).sum())
    if whole:
        total = torch.sum(torch.stack(whole)) + total
    return torch.sqrt(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-9))``: what the clip multiplies by."""
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def _f32(g: torch.Tensor, scale) -> torch.Tensor:
    """The gradient in f32, times the clip's ``scale`` where given."""
    return g.float() if scale is None else g.float() * scale


def clip_by_global_norm(tree, max_norm: float):
    """``(tree * scale, norm)`` with ``scale = min(1, max_norm / (norm +
    1e-9))``. Each leaf is clipped in f32: the reference's bf16 gradient
    times its f32 0-d scale is f32 there (in PyTorch it would stay bf16).
    The input leaves are left as they are."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32, copy=True).mul_(scale), tree), norm


# ----------------------------------------------------------------- schedules
def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable[[Any], torch.Tensor]:
    """Linear warm-up from ``base_lr / warmup`` to ``base_lr``, then a
    cosine to 0 at ``total``: an f32 0-d tensor on the step's device."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)

    return fn


def _f32_zeros(p) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


# --------------------------------------------------------------------- adamw
class AdamWState(NamedTuple):
    m: Any
    v: Any


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, wd: float = 0.1):
    def init(params):
        return AdamWState(m=tree_map(_f32_zeros, params), v=tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params, lr, step, scale=None, block=None):
        t = step.float() + 1.0
        c1, c2 = 1 - b1**t, 1 - b2**t

        def one(g, m, v, p):
            # in place where the reference's rounding allows: a few
            # leaf-sized f32 temporaries at a time
            g = _f32(g, scale)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            u = m / c1
            u.div_(torch.div(v, c2).sqrt_().add_(eps))
            u.add_(p.to(torch.float32, copy=True).mul_(wd))
            return u.mul_(-lr).to(p.dtype)

        return tree_map(one, grads, state.m, state.v, params), state

    return init, update


# ----------------------------------------------------------------- adafactor
class AdafactorState(NamedTuple):
    vr: Any  # row factors (or the full v for leaves under 2-D)
    vc: Any  # column factors ((1,) zeros for leaves under 2-D)


def adafactor(eps: float = 1e-30, clip_thresh: float = 1.0, decay_pow: float = 0.8):
    """Factored second moments (Shazeer & Stern) without momentum. A leaf
    of two or more dims keeps a row factor (the mean over its last axis)
    and a column factor (the mean over its second-to-last): a stacked
    ``wq`` of (L, d, H, hd) keeps (L, d, H) and (L, d, hd)."""

    def init(params):
        def vr_init(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc_init(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(vr=tree_map(vr_init, params), vc=tree_map(vc_init, params))

    def factored(g, vr, vc, p, lr, beta, scale, block):
        """The update of a leaf of two or more dims, a block of rows (the
        second-to-last axis) of at most ``CHUNK`` elements at a time: the
        row factors and the column sums in one pass, then the update's RMS,
        then the update. A leaf of one block makes its ``u`` once. With a
        ``block`` the means are the whole leaf's (see the module)."""
        r = g.shape[-2]
        n = max(1, CHUNK // max(g.numel() // max(r, 1), 1))
        blocks = [(i, min(i + n, r)) for i in range(0, r, n)]
        nd = g.ndim
        col = torch.zeros_like(vc)
        for i, j in blocks:
            g2 = torch.square(_f32(g[..., i:j, :], scale)) + eps
            if block is None:
                row = torch.mean(g2, dim=-1)
            else:
                row = block.psum(torch.sum(g2, dim=-1), (-1,), nd) / block.global_shape(g.shape)[-1]
            vr[..., i:j].mul_(beta).add_((1 - beta) * row)
            col += torch.sum(g2, dim=-2)
        if block is None:
            vc.mul_(beta).add_((1 - beta) * (col / r))
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
        else:
            rows = block.global_shape(g.shape)[-2]
            vc.mul_(beta).add_((1 - beta) * (block.psum(col, (-2,), nd) / rows))
            denom = torch.clamp(block.psum(torch.sum(vr, dim=-1, keepdim=True), (-2,), nd)
                                / rows, min=eps)

        def u(i, j):
            pre = (vr[..., i:j] / denom)[..., None] * vc[..., None, :]
            return _f32(g[..., i:j, :], scale) / torch.sqrt(pre + eps)

        kept, sums = None, []
        for i, j in blocks:
            x = u(i, j)
            sums.append(torch.sum(torch.square(x)))
            kept = x if len(blocks) == 1 else None
        # update clipping (RMS <= clip_thresh)
        rms = torch.sqrt(_whole_sum(torch.stack(sums).sum(), block, g) / _numel(block, g) + 1e-12)
        div = torch.clamp(rms / clip_thresh, min=1.0)
        if kept is not None:
            return ((-lr) * (kept / div)).to(p.dtype)
        out = torch.empty_like(p)
        for i, j in blocks:
            out[..., i:j, :] = ((-lr) * (u(i, j) / div)).to(p.dtype)
        return out

    @torch.no_grad()
    def update(grads, state, params, lr, step, scale=None, block=None):
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay_pow)

        def one(g, vr, vc, p):
            if p.ndim >= 2:
                return factored(g, vr, vc, p, lr, beta, scale, block)
            g = _f32(g, scale)
            vr.mul_(beta).add_((1 - beta) * (torch.square(g) + eps))
            u = g / torch.sqrt(vr + eps)
            # update clipping (RMS <= clip_thresh)
            if block is None:
                rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
            else:
                rms = torch.sqrt(_whole_sum(torch.sum(torch.square(u)), block, u)
                                 / _numel(block, u) + 1e-12)
            u = u / torch.clamp(rms / clip_thresh, min=1.0)
            return ((-lr) * u).to(p.dtype)

        return tree_map(one, grads, state.vr, state.vc, params), state

    return init, update


def _whole_sum(t: torch.Tensor, block, leaf: torch.Tensor) -> torch.Tensor:
    """A sum over a leaf's elements, over the whole leaf where it is a block."""
    return t if block is None else block.psum(t, range(leaf.ndim), leaf.ndim)


def _numel(block, leaf: torch.Tensor) -> int:
    return leaf.numel() if block is None else math.prod(block.global_shape(leaf.shape))


# ----------------------------------------------------------------------- sgd
class SGDState(NamedTuple):
    mom: Any


def sgd(momentum: float = 0.9):
    def init(params):
        return SGDState(mom=tree_map(_f32_zeros, params))

    @torch.no_grad()
    def update(grads, state, params, lr, step, scale=None, block=None):
        def one(g, m, p):
            m.mul_(momentum).add_(_f32(g, scale))
            return ((-lr) * m).to(p.dtype)

        return tree_map(one, grads, state.mom, params), state

    return init, update


OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}


def get_optimizer(name: str):
    return OPTIMIZERS[name]()
