"""Mixture-of-Experts FFN: capacity-based top-k routing with shared experts
-- the JAX package's ``models/moe.py`` on one device.

Each token's router picks its ``moe_topk`` experts; each expert then takes
at most ``capacity`` tokens, those of its choosers with the largest gates
(``_select``); the chosen tokens go through the expert's SwiGLU, and each
token sums its experts' outputs weighted by their gates. A token an expert
cannot take is dropped from that expert. Experts are padded to a multiple
of ``EP_PAD`` at init; the router masks the padding experts, which still
run at capacity (with no valid slot), as the reference's.

Three points keep the reference's semantics exactly:

- both selections break ties as ``jax.lax.top_k`` does, the lower index
  first among equal values (a stable descending sort; ``torch.topk`` does
  not promise it), so a batch that repeats a prompt drops the same tokens;
- the router product is f32 in full precision (no TF32 on the card);
- each token's output is the sum of its experts' contributions in
  ascending expert order, each add rounded to the experts' dtype -- the
  order of the reference's sequential scatter-add -- gathered per token, so
  the same inputs give the same bits on every run on the card (an atomic
  ``index_add_`` would not: a recomputed forward under ``remat="full"``
  could then route differently from the first). The reference also adds
  the zero-weighted slots of tokens an expert took without being chosen;
  adding a zero changes no value, so they are left out.

The reference's ``moe_ffn_sharded`` (experts over a mesh's ``model`` axis)
is ROADMAP A.13h; ``moe_ffn`` runs ``moe_ffn_dense``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from .layers import NEG_INF, Param, _dtype, make

EP_PAD = 16


def n_experts_padded(cfg: ArchConfig) -> int:
    return -(-cfg.n_experts // EP_PAD) * EP_PAD


def _make_experts(gen, shape, spec, dtype, device=None) -> Param:
    """``make(gen, shape, spec, 1.0, dtype)`` drawn one expert at a time:
    the same distribution (``fan_in = shape[0]``, the expert count, as the
    reference's rule), with one expert's f32 draw alive instead of the
    whole (E, d, f) stack's."""
    dev = gen.device if device is None else torch.device(device)
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    if dev.type != "meta":
        std = 1.0 / max(shape[0], 1) ** 0.5
        for e in range(shape[0]):
            x = torch.randn(tuple(shape[1:]), generator=gen, dtype=torch.float32, device=dev)
            out[e] = x.to(dtype) * std
    return Param(out, tuple(spec))


def init_moe(gen, cfg: ArchConfig, device=None) -> Dict:
    d, f = cfg.d_model, cfg.d_expert or cfg.d_ff
    E = n_experts_padded(cfg)
    dt = _dtype(cfg)
    p = dict(
        w_router=make(gen, (d, E), ("wembed", None), 1.0, torch.float32, device),
        w_gate=_make_experts(gen, (E, d, f), ("experts", "wembed", "expert_mlp"), dt, device),
        w_up=_make_experts(gen, (E, d, f), ("experts", "wembed", "expert_mlp"), dt, device),
        w_down=_make_experts(gen, (E, f, d), ("experts", "expert_mlp", "wembed"), dt, device),
    )
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = dict(
            w_gate=make(gen, (d, fs), ("wembed", "mlp"), 1.0, dt, device),
            w_up=make(gen, (d, fs), ("wembed", "mlp"), 1.0, dt, device),
            w_down=make(gen, (fs, d), ("mlp", "wembed"), 1.0, dt, device),
        )
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, the lower index first among equal values."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _shared_ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    return (F.silu(g) * u) @ p["w_down"]


def _route(x2d: torch.Tensor, w_router: torch.Tensor, cfg: ArchConfig):
    """(T, d) -> (probs (T, E) f32 with padding masked, top-k idx (T, K))."""
    E = w_router.shape[1]
    with full_f32_matmul():
        logits = x2d.float() @ w_router.float()
    if E > cfg.n_experts:
        pad = torch.arange(E, device=x2d.device) >= cfg.n_experts
        logits = torch.where(pad[None, :], NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    _, top_idx = _top_k(logits, cfg.moe_topk)
    return probs, top_idx


def _expert_compute(xg: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """xg: (E, C, d); weights (E, d, f) / (E, f, d) -> (E, C, d)."""
    g = torch.bmm(xg, wg)
    u = torch.bmm(xg, wu)
    return torch.bmm(F.silu(g) * u, wd)


def _capacity(n_tokens: int, cfg: ArchConfig, n_experts: int) -> int:
    c = int(n_tokens * cfg.moe_topk * cfg.capacity_factor / max(n_experts, 1))
    return max(8, -(-c // 8) * 8)


def _select(probs: torch.Tensor, top_idx: torch.Tensor, e_lo: int, e_n: int, cap: int):
    """Each expert in ``[e_lo, e_lo + e_n)`` takes the ``min(cap, T)``
    tokens of largest score: the gate where the token chose the expert,
    else -1. Returns ``(top_val, tok_idx)``, both (e_n, C); a slot is valid
    where ``top_val > 0``."""
    T = probs.shape[0]
    eids = e_lo + torch.arange(e_n, device=probs.device)
    chosen = (top_idx[None, :, :] == eids[:, None, None]).any(-1)  # (e_n, T)
    gate = probs[:, e_lo:e_lo + e_n].T  # (e_n, T)
    score = torch.where(chosen, gate, -1.0)
    return _top_k(score, min(cap, T))


def _combine(contrib: torch.Tensor, tok_idx: torch.Tensor, top_idx: torch.Tensor,
             e_lo: int) -> torch.Tensor:
    """(T, d): each token's contributions (``contrib``, (e_n, C, d), the
    weighted expert outputs in slot order) summed in ascending expert
    order, each add in ``contrib``'s dtype. A token's contributions come
    from its own top-k experts only (a valid slot is a chosen one), so the
    sum reads (T, K) slots, found through a slot table per expert; each
    slot is read by one token at most, which keeps the backward free of
    duplicate indices too."""
    e_n, C, d = contrib.shape
    T, K = top_idx.shape
    dev = contrib.device
    slot = torch.full((e_n, T), -1, dtype=torch.long, device=dev)
    slot.scatter_(1, tok_idx, torch.arange(C, device=dev).expand(e_n, C).contiguous())
    local = torch.sort(top_idx, dim=1).values - e_lo  # (T, K), ascending experts
    inside = (local >= 0) & (local < e_n)
    local = local.clamp(0, e_n - 1)
    c = slot[local, torch.arange(T, device=dev)[:, None]]  # (T, K)
    hit = inside & (c >= 0)
    parts = contrib.reshape(e_n * C, d)[(local * C + c.clamp(min=0)).reshape(-1)]
    parts = torch.where(hit.reshape(-1, 1), parts, 0.0).reshape(T, K, d)
    y = parts[:, 0]
    for k in range(1, K):
        y = y + parts[:, k]
    return y


def _select_and_apply(x2d, probs, top_idx, wg, wu, wd, cfg: ArchConfig, e_lo: int, e_n: int,
                      cap: int) -> torch.Tensor:
    """Top-C selection per expert in ``[e_lo, e_lo + e_n)``, the experts'
    FFN, the weighted combine: the (T, d) output of these experts."""
    T, d = x2d.shape
    top_val, tok_idx = _select(probs, top_idx, e_lo, e_n, cap)
    valid = top_val > 0.0
    xg = x2d[tok_idx.reshape(-1)].reshape(e_n, -1, d)  # (e_n, C, d)
    yg = _expert_compute(xg, wg, wu, wd)
    w = torch.where(valid, top_val, 0.0).to(yg.dtype)[..., None]  # (e_n, C, 1)
    return _combine(yg * w, tok_idx, top_idx, e_lo)


def moe_ffn_dense(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The reference's single-device MoE: every expert, one device."""
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    probs, top_idx = _route(x2d, params["w_router"], cfg)
    E = params["w_gate"].shape[0]
    cap = _capacity(x2d.shape[0], cfg, cfg.n_experts)
    y = _select_and_apply(x2d, probs, top_idx, params["w_gate"], params["w_up"],
                          params["w_down"], cfg, 0, E, cap)
    out = y.reshape(B, S, d).to(x.dtype)
    if "shared" in params:
        out = out + _shared_ffn(params["shared"], x)
    return out


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh=None) -> torch.Tensor:
    """``moe_ffn_dense``; the reference's ``moe_ffn_sharded`` over a mesh
    is ROADMAP A.13h."""
    if mesh is not None:
        raise NotImplementedError("the sharded MoE is not ported yet (ROADMAP A.13h)")
    return moe_ffn_dense(params, x, cfg)
