"""DeepSeek-V3 Multi-head Latent Attention (MLA) -- the JAX package's
``models/mla.py``.

Train and prefill materialize per-head K and V from the compressed latent;
decode uses the absorbed form, so the cache holds only ``c_kv``
(``kv_lora``) and ``k_rope`` (``qk_rope``) per token. Dtypes follow the
reference op by op: at decode ``q_abs . c_kv`` is a product of the
operands' dtype (bf16 at published width) rounded to it and then widened
to f32, the rope term is f32, and the probabilities are cast to the
cache's dtype before the context product.

Over a mesh (a ``Layout``, ``layers.py``) ``wq_b``, ``wk_b``, ``wv_b`` and
``wo`` are this rank's block of the heads, ``wq_a`` / ``wkv_a`` ZeRO-3
blocks of ``wembed`` (``lora`` is unsplit): the latents and their norms
are the same on every rank and enter the heads' region after the norms;
decode's latent caches are this rank's block of the slots, combined as
``layers.decode_attention``'s.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout
from .layers import (NEG_INF, _chunked_causal_attn, _combine_slots, _dtype, _proj, apply_rope,
                     cut, make, ones, rms_norm, write_cache)


def init_mla(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    dt = _dtype(cfg)
    dev = device or gen.device
    p = dict(
        wq_a=make(gen, (d, cfg.q_lora), ("wembed", "lora"), 1.0, dt, device),
        q_norm=ones((cfg.q_lora,), ("lora",), device=dev),
        wq_b=make(gen, (cfg.q_lora, H, cfg.qk_nope + cfg.qk_rope), ("lora", "heads", "head_dim"),
                  1.0, dt, device),
        wkv_a=make(gen, (d, cfg.kv_lora + cfg.qk_rope), ("wembed", "lora"), 1.0, dt, device),
        kv_norm=ones((cfg.kv_lora,), ("lora",), device=dev),
        wk_b=make(gen, (cfg.kv_lora, H, cfg.qk_nope), ("lora", "heads", "head_dim"), 1.0, dt,
                  device),
        wv_b=make(gen, (cfg.kv_lora, H, cfg.v_head), ("lora", "heads", "head_dim"), 1.0, dt,
                  device),
        wo=make(gen, (H, cfg.v_head, d), ("heads", "head_dim", "wembed"), 1.0, dt, device),
    )
    return {k: cut(v, lay) for k, v in p.items()}


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as a JAX product of mixed
    operands (an f32 model reading the bf16 cache computes in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _project_qkv(params, x, cfg: ArchConfig, positions, lay: Layout = WHOLE):
    """q of the rank's heads (nope and rotated rope parts), the normed
    latent and the rotated rope key (the same on every rank)."""
    cq = rms_norm(x @ lay.whole(params["wq_a"], 0), params["q_norm"])
    q = _proj(lay.enter("heads", cq), params["wq_b"])  # (B, S, H, nope + rope)
    q_nope, q_rope = q[..., :cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = x @ lay.whole(params["wkv_a"], 0)
    c_kv = rms_norm(kv[..., :cfg.kv_lora], params["kv_norm"])
    k_rope = apply_rope(kv[..., None, cfg.kv_lora:], positions, cfg.rope_theta)  # (B, S, 1, r)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                  positions: Optional[torch.Tensor] = None, lay: Layout = WHOLE) -> torch.Tensor:
    """Train / prefill: per-head K and V from the latent, chunked causal
    attention with v padded to the q/k head width (scale
    ``1/sqrt(qk_nope + qk_rope)``), then sliced back to ``v_head``. Over a
    mesh, the rank's heads, ``wo``'s product summed over ``model``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope, c_kv, k_rope = _project_qkv(params, x, cfg, positions, lay)
    c_kv, k_rope = lay.enter("heads", c_kv), lay.enter("heads", k_rope)
    k_nope = _proj(c_kv, params["wk_b"])
    v = _proj(c_kv, params["wv_b"])
    H = k_nope.shape[2]
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope)], -1)
    vp = torch.nn.functional.pad(v, (0, q.shape[-1] - v.shape[-1]))
    out = _chunked_causal_attn(q, k, vp, cfg.attn_chunk, True, cfg.causal_impl)[..., :cfg.v_head]
    wo = lay.whole(params["wo"], 2)
    Hh, vd, d = wo.shape
    return lay.psum("heads", out.reshape(B, S, Hh * vd) @ wo.reshape(Hh * vd, d))


def mla_decode(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_ckv: torch.Tensor,  # (B, S, kv_lora), written in place
    cache_kr: torch.Tensor,  # (B, S, qk_rope), written in place
    pos: torch.Tensor,  # () current position
    cfg: ArchConfig,
    lay: Layout = WHOLE,
    seq: str = "kv_seq",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed decode: scores through the latent space, the cache stays
    compressed. The new latent and rope key are written at ``pos`` in
    place (clamped as ``dynamic_update_slice``); returns ``(y, cache_ckv,
    cache_kr)``. Over a mesh the caches are this rank's block of the slots
    on ``seq``'s axis: the rank's heads' absorbed queries are gathered over
    ``model``, the blocks combined as ``layers.decode_attention``'s, and the
    rank's heads go through ``wv_b`` and the row-parallel ``wo``."""
    q_nope, q_rope, c_new, kr_new = _project_qkv(params, x, cfg, pos[None, None], lay)
    S = cache_ckv.shape[1]
    s0, n_slots = lay.start(seq, S), S * lay.size(seq)
    write_cache(cache_ckv, c_new, pos, s0, n_slots)
    write_cache(cache_kr, kr_new[:, :, 0], pos, s0, n_slots)
    # absorb the k up-projection into q: (H, B, nope) @ (H, nope, kv_lora)
    q_abs = _mm(q_nope[:, 0].transpose(0, 1), params["wk_b"].permute(1, 2, 0)).transpose(0, 1)
    n_loc = q_abs.shape[1]
    q_abs = lay.gather("heads", q_abs, 1)  # (B, H, kv_lora): every head meets the slots
    q_rope = lay.gather("heads", q_rope[:, 0], 1)  # (B, H, rope)
    s = _mm(q_abs, cache_ckv.transpose(1, 2)).float()  # (B, H, S)
    s = s + q_rope.float() @ cache_kr.float().transpose(1, 2)
    s = s / (cfg.qk_nope + cfg.qk_rope) ** 0.5
    s = torch.where(torch.arange(s0, s0 + S, device=x.device)[None, None, :] <= pos, s, NEG_INF)
    ctx = _combine_slots(s, lambda p: p @ cache_ckv.to(p.dtype), lay, seq,
                         cache_ckv.dtype)  # (B, H, kv_lora)
    h0 = lay.start("heads", n_loc)
    ctx = ctx[:, h0:h0 + n_loc]
    out = _mm(ctx.transpose(0, 1), params["wv_b"].transpose(0, 1)).transpose(0, 1)  # (B, H, v)
    wo = lay.whole(params["wo"], 2)
    Hh, vd, d = wo.shape
    y = _mm(out.reshape(out.shape[0], 1, Hh * vd), wo.reshape(Hh * vd, d))
    return lay.psum("heads", y), cache_ckv, cache_kr
