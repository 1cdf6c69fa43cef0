"""Shared model layers: params-with-specs helpers, norms (RMS and layer
norm), RoPE, sinusoidal positions, embeddings, GQA attention (chunked
flash-pattern prefill -- causal, bidirectional or cross -- and one-token
decode against a KV cache), SwiGLU / GELU FFN, the cross-entropy loss --
the JAX package's ``models/layers.py``.

Every ``init_*`` returns a dict whose leaves are ``Param(value, spec)``;
``split_params`` separates values from logical-name specs, which name each
axis for a later sharded run. All matmul compute runs in the config dtype
(bf16 at the published widths); softmax and norms accumulate in f32. Each
function follows its reference op by op, dtype casts included: the
attention scores of a bf16 model are rounded to bf16 before the f32
softmax, as the reference's ``einsum`` returns them. Where the reference
multiplies an f32 operand by a bf16 one (the enc-dec family's f32 frames
against bf16 weights), JAX promotes both to f32; ``_matmul`` and
``_einsum`` do the same, in full f32 on the card, and leave a product of
one dtype as it was. The reference's ``constrain`` calls pin shardings on
a mesh and compute nothing, so this single-device port has none.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import full_f32_matmul
from ..configs.base import ArchConfig

NEG_INF = -1e30  # the reference's score mask


class Param(NamedTuple):
    value: Any
    spec: Tuple[Optional[str], ...]


def is_param(x) -> bool:
    return isinstance(x, Param)


def tree_map(fn, tree):
    if is_param(tree):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def split_params(tree):
    """``(values, specs)``: two dicts shaped like ``tree``."""
    return tree_map(lambda p: p.value, tree), tree_map(lambda p: p.spec, tree)


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def make(gen: torch.Generator, shape, spec, scale: float = 1.0, dtype=torch.bfloat16,
         device=None) -> Param:
    """A standard normal draw from ``gen``, cast to ``dtype``, times
    ``scale / sqrt(fan_in)`` with ``fan_in = shape[0]`` (the reference's
    rule: ``wo`` of shape (H, hd, d) gets ``1/sqrt(H)``). The same
    distribution as the reference, not its bits. ``device`` defaults to
    the generator's; on ``meta`` nothing is drawn."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale / max(fan_in, 1) ** 0.5
    dev = gen.device if device is None else torch.device(device)
    g = None if dev.type == "meta" else gen
    x = torch.randn(tuple(shape), generator=g, dtype=torch.float32, device=dev)
    return Param(x.to(dtype) * std, tuple(spec))


def zeros(shape, spec, dtype=torch.float32, device=None) -> Param:
    return Param(torch.zeros(tuple(shape), dtype=dtype, device=device), tuple(spec))


def ones(shape, spec, dtype=torch.float32, device=None) -> Param:
    return Param(torch.ones(tuple(shape), dtype=dtype, device=device), tuple(spec))


# ---------------------------------------------------------------- products
def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; operands of two dtypes are promoted to the wider, as JAX
    does, and their (f32) product runs in full f32 on the card."""
    if a.dtype == b.dtype:
        return a @ b
    dt = torch.promote_types(a.dtype, b.dtype)
    with full_f32_matmul():
        return a.to(dt) @ b.to(dt)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with ``_matmul``'s promotion."""
    if a.dtype == b.dtype:
        return torch.einsum(eq, a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    with full_f32_matmul():
        return torch.einsum(eq, a.to(dt), b.to(dt))


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back. The variance is the population one
    (``jnp.var``'s), taken as the reference does: the mean of the squared
    deviations from the mean."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                           / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (d/2,)
    ang = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) f32: sin in the even columns, cos in the odd ones,
    interleaved. The frequency step is taken in f32, as the reference's
    ``-jnp.log(10000.0) / d``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    step = -torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * step)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# -------------------------------------------------------------- embeddings
def init_embedding(gen, cfg: ArchConfig, device=None) -> Dict:
    return dict(table=make(gen, (cfg.vocab, cfg.d_model), ("vocab", "wembed"), 1.0,
                           _dtype(cfg), device))


def embed_lookup(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the table. The reference multiplies a one-hot by the table;
    every output element there is one nonzero product, so a row gather
    gives the same bits without the (B, S, vocab) one-hot."""
    return params["table"][ids.long()]


def init_lm_head(gen, cfg: ArchConfig, device=None) -> Dict:
    return dict(w=make(gen, (cfg.d_model, cfg.vocab), ("wembed", "vocab"), 1.0, _dtype(cfg),
                       device))


def lm_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over all positions: logsumexp in f32 minus the
    gold logit. The reference sums the logits against an f32 one-hot; each
    row has one nonzero term there, so a gather of the gold logit gives the
    same bits without the (B, S, vocab) one-hot."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


# --------------------------------------------------------------- attention
def init_attention(gen, cfg: ArchConfig, device=None) -> Dict:
    d, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    H = cfg.pad_heads_to or cfg.n_heads
    dt = _dtype(cfg)
    p = dict(
        wq=make(gen, (d, H, hd), ("wembed", "heads", "head_dim"), 1.0, dt, device),
        wk=make(gen, (d, KV, hd), ("wembed", "kv_heads", "head_dim"), 1.0, dt, device),
        wv=make(gen, (d, KV, hd), ("wembed", "kv_heads", "head_dim"), 1.0, dt, device),
        wo=make(gen, (H, hd, d), ("heads", "head_dim", "wembed"), 1.0, dt, device),
    )
    if H > cfg.n_heads:
        # Zero the padded head slices *per KV group*, as the reference: tail
        # padding would shift the GQA head->kv mapping. g real q-heads per kv
        # head become g_pad slots; the extra slots' wq and wo stay 0, so the
        # padded model computes the unpadded one.
        g = cfg.n_heads // KV
        g_pad = H // KV
        mask = (torch.arange(H, device=p["wq"].value.device) % g_pad) < g
        p["wq"] = Param(p["wq"].value * mask[None, :, None].to(dt), p["wq"].spec)
        p["wo"] = Param(p["wo"].value * mask[:, None, None].to(dt), p["wo"].spec)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return _matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head H/KV times."""
    B, S, KV, D = k.shape
    if KV == n_heads:
        return k
    g = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, g, D).reshape(B, S, n_heads, D)


def _chunked_causal_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, chunk: int, causal: bool, impl: str
) -> torch.Tensor:
    """Flash-pattern attention. q, k, v: (B, S, H, D) (k/v already H-expanded;
    their length may differ from q's, and k's dtype from q's: the scores
    are then taken in the wider one).

    ``masked_scan``: a loop over KV chunks with a running (max, denom) --
    O(S*C) memory, computes all S^2 scores (causal entries masked).
    ``unrolled_prefix``: a loop over Q chunks, each attending only to its
    causal KV prefix -- about half the score FLOPs for causal.
    """
    B, S, H, D = q.shape
    scale = 1.0 / D**0.5
    qf = (q * scale).to(q.dtype)
    Skv = k.shape[1]
    C = min(chunk, Skv)
    kv_valid = Skv
    if Skv % C:
        pad = C - Skv % C
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        Skv = Skv + pad
    n_chunks = Skv // C
    dev = q.device

    if impl == "unrolled_prefix" and causal:
        CQ = min(chunk, S)
        if S % CQ:
            raise ValueError(f"unrolled_prefix needs S ({S}) a multiple of the chunk ({CQ})")
        outs = []
        for i in range(S // CQ):
            q_i = qf[:, i * CQ:(i + 1) * CQ]
            hi = min((i + 1) * CQ, Skv)
            k_i, v_i = k[:, :hi], v[:, :hi]
            s = _einsum("bqhd,bkhd->bhqk", q_i, k_i).float()
            qpos = i * CQ + torch.arange(CQ, device=dev)
            kpos = torch.arange(hi, device=dev)
            mask = (qpos[:, None] >= kpos[None, :]) & (kpos[None, :] < kv_valid)
            s = torch.where(mask[None, None], s, NEG_INF)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            outs.append(torch.einsum("bhqk,bkhd->bqhd", p, v_i))
        return torch.cat(outs, dim=1)

    # masked scan with a running softmax
    qpos = torch.arange(S, device=dev)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), -torch.inf, dtype=torch.float32, device=dev)
    denom = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        k_i, v_i = k[:, ci * C:(ci + 1) * C], v[:, ci * C:(ci + 1) * C]
        s = _einsum("bqhd,bkhd->bhqk", qf, k_i).float()  # (B, H, S, C)
        kpos = ci * C + torch.arange(C, device=dev)
        mask = kpos[None, :] < kv_valid
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        denom = denom * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype), v_i).float()
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)  # (B, S, H, D)


def attention(
    params: Dict,
    x: torch.Tensor,  # (B, S, d)
    cfg: ArchConfig,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,  # cross-attention source
) -> torch.Tensor:
    """Self-attention over the sequence (causal, or bidirectional with
    ``causal=False``), or cross attention from ``x`` to ``kv_x``: k and v
    are then projected from the source, take no rope, and every source
    position is attended."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    q = _proj(x, params["wq"])
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_x is None:
        k = apply_rope(k, positions, cfg.rope_theta)
    n_heads = params["wq"].shape[1]
    k = _expand_kv(k, n_heads)
    v = _expand_kv(v, n_heads)
    out = _chunked_causal_attn(q, k, v, cfg.attn_chunk, causal and kv_x is None,
                               cfg.causal_impl)
    H, hd, d = params["wo"].shape
    return _matmul(out.reshape(B, S, H * hd), params["wo"].reshape(H * hd, d))


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``cache[:, pos] = new`` in place, with the reference's
    ``dynamic_update_slice`` clamp: a start past the end writes the last
    slot. ``pos`` stays a device tensor (no host sync)."""
    S = cache.shape[1]
    idx = torch.clamp(pos.reshape(1).long(), 0, S - 1)
    cache.index_copy_(1, idx, new.to(cache.dtype))


def decode_attention(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, S, KV, hd), written in place
    cache_v: torch.Tensor,
    pos,  # () current position: a 0-d tensor, or an int
    cfg: ArchConfig,
    update_cache: bool = True,
    rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the whole cache (every slot scored, slots
    past ``pos`` masked). With ``update_cache`` the port writes the new k/v
    into ``cache_k`` / ``cache_v`` in place and returns them, where the
    reference returns updated copies; without it (the enc-dec family's
    cross attention) the cache is only read. ``rope=False`` leaves q and
    the new k unrotated."""
    B, S, KV, hd = cache_k.shape
    H = params["wq"].shape[1]
    q = _proj(x, params["wq"])[:, 0]  # (B, H, hd)
    if rope:
        q = apply_rope(q[:, None], pos[None, None], cfg.rope_theta)[:, 0]
    if update_cache:
        k_new = _proj(x, params["wk"])  # (B, 1, KV, hd)
        if rope:
            k_new = apply_rope(k_new, pos[None, None], cfg.rope_theta)
        write_cache(cache_k, k_new, pos)
        write_cache(cache_v, _proj(x, params["wv"]), pos)
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    # per kv head, so that the (B, S, hd) cache slice is read in place
    s = torch.stack([_matmul(qg[:, j], cache_k[:, :, j].transpose(1, 2))
                     for j in range(KV)], dim=1).float() / hd**0.5  # (B, KV, g, S)
    mask = torch.arange(S, device=x.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.stack([p[:, j] @ cache_v[:, :, j] for j in range(KV)], dim=1)  # (B, KV, g, hd)
    y = _matmul(out.reshape(B, 1, H * hd), params["wo"].reshape(H * hd, -1))
    return y, cache_k, cache_v


# --------------------------------------------------------------------- FFN
def init_ffn(gen, cfg: ArchConfig, d_ff: Optional[int] = None, gelu: bool = False,
             device=None) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {}
    if not gelu:
        p["w_gate"] = make(gen, (d, f), ("wembed", "mlp"), 1.0, dt, device)
    p["w_up"] = make(gen, (d, f), ("wembed", "mlp"), 1.0, dt, device)
    p["w_out"] = make(gen, (f, d), ("mlp", "wembed"), 1.0, dt, device)
    return p


def ffn(params: Dict, x: torch.Tensor) -> torch.Tensor:
    up = _matmul(x, params["w_up"])
    if "w_gate" in params:
        h = torch.nn.functional.silu(_matmul(x, params["w_gate"])) * up
    else:
        h = torch.nn.functional.gelu(up, approximate="tanh")
    return _matmul(h, params["w_out"])
