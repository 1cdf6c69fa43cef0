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
a mesh and compute nothing, so the port has none.

Over a mesh of ranks every family's layers take a ``Layout``
(``sharding/rules.py``; ``WHOLE``, the default, is one device) and their
weights as this rank's blocks by the rules, drawn whole and cut
(``init_*(..., lay=)``). Each weight's ``wembed`` dimension is gathered
over the data axes where the layer uses it (ZeRO-3; the backward
reduce-scatters its gradient). The layers are Megatron's tensor-parallel
ones over ``model``: the embedding and the head split the vocabulary
(``embed_lookup`` sums one nonzero row over the blocks; ``softmax_xent``
combines the blocks' log-sum-exp), attention splits the query heads (each
rank reads the kv heads its heads map to, ``kv_heads`` being unsplit) and
the FFN its hidden width; a column-parallel product's input enters through
``Layout.enter`` (``pvary``: its cotangent summed over ``model``) and a
row-parallel product's output is summed over ``model``. Decode splits the
cache's slots (``kv_seq`` over ``model``, ``kv_seq_all`` over every axis)
and combines the blocks' softmax flash-decoding style.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout

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


def cut(p: Param, lay: Layout) -> Param:
    """This rank's block of a whole ``Param`` by ``lay``'s rules."""
    return Param(lay.cut(p.value, p.spec), p.spec)


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
def init_embedding(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    return dict(table=cut(make(gen, (cfg.vocab, cfg.d_model), ("vocab", "wembed"), 1.0,
                               _dtype(cfg), device), lay))


def _vocab_rows(ids: torch.Tensor, n: int, lay: Layout):
    """``(local, inside)``: ``ids`` as rows of this rank's block of ``n``
    vocabulary entries (clamped into it), and where they fall inside it."""
    local = ids.long() - lay.start("vocab", n)
    return local.clamp(0, n - 1), (local >= 0) & (local < n)


def embed_lookup(params: Dict, ids: torch.Tensor, lay: Layout = WHOLE) -> torch.Tensor:
    """Rows of the table. The reference multiplies a one-hot by the table;
    every output element there is one nonzero product, so a row gather
    gives the same bits without the (B, S, vocab) one-hot. Over a mesh
    (vocab-parallel) each rank looks up the ids of its block of the
    vocabulary, writes zeros for the others and the blocks are summed over
    ``model``: one nonzero term an element, so the bits are one device's."""
    table = lay.whole(params["table"], 1)
    if lay.axis("vocab") is None:
        return table[ids.long()]
    local, inside = _vocab_rows(ids, table.shape[0], lay)
    return lay.psum("vocab", torch.where(inside[..., None], table[local], 0.0))


def init_lm_head(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    return dict(w=cut(make(gen, (cfg.d_model, cfg.vocab), ("wembed", "vocab"), 1.0, _dtype(cfg),
                           device), lay))


def lm_logits(params: Dict, x: torch.Tensor, lay: Layout = WHOLE) -> torch.Tensor:
    """``x @ w``: over a mesh, this rank's block of the vocabulary
    (column-parallel; ``lay.gather("vocab", ..., -1)`` joins the blocks)."""
    return lay.enter("vocab", x) @ lay.whole(params["w"], 0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, lay: Layout = WHOLE) -> torch.Tensor:
    """Mean cross entropy over all positions: logsumexp in f32 minus the
    gold logit. The reference sums the logits against an f32 one-hot; each
    row has one nonzero term there, so a gather of the gold logit gives the
    same bits without the (B, S, vocab) one-hot. Over a mesh ``logits`` is
    this rank's block of the vocabulary: the log-sum-exp takes the largest
    logit over the blocks (``pmax``, no gradient) and sums the blocks'
    exponentials over ``model``; the gold logit comes from the block that
    holds it (a sum of one nonzero term)."""
    lf = logits.float()
    if lay.axis("vocab") is None:
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        return torch.mean(lse - gold)
    top = lay.pmax("vocab", torch.amax(lf.detach(), dim=-1, keepdim=True))
    lse = torch.log(lay.psum("vocab", torch.sum(torch.exp(lf - top), dim=-1))) + top[..., 0]
    local, inside = _vocab_rows(labels, lf.shape[-1], lay)
    gold = torch.gather(lf, -1, local[..., None])[..., 0]
    gold = lay.psum("vocab", torch.where(inside, gold, 0.0))
    return torch.mean(lse - gold)


# --------------------------------------------------------------- attention
def init_attention(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
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
    return {k: cut(v, lay) for k, v in p.items()}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    d, h, k = w.shape
    return _matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _expand_kv(k: torch.Tensor, n_heads: int, h0: int = 0,
               n_loc: Optional[int] = None) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head H/KV times;
    with ``h0`` / ``n_loc``, the kv heads of query heads ``h0 .. h0 +
    n_loc`` alone (a rank's block of the heads): head ``h`` reads kv head
    ``h // (H / KV)``, which keeps ``pad_heads_to``'s per-group padding."""
    B, S, KV, D = k.shape
    n_loc = n_heads if n_loc is None else n_loc
    if n_loc < n_heads:
        idx = torch.arange(h0, h0 + n_loc, device=k.device) // (n_heads // KV)
        return k.index_select(2, idx)
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
    lay: Layout = WHOLE,
) -> torch.Tensor:
    """Self-attention over the sequence (causal, or bidirectional with
    ``causal=False``), or cross attention from ``x`` to ``kv_x``: k and v
    are then projected from the source, take no rope, and every source
    position is attended. Over a mesh (``lay``) q is this rank's block of
    the heads, k and v every kv head (the same on every rank) of which each
    rank reads those its heads map to, and ``wo``'s product is summed over
    ``model``."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    wq, wo = lay.whole(params["wq"], 0), lay.whole(params["wo"], 2)
    q = _proj(lay.enter("heads", x), wq)
    k = _proj(src, lay.whole(params["wk"], 0))
    v = _proj(src, lay.whole(params["wv"], 0))
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    if kv_x is None:
        k = apply_rope(k, positions, cfg.rope_theta)
    n_loc = wq.shape[1]
    n_heads, h0 = n_loc * lay.size("heads"), lay.start("heads", n_loc)
    k = _expand_kv(lay.enter("heads", k), n_heads, h0, n_loc)
    v = _expand_kv(lay.enter("heads", v), n_heads, h0, n_loc)
    out = _chunked_causal_attn(q, k, v, cfg.attn_chunk, causal and kv_x is None,
                               cfg.causal_impl)
    H, hd, d = wo.shape
    return lay.psum("heads", _matmul(out.reshape(B, S, H * hd), wo.reshape(H * hd, d)))


def row_parallel(x: torch.Tensor, w: torch.Tensor, lay: Layout, name: str) -> torch.Tensor:
    """``x @ w`` for a weight split by rows over ``name``'s axis (``x`` the
    rank's columns of the input), summed over the axis. Each rank's partial
    product is taken in f32 (in full f32 on the card), the partials are
    summed in f32 and the sum is rounded once to the product's dtype, as one
    device's product accumulates in f32 and rounds once: a bf16 partial
    rounded before the sum would add a rounding per rank. On one device,
    ``_matmul``."""
    if lay.axis(name) is None:
        return _matmul(x, w)
    with full_f32_matmul():
        part = x.float() @ w.float()
    return lay.psum(name, part).to(torch.promote_types(x.dtype, w.dtype))


def fused_halves(xz: torch.Tensor, lay: Layout = WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves of a fused projection's output, each as this rank's
    channels: ``xz`` is the product with a ``(d, 2 * inner)`` weight named
    ``("wembed", "inner")`` (Mamba's ``in_proj``, the mLSTM's ``up``), of
    which a rank stores a contiguous block of the columns -- over two
    ``model`` ranks the whole first half on one and the second on the
    other. Over a mesh the ranks' blocks of ``xz`` are gathered over
    ``inner``'s axis and each rank keeps its own channels of each half (the
    gather's reduce-scatter is the backward: each rank's cotangent is
    nonzero on its own channels alone)."""
    x, z = torch.chunk(lay.gather("inner", xz, -1), 2, dim=-1)
    n = x.shape[-1] // lay.size("inner")
    return lay.own("inner", x, n), lay.own("inner", z, n)


def write_cache(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor, start: int = 0,
                total: Optional[int] = None) -> None:
    """``cache[:, pos] = new`` in place, with the reference's
    ``dynamic_update_slice`` clamp: a start past the end writes the last
    slot. ``pos`` stays a device tensor (no host sync). A cache that is a
    rank's block, slots ``start ..`` of ``total``, is written only where
    the clamped position falls inside it (the last block's rank takes a
    position past the end)."""
    S = cache.shape[1]
    if total is None or (start == 0 and total == S):
        idx = torch.clamp(pos.reshape(1).long(), 0, S - 1)
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    idx = torch.clamp(torch.as_tensor(pos, device=cache.device).reshape(1).long(), 0,
                      total - 1) - start
    inside = (idx >= 0) & (idx < S)
    idx = idx.clamp(0, S - 1)
    cache.index_copy_(1, idx, torch.where(inside, new.to(cache.dtype), cache.index_select(1, idx)))


def _combine_slots(s: torch.Tensor, v_of, lay: Layout, seq: str, dtype) -> torch.Tensor:
    """The softmax of scores ``s`` (f32, the cache's slots last) applied to
    the values, whose products ``v_of(p)`` gives: over one device the
    reference's ``softmax`` cast to the cache's ``dtype``; where the slots
    are split over ``seq``'s axis (flash-decoding), each block's
    exponentials are taken at the largest score over the blocks (``pmax``:
    a block of masked slots adds exactly 0), the sums and the products
    (in f32, of the probabilities cast to ``dtype``) summed over the axis,
    and the result cast to ``dtype`` once."""
    if lay.axis(seq) is None:
        return v_of(torch.softmax(s, dim=-1).to(dtype))
    e = torch.exp(s - lay.pmax(seq, torch.amax(s, dim=-1, keepdim=True)))
    p = (e / lay.psum(seq, torch.sum(e, dim=-1, keepdim=True))).to(dtype)
    return lay.psum(seq, v_of(p.float())).to(dtype)


def decode_attention(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, S, KV, hd), written in place
    cache_v: torch.Tensor,
    pos,  # () current position: a 0-d tensor, or an int
    cfg: ArchConfig,
    update_cache: bool = True,
    rope: bool = True,
    lay: Layout = WHOLE,
    seq: str = "kv_seq",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against the whole cache (every slot scored, slots
    past ``pos`` masked). With ``update_cache`` the port writes the new k/v
    into ``cache_k`` / ``cache_v`` in place and returns them, where the
    reference returns updated copies; without it (the enc-dec family's
    cross attention) the cache is only read. ``rope=False`` leaves q and
    the new k unrotated. Over a mesh the cache is this rank's block of the
    slots on the axis of ``seq`` (``kv_seq``, or ``kv_seq_all`` for
    long-context decode): q of the rank's heads is gathered over ``model``
    so that every head meets the rank's slots, the blocks are combined by
    ``_combine_slots``, and the rank's heads go through the row-parallel
    ``wo``."""
    B, S, KV, hd = cache_k.shape
    wq, wo = lay.whole(params["wq"], 0), lay.whole(params["wo"], 2)
    q = _proj(lay.enter("heads", x), wq)[:, 0]  # (B, H of the rank, hd)
    if rope:
        q = apply_rope(q[:, None], pos[None, None], cfg.rope_theta)[:, 0]
    q = lay.gather("heads", q, 1)  # (B, H, hd)
    H = q.shape[1]
    s0, n_slots = lay.start(seq, S), S * lay.size(seq)
    if update_cache:
        k_new = _proj(x, lay.whole(params["wk"], 0))  # (B, 1, KV, hd)
        if rope:
            k_new = apply_rope(k_new, pos[None, None], cfg.rope_theta)
        write_cache(cache_k, k_new, pos, s0, n_slots)
        write_cache(cache_v, _proj(x, lay.whole(params["wv"], 0)), pos, s0, n_slots)
    g = H // KV
    qg = q.reshape(B, KV, g, hd)
    # per kv head, so that the (B, S, hd) cache slice is read in place
    s = torch.stack([_matmul(qg[:, j], cache_k[:, :, j].transpose(1, 2))
                     for j in range(KV)], dim=1).float() / hd**0.5  # (B, KV, g, S)
    mask = torch.arange(s0, s0 + S, device=x.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, NEG_INF)
    out = _combine_slots(s, lambda p: torch.stack(
        [p[:, j] @ cache_v[:, :, j].to(p.dtype) for j in range(KV)], dim=1),  # (B, KV, g, hd)
        lay, seq, cache_v.dtype)
    n_loc = wq.shape[1]
    h0 = lay.start("heads", n_loc)
    out = out.reshape(B, H, hd)[:, h0:h0 + n_loc]
    y = _matmul(out.reshape(B, 1, n_loc * hd), wo.reshape(n_loc * hd, -1))
    return lay.psum("heads", y), cache_k, cache_v


# --------------------------------------------------------------------- FFN
def init_ffn(gen, cfg: ArchConfig, d_ff: Optional[int] = None, gelu: bool = False,
             device=None, lay: Layout = WHOLE) -> Dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = _dtype(cfg)
    p = {}
    if not gelu:
        p["w_gate"] = make(gen, (d, f), ("wembed", "mlp"), 1.0, dt, device)
    p["w_up"] = make(gen, (d, f), ("wembed", "mlp"), 1.0, dt, device)
    p["w_out"] = make(gen, (f, d), ("mlp", "wembed"), 1.0, dt, device)
    return {k: cut(v, lay) for k, v in p.items()}


def ffn(params: Dict, x: torch.Tensor, lay: Layout = WHOLE) -> torch.Tensor:
    """SwiGLU (GELU without ``w_gate``); over a mesh column-parallel over
    ``mlp`` into ``w_out``'s row-parallel product, summed over ``model``."""
    x = lay.enter("mlp", x)
    up = _matmul(x, lay.whole(params["w_up"], 0))
    if "w_gate" in params:
        h = torch.nn.functional.silu(_matmul(x, lay.whole(params["w_gate"], 0))) * up
    else:
        h = torch.nn.functional.gelu(up, approximate="tanh")
    return lay.psum("mlp", _matmul(h, lay.whole(params["w_out"], 1)))
