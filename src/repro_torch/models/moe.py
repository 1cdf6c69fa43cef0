"""Mixture-of-Experts FFN: capacity-based top-k routing with shared experts
-- the JAX package's ``models/moe.py``, on one device or over a mesh.

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

Over a ``("data", "model")`` mesh of ranks (``launch/mesh.py``) each rank
holds its rows of the batch (split over the data axes) and, where
``ep_sharded``, its block of the expert stacks: experts over ``model``,
``d`` over the data axes (``init_moe(..., lay)`` draws every expert and
keeps the block, so the values are the single-device draw's).
``moe_ffn_sharded`` is the reference's expert-parallel path: the rank's
tokens, routed over all experts, capacity from the data shard's token
count, its experts' share computed with their weights all-gathered over
the data axes, then summed over ``model``; no all-to-all, since every model
rank holds its data group's tokens. ``moe_ffn`` takes it exactly where the
reference's does. Its backward is the reference's ``shard_map`` transpose
(``launch/mesh.py``): the sum over ``model`` passes the cotangent through,
the tokens' and the router's cotangents are summed over ``model`` where
they enter (``pvary``), and the gathered stacks' cotangents are
reduce-scattered over the data axes, so each rank's expert block gets the
whole batch's gradient. Elsewhere (and in decode) the MoE is the reference's
``moe_ffn_dense`` over the whole batch, whose capacity counts every token:
a rank gathers the batch's rows over the data axes, computes its experts'
share with their ``d`` left split over the data axes (``_d_split_compute``),
sums over ``model`` and keeps its own rows.

A model over a mesh (``models/model.py``) stores every MoE weight by the
rules and passes its ``Layout``: the router ``("wembed", None)`` is then a
block of ``d`` gathered over the data axes where it is used (still f32 in
full precision), the shared experts are tensor-parallel over ``mlp`` as
``layers.ffn``, and the expert stacks keep ``d`` split over the data axes
whether or not the experts split over ``model``. Without a ``Layout`` the
router and the shared experts are whole; stacks a caller cut to a rank's
block (``_experts_out`` checks their shapes) compute as above.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout, dp_axes, named_sharding
from .layers import NEG_INF, Param, _dtype, cut, make

EP_PAD = 16


def n_experts_padded(cfg: ArchConfig) -> int:
    return -(-cfg.n_experts // EP_PAD) * EP_PAD


def ep_sharded(cfg: ArchConfig, mesh) -> bool:
    """Whether ``moe_ffn`` takes the expert-parallel path on ``mesh`` (the
    reference's dispatch): a ``model`` axis of more than one rank that
    divides the padded expert count. Only then are the expert stacks
    stored as each rank's block."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    m = mesh.axis("model").size
    return m > 1 and n_experts_padded(cfg) % m == 0


def _make_experts(gen, shape, spec, dtype, device=None, mesh=None, rules=None) -> Param:
    """``make(gen, shape, spec, 1.0, dtype)`` drawn one expert at a time:
    the same distribution (``fan_in = shape[0]``, the expert count, as the
    reference's rule), with one expert's f32 draw alive instead of the
    whole (E, d, f) stack's. With a ``mesh``, every expert is drawn (the
    generator's stream stays the single-device one's) and only this rank's
    block by ``spec`` is kept."""
    dev = gen.device if device is None else torch.device(device)
    block = tuple(slice(0, n) for n in shape)
    if mesh is not None:
        block = named_sharding(mesh, spec, rules).index(shape)
    out = torch.empty(tuple(s.stop - s.start for s in block), dtype=dtype, device=dev)
    if dev.type != "meta":
        std = 1.0 / max(shape[0], 1) ** 0.5
        for e in range(shape[0]):
            x = torch.randn(tuple(shape[1:]), generator=gen, dtype=torch.float32, device=dev)
            if block[0].start <= e < block[0].stop:
                out[e - block[0].start] = x[block[1:]].to(dtype) * std
    return Param(out, tuple(spec))


def init_moe(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    """The MoE's parameters, each ``lay``'s block by its rules (over a
    mesh)."""
    d, f = cfg.d_model, cfg.d_expert or cfg.d_ff
    E = n_experts_padded(cfg)
    dt = _dtype(cfg)
    ep = dict(mesh=lay.mesh, rules=lay.rules) if lay.mesh is not None else {}
    p = dict(
        w_router=cut(make(gen, (d, E), ("wembed", None), 1.0, torch.float32, device), lay),
        w_gate=_make_experts(gen, (E, d, f), ("experts", "wembed", "expert_mlp"), dt, device,
                             **ep),
        w_up=_make_experts(gen, (E, d, f), ("experts", "wembed", "expert_mlp"), dt, device,
                           **ep),
        w_down=_make_experts(gen, (E, f, d), ("experts", "expert_mlp", "wembed"), dt, device,
                             **ep),
    )
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = dict(
            w_gate=cut(make(gen, (d, fs), ("wembed", "mlp"), 1.0, dt, device), lay),
            w_up=cut(make(gen, (d, fs), ("wembed", "mlp"), 1.0, dt, device), lay),
            w_down=cut(make(gen, (fs, d), ("mlp", "wembed"), 1.0, dt, device), lay),
        )
    return p


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, the lower index first among equal values."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _shared_ffn(p: Dict, x: torch.Tensor, lay: Layout = WHOLE) -> torch.Tensor:
    """The shared experts' SwiGLU; over a mesh tensor-parallel over ``mlp``
    (``layers.ffn``'s layout)."""
    x = lay.enter("mlp", x)
    g = x @ lay.whole(p["w_gate"], 0)
    u = x @ lay.whole(p["w_up"], 0)
    return lay.psum("mlp", (F.silu(g) * u) @ lay.whole(p["w_down"], 1))


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
                      cap: int, compute=_expert_compute) -> torch.Tensor:
    """Top-C selection per expert in ``[e_lo, e_lo + e_n)``, the experts'
    FFN (``compute``), the weighted combine: the (T, d) output of these
    experts."""
    T, d = x2d.shape
    top_val, tok_idx = _select(probs, top_idx, e_lo, e_n, cap)
    valid = top_val > 0.0
    xg = x2d[tok_idx.reshape(-1)].reshape(e_n, -1, d)  # (e_n, C, d)
    yg = compute(xg, wg, wu, wd)
    w = torch.where(valid, top_val, 0.0).to(yg.dtype)[..., None]  # (e_n, C, 1)
    return _combine(yg * w, tok_idx, top_idx, e_lo)


def _gathered(w: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """``w``'s blocks of every rank of ``axis`` joined along ``dim`` in
    axis order (``lax.all_gather(..., tiled=True)``)."""
    if axis is None or axis.size == 1:
        return w
    return axis.all_gather_dim(w, dim)


def _d_split_compute(dp):
    """``_expert_compute`` on weights whose ``d`` is this rank's block over
    ``dp``: the gate and up products over the rank's block of ``d``, summed
    over ``dp``; the down product's ``d`` blocks gathered over ``dp``. The
    collectives carry the experts' activations, not their weights."""

    def compute(xg, wg, wu, wd):
        n = wg.shape[1]
        xs = xg[..., dp.index * n:(dp.index + 1) * n]
        g = dp.psum(torch.bmm(xs, wg))
        u = dp.psum(torch.bmm(xs, wu))
        return _gathered(torch.bmm(F.silu(g) * u, wd), dp, 2)

    return compute


def _experts_out(params: Dict, x2d: torch.Tensor, cfg: ArchConfig, mesh, cap: int,
                 gather_weights: bool = True, lay: Layout = WHOLE):
    """(T, d): the routed experts' output for the tokens ``x2d``, routed
    over every expert. Where ``ep_sharded`` on ``mesh``, this rank's
    experts ``[e_lo, e_lo + e_n)`` compute and the shares are summed over
    ``model``. Stacks whose ``d`` is this rank's block over the data axes
    compute with their weights gathered over them (``gather_weights``, the
    reference's sharded path), else with ``d`` split
    (``_d_split_compute``: a few tokens' activations move instead of the
    weights). A router stored as a block of ``d`` (``lay``) is gathered."""
    wr, wg, wu, wd = params["w_router"], params["w_gate"], params["w_up"], params["w_down"]
    ep = ep_sharded(cfg, mesh)
    model = mesh.axis("model") if ep else None
    dp = mesh.group_axis(dp_axes(mesh)) if mesh is not None else None
    if model is not None:
        # the tokens and the router enter replicated over model: each model
        # rank uses them for its own experts, so their cotangents sum over model
        x2d, wr = model.pvary(x2d), model.pvary(wr)
    probs, top_idx = _route(x2d, lay.whole(wr, 0), cfg)
    e_n = n_experts_padded(cfg) // (model.size if ep else 1)
    n_dp = 1 if wg.shape[1] == cfg.d_model else (dp.size if dp is not None else 0)
    if (wg.shape[0], wg.shape[1] * n_dp) != (e_n, cfg.d_model) or wd.shape[2] != wg.shape[1]:
        raise ValueError(f"expert stacks {tuple(wg.shape)} / {tuple(wd.shape)} are not this "
                         f"rank's block of {e_n} experts (build the model with the mesh)")
    compute = _expert_compute
    if n_dp > 1 and gather_weights:
        wg, wu, wd = _gathered(wg, dp, 1), _gathered(wu, dp, 1), _gathered(wd, dp, 2)
    elif n_dp > 1:
        compute = _d_split_compute(dp)
    y = _select_and_apply(x2d, probs, top_idx, wg, wu, wd, cfg, model.index * e_n if ep else 0,
                          e_n, cap, compute)
    return model.psum(y) if ep else y


def _with_shared(params: Dict, y: torch.Tensor, x: torch.Tensor,
                 lay: Layout = WHOLE) -> torch.Tensor:
    out = y.reshape(x.shape).to(x.dtype)
    if "shared" in params:
        out = out + _shared_ffn(params["shared"], x, lay)
    return out


def moe_ffn_dense(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh=None,
                  rows_split: bool = True, lay: Layout = WHOLE) -> torch.Tensor:
    """The reference's MoE over the whole batch: every expert, the capacity
    from every token. On a ``mesh`` with ``rows_split`` (``x`` is this
    rank's rows of a batch split over the data axes), the rows are gathered
    over the data axes and this rank's rows of the output kept; without it
    ``x`` is the whole batch on every rank (long-context decode). Serving,
    the experts' ``d`` stays split over the data axes
    (``_d_split_compute``): at decode's few tokens their activations are
    far smaller than their weights. Under autograd the stacks are gathered
    instead, so that their gradients come reduce-scattered over the data
    axes as the sharded path's do."""
    B, S, d = x.shape
    dp = mesh.group_axis(dp_axes(mesh)) if mesh is not None and rows_split else None
    x_all = _gathered(x, dp, 0)
    x2d = x_all.reshape(-1, d)
    y = _experts_out(params, x2d, cfg, mesh, _capacity(x2d.shape[0], cfg, cfg.n_experts),
                     gather_weights=torch.is_grad_enabled(), lay=lay)
    if dp is not None and dp.size > 1:
        y = y.reshape(dp.size, B * S, d)[dp.index]
    return _with_shared(params, y, x, lay)


def moe_ffn_sharded(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh,
                    lay: Layout = WHOLE) -> torch.Tensor:
    """The reference's expert-parallel MoE on this rank: ``x`` is its rows
    (split over the data axes), the capacity that of its data shard's
    ``t_loc`` tokens, its experts' share summed over ``model``."""
    B_loc, S, d = x.shape
    t_loc = max(1, B_loc * S)  # (B * S) // n_dp of the reference
    y = _experts_out(params, x.reshape(-1, d), cfg, mesh,
                     _capacity(t_loc, cfg, cfg.n_experts), lay=lay)
    return _with_shared(params, y, x, lay)


def moe_ffn(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh=None,
            lay: Layout = WHOLE) -> torch.Tensor:
    """``moe_ffn_sharded`` where ``ep_sharded`` on ``mesh``, else
    ``moe_ffn_dense`` (over the whole batch), as the reference's."""
    if ep_sharded(cfg, mesh):
        return moe_ffn_sharded(params, x, cfg, mesh, lay)
    return moe_ffn_dense(params, x, cfg, mesh, lay=lay)
