"""xLSTM blocks: the chunkwise-parallel mLSTM (matrix memory) and the
recurrent sLSTM -- the JAX package's ``models/xlstm.py``, function for
function.

The mLSTM keeps a per-head matrix state ``C (dv x dk)``, a normalizer
``N (dk)`` and a stabilizer ``m``; the chunkwise form computes the
interactions inside a chunk with a decay-masked quadratic and carries
(C, N, m) across chunks. Where the reference scans over the chunks
(``lax.scan``), the port loops over them in Python; the sLSTM (exponential
gating with a normalizer and a stabilizer) is sequential in time and runs
as a Python loop over the steps. The chunk arithmetic is f32 and runs in
full f32 on the card (``full_f32_matmul``).

The forms that change bits or NaN are the reference's: ``q * (1/dh**0.5)``
in the chunk but ``q / dh**0.5`` in decode, the ``-inf`` causal mask, the
``-1e30`` initial stabilizer, ``n_inter``'s ``... * 0 + ...`` (NaN where
the reference's is), ``log_sigmoid`` for the forget gate, and the sLSTM's
recurrent product: ``h`` rounded to the input's dtype before ``w_rec``,
the two products summed in that dtype before the cast to f32 and the
bias. The sLSTM's input product ``x @ w_in`` is taken for every step at
once, before the loop (one product where the reference makes one a step:
the same sums, in another blocking).

The decode functions update the state they are given in place (the
tensors of ``state``, views of the model's cache in ``XLSTMLM.decode``)
and return it, where the reference returns new states; the values are the
reference's.

Over a mesh of ranks (a ``Layout``) every leaf is this rank's block by the
rules: ``inner`` splits over ``model`` (the mLSTM's inner width, the
sLSTM's ``4d`` gate columns and its ``down``'s rows) and ``wembed`` over
the data axes; the heads stay whole (xlstm-125m's overrides) and so does
every recurrent state (the cache names no ``inner``):

* mLSTM: ``up``'s blocks of columns are gathered and each rank keeps both
  halves of its own inner channels (``layers.fused_halves``); ``wq``,
  ``wk``, ``wv`` and ``w_if`` are row-parallel over those channels
  (``layers.row_parallel``: f32 partials summed in f32, rounded once), q,
  k and v summed over ``model`` in one all-reduce and the gates in
  another. The chunked recurrence then runs alike on
  every ``model`` rank over the whole heads; its whole ``h`` enters the
  rank's channels for ``h * silu(z)`` through ``Layout.enter`` (the
  ranks' cotangents summed) into the row-parallel ``down``, summed over
  ``model``.
* sLSTM: a contiguous block of the ``4d`` gate columns holds whole gates,
  not channels, so ``w_in``, ``w_rec`` and ``b`` are gathered whole over
  ``model`` once a layer (``Layout.gather_invariant``: every rank then
  computes the same whole gradient, and its backward keeps the rank's
  block of it) and the recurrence runs alike on every ``model`` rank --
  one collective a layer where splitting the gates would take one a time
  step. Its whole ``h`` enters the rank's rows of ``down`` as the mLSTM's
  does (both ``down`` products ``row_parallel``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout
from .layers import _dtype, _matmul, _proj, cut, fused_halves, make, row_parallel, zeros

STAB_INIT = -1e30  # the stabilizers' initial value (init_*_state, the mixers)


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    di = cfg.d_inner
    dh = di // H
    dt = _dtype(cfg)
    dev = device or gen.device
    p = dict(
        up=make(gen, (d, 2 * di), ("wembed", "inner"), 1.0, dt, device),
        wq=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        wk=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        wv=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        w_if=make(gen, (di, 2 * H), ("inner", None), 1.0, torch.float32, device),
        b_if=zeros((2 * H,), (None,), device=dev),
        down=make(gen, (di, d), ("inner", "wembed"), 1.0, dt, device),
    )
    return {k: cut(v, lay) for k, v in p.items()}


def _mlstm_chunk(q, k, v, li, lf, state):
    """One chunk. q, k, v: (B, L, H, dh); li, lf: (B, L, H); state: (C, N, m)."""
    B, L, H, dh = q.shape
    C_prev, N_prev, m_prev = state  # (B, H, dh, dh), (B, H, dh), (B, H)
    Fc = torch.cumsum(lf, dim=1)  # (B, L, H) cumulative log-forget
    # intra-chunk decay D[t, tau] = F_t - F_tau + li_tau  (tau <= t)
    Dm = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]  # (B, t, tau, H)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    Dm = torch.where(tri[None, :, :, None], Dm, -torch.inf)
    # stabilizer
    m_intra = torch.amax(Dm, dim=2)  # (B, t, H)
    m_inter = m_prev[:, None, :] + Fc  # (B, t, H)
    m_t = torch.maximum(m_intra, m_inter)
    scale = 1.0 / dh**0.5
    qs, kf, vf = q.float() * scale, k.float(), v.float()
    s = torch.einsum("blhd,bmhd->blmh", qs, kf)
    decay = torch.exp(Dm - m_t[:, :, None, :])  # (B, t, tau, H)
    h_intra = torch.einsum("blmh,bmhd->blhd", s * decay, vf)
    n_intra = torch.einsum("blmh,bmhd->blhd", decay, kf)
    inter_scale = torch.exp(m_inter - m_t)  # (B, t, H)
    h_inter = torch.einsum("blhd,bhed->blhe", qs, C_prev) * inter_scale[..., None]
    qN = torch.einsum("blhd,bhd->blh", qs, N_prev)
    n_inter = qN[..., None] * 0 + (qN * inter_scale)[..., None]
    h_num = h_intra + h_inter  # (B, t, H, dh)
    qn = torch.einsum("blhd,blhd->blh", qs, n_intra) + n_inter[..., 0]
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))[..., None]
    h = h_num / denom
    # carry the state to the chunk's end
    F_end = Fc[:, -1:, :]  # (B, 1, H)
    m_end = torch.maximum(m_prev + F_end[:, 0], torch.amax(li + (F_end - Fc), dim=1))
    decay_out = torch.exp(li + F_end - Fc - m_end[:, None, :])  # (B, L, H)
    carry = torch.exp(m_prev + F_end[:, 0] - m_end)
    C_new = carry[:, :, None, None] * C_prev + torch.einsum(
        "blhe,blhd->bhed", decay_out[..., None] * vf, kf)
    N_new = carry[:, :, None] * N_prev + torch.einsum("blh,blhd->bhd", decay_out, kf)
    return h, (C_new, N_new, m_end)


def _gates(xi: torch.Tensor, params: Dict, H: int, lay: Layout = WHOLE):
    """The log input gate and the log-sigmoid forget gate, f32 (``w_if``
    row-parallel over the rank's channels ``xi``, summed over ``model``)."""
    gates = row_parallel(xi.float(), params["w_if"], lay, "inner") + params["b_if"]  # (..., 2H)
    return gates[..., :H], F.logsigmoid(gates[..., H:])


def _up(params: Dict, x: torch.Tensor, lay: Layout):
    """``(xi, z)``: the rank's inner channels of both halves of ``x @ up``."""
    return fused_halves(_matmul(lay.enter("inner", x), lay.whole(params["up"], 0)), lay)


def _qkv(params: Dict, xi: torch.Tensor, lay: Layout):
    """q, k, v (..., H, dh), whole: the row-parallel products of the rank's
    channels ``xi``, summed over ``model`` in one all-reduce (in f32, as
    ``layers.row_parallel``)."""
    ws = [params[n] for n in ("wq", "wk", "wv")]
    if lay.axis("inner") is None:
        return [_proj(xi, w) for w in ws]
    di, H, dh = ws[0].shape
    w = torch.stack(ws, 1).reshape(di, 3 * H * dh)
    qkv = row_parallel(xi, w, lay, "inner").unflatten(-1, (3, H, dh))
    return qkv.unbind(-3)


def _down(params: Dict, h: torch.Tensor, z: torch.Tensor, lay: Layout) -> torch.Tensor:
    """``(h * silu(z)) @ down``: ``h`` (the same on every ``model`` rank)
    enters the rank's ``z.shape[-1]`` channels, the product row-parallel
    and summed over ``model``."""
    h = lay.own("inner", lay.enter("inner", h), z.shape[-1])
    return row_parallel(h * F.silu(z), lay.whole(params["down"], 1), lay, "inner")


def mlstm_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                lay: Layout = WHOLE) -> torch.Tensor:
    B, S, d = x.shape
    H = cfg.n_heads
    di = cfg.d_inner
    dh = di // H
    xi, z = _up(params, x, lay)
    q, k, v = _qkv(params, xi, lay)
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"the sequence ({S}) is not a multiple of the mLSTM chunk ({L})")
    dev = x.device
    state = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((B, H, dh), dtype=torch.float32, device=dev),
             torch.full((B, H), STAB_INIT, dtype=torch.float32, device=dev))
    hs = []
    with full_f32_matmul():
        li, lf = _gates(xi, params, H, lay)  # (B, S, H) each
        for c in range(S // L):
            t = slice(c * L, (c + 1) * L)
            h, state = _mlstm_chunk(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], state)
            hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, di)
    return _down(params, h.to(x.dtype), z, lay)


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    dh = cfg.d_inner // H
    return dict(
        C=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        N=torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, H), STAB_INIT, dtype=torch.float32, device=device),
    )


def mlstm_decode(params: Dict, x: torch.Tensor, state: Dict, cfg: ArchConfig,
                 lay: Layout = WHOLE):
    """One recurrent mLSTM step. x: (B, 1, d). Returns ``(y, state)``,
    ``state``'s ``C``, ``N`` and ``m`` written in place."""
    B = x.shape[0]
    H = cfg.n_heads
    dh = cfg.d_inner // H
    xi, z = _up(params, x[:, 0], lay)
    q, k, v = _qkv(params, xi, lay)
    q = q.float() / dh**0.5  # (B, H, dh)
    k, v = k.float(), v.float()
    C, N, m = state["C"], state["N"], state["m"]
    with full_f32_matmul():
        li, lf = _gates(xi, params, H, lay)
        m_new = torch.maximum(lf + m, li)
        i_g = torch.exp(li - m_new)
        f_g = torch.exp(lf + m - m_new)
        # f * C + i * (v k^T), the reference's two products and one sum, in place
        C.mul_(f_g[..., None, None]).add_(i_g[..., None, None] * (v[..., :, None] * k[..., None, :]))
        N.mul_(f_g[..., None]).add_(i_g[..., None] * k)
        m.copy_(m_new)
        qn = torch.einsum("bhd,bhd->bh", q, N)
        h = torch.einsum("bhd,bhed->bhe", q, C) / torch.maximum(torch.abs(qn),
                                                              torch.exp(-m_new))[..., None]
    h = h.reshape(B, cfg.d_inner).to(x.dtype)
    return _down(params, h, z, lay)[:, None], state


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    d = cfg.d_model
    dt = _dtype(cfg)
    dev = device or gen.device
    p = dict(
        w_in=make(gen, (d, 4 * d), ("wembed", "inner"), 1.0, dt, device),
        w_rec=make(gen, (d, 4 * d), ("wembed", "inner"), 1.0, dt, device),
        b=zeros((4 * d,), ("inner",), device=dev),
        down=make(gen, (d, d), ("inner", "wembed"), 1.0, dt, device),
    )
    return {k: cut(v, lay) for k, v in p.items()}


def _slstm_weights(params: Dict, lay: Layout) -> Dict:
    """``w_in``, ``w_rec`` and ``b`` whole: gathered over the data axes
    (ZeRO-3), then over ``model`` once a layer for a recurrence that runs
    alike on every ``model`` rank (``gather_invariant``)."""
    def whole(name, dim):
        w = params[name] if name == "b" else lay.whole(params[name], 0)
        return lay.gather_invariant("inner", w, dim)

    return dict(w_in=whole("w_in", 1), w_rec=whole("w_rec", 1), b=whole("b", 0))


def _slstm_step(params: Dict, carry, x_w: torch.Tensor):
    """carry: (c, n, h, m) each (B, d) f32; ``x_w``: the step's input
    already multiplied by ``w_in`` (B, 4d), in the input's dtype."""
    c, n, h, m = carry
    pre = (x_w + h.to(x_w.dtype) @ params["w_rec"]).float() + params["b"]
    zi, ii, fi, oi = torch.chunk(pre, 4, dim=-1)
    m_new = torch.maximum(fi + m, ii)
    i_g = torch.exp(ii - m_new)
    f_g = torch.exp(fi + m - m_new)
    z = torch.tanh(zi)
    o = torch.sigmoid(oi)
    c_new = f_g * c + i_g * z
    n_new = f_g * n + i_g
    # a maximum against a tensor: NaN propagates and a tie at 1 splits the
    # gradient, as jnp.maximum (the first step's n is exactly 1)
    h_new = o * c_new / torch.maximum(n_new, n_new.new_ones(()))
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_down(params: Dict, h: torch.Tensor, lay: Layout) -> torch.Tensor:
    """``h @ down``: ``h`` (the same on every ``model`` rank) enters the
    rank's rows of ``down``, the product summed over ``model``."""
    h = lay.own("inner", lay.enter("inner", h), params["down"].shape[0])
    return row_parallel(h, lay.whole(params["down"], 1), lay, "inner")


def slstm_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                lay: Layout = WHOLE) -> torch.Tensor:
    B, S, d = x.shape
    dev = x.device
    carry = tuple(torch.zeros((B, d), dtype=torch.float32, device=dev) for _ in range(3)) + (
        torch.full((B, d), STAB_INIT, dtype=torch.float32, device=dev),)
    w = _slstm_weights(params, lay)
    x_w = x @ w["w_in"]  # (B, S, 4d): every step's input product at once
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(w, carry, x_w[:, t])
        hs.append(h_t)
    return _slstm_down(params, torch.stack(hs, dim=1).to(x.dtype), lay)


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return dict(
        c=torch.zeros((batch, d), dtype=torch.float32, device=device),
        n=torch.zeros((batch, d), dtype=torch.float32, device=device),
        h=torch.zeros((batch, d), dtype=torch.float32, device=device),
        m=torch.full((batch, d), STAB_INIT, dtype=torch.float32, device=device),
    )


def slstm_decode(params: Dict, x: torch.Tensor, state: Dict, cfg: ArchConfig,
                 lay: Layout = WHOLE):
    """One sLSTM step. x: (B, 1, d). Returns ``(y, state)``, ``state``'s
    ``c``, ``n``, ``h`` and ``m`` written in place."""
    w = _slstm_weights(params, lay)
    carry, h = _slstm_step(w, (state["c"], state["n"], state["h"], state["m"]),
                           x[:, 0] @ w["w_in"])
    for name, value in zip("cnhm", carry):
        state[name].copy_(value)
    return _slstm_down(params, h.to(x.dtype), lay)[:, None], state
