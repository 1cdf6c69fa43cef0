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
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from .layers import _dtype, _matmul, _proj, make, zeros

STAB_INIT = -1e30  # the stabilizers' initial value (init_*_state, the mixers)


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen, cfg: ArchConfig, device=None) -> Dict:
    d, H = cfg.d_model, cfg.n_heads
    di = cfg.d_inner
    dh = di // H
    dt = _dtype(cfg)
    dev = device or gen.device
    return dict(
        up=make(gen, (d, 2 * di), ("wembed", "inner"), 1.0, dt, device),
        wq=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        wk=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        wv=make(gen, (di, H, dh), ("inner", "heads", "head_dim"), 1.0, dt, device),
        w_if=make(gen, (di, 2 * H), ("inner", None), 1.0, torch.float32, device),
        b_if=zeros((2 * H,), (None,), device=dev),
        down=make(gen, (di, d), ("inner", "wembed"), 1.0, dt, device),
    )


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


def _gates(xi: torch.Tensor, params: Dict, H: int):
    """The log input gate and the log-sigmoid forget gate, f32."""
    gates = xi.float() @ params["w_if"] + params["b_if"]  # (..., 2H)
    return gates[..., :H], F.logsigmoid(gates[..., H:])


def mlstm_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S, d = x.shape
    H = cfg.n_heads
    di = cfg.d_inner
    dh = di // H
    xi, z = torch.chunk(_matmul(x, params["up"]), 2, dim=-1)
    q = _proj(xi, params["wq"])
    k = _proj(xi, params["wk"])
    v = _proj(xi, params["wv"])
    L = min(cfg.ssm_chunk, S)
    if S % L:
        raise ValueError(f"the sequence ({S}) is not a multiple of the mLSTM chunk ({L})")
    dev = x.device
    state = (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev),
             torch.zeros((B, H, dh), dtype=torch.float32, device=dev),
             torch.full((B, H), STAB_INIT, dtype=torch.float32, device=dev))
    hs = []
    with full_f32_matmul():
        li, lf = _gates(xi, params, H)  # (B, S, H) each
        for c in range(S // L):
            t = slice(c * L, (c + 1) * L)
            h, state = _mlstm_chunk(q[:, t], k[:, t], v[:, t], li[:, t], lf[:, t], state)
            hs.append(h)
    h = torch.cat(hs, dim=1).reshape(B, S, di)
    return _matmul(h.to(x.dtype) * F.silu(z), params["down"])


def init_mlstm_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    H = cfg.n_heads
    dh = cfg.d_inner // H
    return dict(
        C=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        N=torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
        m=torch.full((batch, H), STAB_INIT, dtype=torch.float32, device=device),
    )


def mlstm_decode(params: Dict, x: torch.Tensor, state: Dict, cfg: ArchConfig):
    """One recurrent mLSTM step. x: (B, 1, d). Returns ``(y, state)``,
    ``state``'s ``C``, ``N`` and ``m`` written in place."""
    B = x.shape[0]
    H = cfg.n_heads
    dh = cfg.d_inner // H
    xi, z = torch.chunk(_matmul(x[:, 0], params["up"]), 2, dim=-1)
    q = _proj(xi, params["wq"]).float() / dh**0.5  # (B, H, dh)
    k = _proj(xi, params["wk"]).float()
    v = _proj(xi, params["wv"]).float()
    C, N, m = state["C"], state["N"], state["m"]
    with full_f32_matmul():
        li, lf = _gates(xi, params, H)
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
    y = _matmul(h * F.silu(z), params["down"])[:, None]
    return y, state


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen, cfg: ArchConfig, device=None) -> Dict:
    d = cfg.d_model
    dt = _dtype(cfg)
    dev = device or gen.device
    return dict(
        w_in=make(gen, (d, 4 * d), ("wembed", "inner"), 1.0, dt, device),
        w_rec=make(gen, (d, 4 * d), ("wembed", "inner"), 1.0, dt, device),
        b=zeros((4 * d,), ("inner",), device=dev),
        down=make(gen, (d, d), ("inner", "wembed"), 1.0, dt, device),
    )


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


def slstm_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S, d = x.shape
    dev = x.device
    carry = tuple(torch.zeros((B, d), dtype=torch.float32, device=dev) for _ in range(3)) + (
        torch.full((B, d), STAB_INIT, dtype=torch.float32, device=dev),)
    x_w = x @ params["w_in"]  # (B, S, 4d): every step's input product at once
    hs = []
    for t in range(S):
        carry, h_t = _slstm_step(params, carry, x_w[:, t])
        hs.append(h_t)
    h = torch.stack(hs, dim=1).to(x.dtype)
    return h @ params["down"]


def init_slstm_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return dict(
        c=torch.zeros((batch, d), dtype=torch.float32, device=device),
        n=torch.zeros((batch, d), dtype=torch.float32, device=device),
        h=torch.zeros((batch, d), dtype=torch.float32, device=device),
        m=torch.full((batch, d), STAB_INIT, dtype=torch.float32, device=device),
    )


def slstm_decode(params: Dict, x: torch.Tensor, state: Dict, cfg: ArchConfig):
    """One sLSTM step. x: (B, 1, d). Returns ``(y, state)``, ``state``'s
    ``c``, ``n``, ``h`` and ``m`` written in place."""
    x_t = x[:, 0]
    carry, h = _slstm_step(params, (state["c"], state["n"], state["h"], state["m"]),
                           x_t @ params["w_in"])
    for name, value in zip("cnhm", carry):
        state[name].copy_(value)
    y = (h.to(x.dtype) @ params["down"])[:, None]
    return y, state
