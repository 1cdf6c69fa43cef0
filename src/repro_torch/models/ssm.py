"""Mamba selective-SSM block (the hybrid family's sequence mixer) -- the JAX
package's ``models/ssm.py``, function for function.

The sequence runs in chunks of ``cfg.ssm_chunk``; within a chunk the
linear recurrence ``h_t = dA_t * h_{t-1} + dB_t x_t`` runs as a log-depth
associative scan over the ``(B, Lc, d_inner, d_state)`` f32 planes
(``_ssm_scan``, JAX's own ``associative_scan`` recursion: pairs combined,
the half scanned, the rest combined and interleaved), and a Python loop
over the chunks carries the state, where the reference scans over them
(``lax.scan``). The depthwise causal conv is ``d_conv`` shifted
multiplies summed in the reference's order.

The forms that change bits are the reference's: the conv, ``dt``, ``h``
and ``y`` are f32, ``x_c`` is rounded to the model's dtype before
``x_proj``, softplus is ``logaddexp(x, 0)`` (not ``F.softplus`` with its
threshold), and the f32 products (``dt_in @ dt_proj``, the state's
contraction with ``C``, decode's conv window) run in full f32 on the card
(``full_f32_matmul``).

``mamba_decode`` updates the state it is given in place (``h`` and
``conv``, views of the model's cache in ``HybridLM.decode``) and returns
it, where the reference returns a new state; the values are the
reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from .layers import Param, _dtype, _matmul, make, zeros


def init_mamba(gen, cfg: ArchConfig, device=None) -> Dict:
    d, di, ds, dc, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, cfg.dt_rank
    dt = _dtype(cfg)
    dev = device or gen.device
    f32 = torch.float32
    a = torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev)).expand(di, ds).contiguous()
    return dict(
        in_proj=make(gen, (d, 2 * di), ("wembed", "inner"), 1.0, dt, device),
        conv_w=make(gen, (dc, di), ("conv", "inner"), 1.0, f32, device),
        conv_b=zeros((di,), ("inner",), device=dev),
        x_proj=make(gen, (di, dtr + 2 * ds), ("inner", None), 1.0, dt, device),
        dt_proj=make(gen, (dtr, di), (None, "inner"), 1.0, f32, device),
        dt_bias=zeros((di,), ("inner",), device=dev),
        A_log=Param(a, ("inner", "state")),
        D=Param(torch.ones((di,), dtype=f32, device=dev), ("inner",)),
        out_proj=make(gen, (di, d), ("inner", "wembed"), 1.0, dt, device),
    )


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, ``max(x, 0) +
    log1p(exp(-|x|))`` (NaN stays NaN)."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, di); w: (dc, di) -> the causal depthwise conv as shifts,
    summed in the reference's order."""
    dc = w.shape[0]
    out = x * w[-1]
    for j in range(1, dc):
        shifted = F.pad(x, (0, 0, j, 0))[:, : x.shape[1]]
        out = out + shifted * w[dc - 1 - j]
    return out + b


def _combine(a, b):
    """The scan's operator on ``(dA, dBx)`` pairs: ``(a1 a2, a2 b1 + b2)``."""
    (a1, b1), (a2, b2) = a, b
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even`` at the even positions of axis 1, ``odd`` at the odd ones."""
    n = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], n) + tuple(even.shape[2:]), dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(elems):
    """``jax.lax.associative_scan(_combine, elems, axis=1)``, the same tree
    of combines (so the same f32 roundings): adjacent pairs combined, the
    half scanned by recursion, each remaining element combined with the
    scan before it, the two interleaved."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = _scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _ssm_scan(dA: torch.Tensor, dBx: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan of ``h_t = dA_t h_{t-1} + dBx_t`` within a chunk.

    dA, dBx: (B, L, di, ds); h0: (B, di, ds). Returns (h (B, L, di, ds),
    h_last)."""
    prod_a, h = _scan([dA, dBx])
    h = h + prod_a * h0[:, None]
    return h, h[:, -1]


def mamba_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The full-sequence (training and prefill) mixer. x: (B, S, d)."""
    B, S, d = x.shape
    di, ds, dtr = cfg.d_inner, cfg.d_state, cfg.dt_rank
    x_in, z = torch.chunk(_matmul(x, params["in_proj"]), 2, dim=-1)
    x_c = F.silu(_causal_conv(x_in.float(), params["conv_w"], params["conv_b"]))
    bcdt = _matmul(x_c.to(x.dtype), params["x_proj"])
    dt_in, Bm, Cm = bcdt[..., :dtr], bcdt[..., dtr:dtr + ds], bcdt[..., dtr + ds:]
    with full_f32_matmul():
        dt = softplus(dt_in.float() @ params["dt_proj"] + params["dt_bias"])  # (B, S, di)
    A = -torch.exp(params["A_log"])  # (di, ds)

    Lc = min(cfg.ssm_chunk, S)
    if S % Lc:
        raise ValueError(f"the sequence ({S}) is not a multiple of the SSM chunk ({Lc})")
    h = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(S // Lc):
        t = slice(c * Lc, (c + 1) * Lc)
        dt_c = dt[:, t]
        dA = torch.exp(dt_c[..., None] * A)  # (B, Lc, di, ds)
        dBx = (dt_c * x_c[:, t])[..., None] * Bm[:, t, None, :].float()
        hs, h = _ssm_scan(dA, dBx, h)
        del dA, dBx
        with full_f32_matmul():
            ys.append(torch.einsum("blds,bls->bld", hs, Cm[:, t].float()))
        del hs
    y = torch.cat(ys, dim=1) + params["D"] * x_c
    y = (y * F.silu(z.float())).to(x.dtype)
    return _matmul(y, params["out_proj"])


def init_mamba_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return dict(
        h=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch.float32,
                         device=device),
    )


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent step. x: (B, 1, d). Returns ``(y, state)``, ``state``'s
    ``h`` and ``conv`` written in place."""
    ds, dtr = cfg.d_state, cfg.dt_rank
    x_in, z = torch.chunk(_matmul(x[:, 0], params["in_proj"]), 2, dim=-1)
    window = torch.cat([state["conv"], x_in.float()[:, None]], dim=1)  # (B, dc, di)
    with full_f32_matmul():
        conv_out = torch.einsum("bcd,cd->bd", window, params["conv_w"]) + params["conv_b"]
    x_c = F.silu(conv_out)
    bcdt = _matmul(x_c.to(x.dtype), params["x_proj"])
    dt_in, Bm, Cm = bcdt[..., :dtr], bcdt[..., dtr:dtr + ds], bcdt[..., dtr + ds:]
    with full_f32_matmul():
        dt = softplus(dt_in.float() @ params["dt_proj"] + params["dt_bias"])  # (B, di)
    A = -torch.exp(params["A_log"])
    dA = torch.exp(dt[..., None] * A)  # (B, di, ds)
    dBx = (dt * x_c)[..., None] * Bm[:, None, :].float()
    h = state["h"]
    h.mul_(dA).add_(dBx)  # dA * h + dBx, the reference's product and sum, in place
    state["conv"].copy_(window[:, 1:])
    with full_f32_matmul():
        y = torch.einsum("bds,bs->bd", h, Cm.float()) + params["D"] * x_c
    y = (y * F.silu(z.float())).to(x.dtype)
    return _matmul(y, params["out_proj"])[:, None], state
