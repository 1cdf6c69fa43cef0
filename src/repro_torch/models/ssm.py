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

Over a mesh of ranks (a ``Layout``) every leaf is this rank's block by
the rules: ``inner`` (``d_inner``) splits over ``model`` and ``wembed``
over the data axes. ``in_proj``'s stored block is a contiguous block of
its ``2 * d_inner`` columns, so the product's blocks are gathered and each
rank keeps both halves of its own channels (``layers.fused_halves``). The
conv, ``dt``, the scan and the state (``h`` and ``conv``, the cache's
``inner`` blocks) then work on the rank's ``d_inner / model`` channels:
``x_proj`` is row-parallel (its ``dt_rank + 2 * d_state`` outputs summed
over ``model``, entering the channel-local region again through
``Layout.enter``), ``dt_proj`` column-parallel and ``out_proj``
row-parallel, summed over ``model``; both row-parallel sums are
``layers.row_parallel``'s (f32 partials summed in f32 and rounded once,
as one device rounds its product once: ``dt``'s path through softplus and
the scan's decay is where a bf16 rounding per rank shows most).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import full_f32_matmul
from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout
from .layers import Param, _dtype, _matmul, cut, fused_halves, make, row_parallel, zeros


def init_mamba(gen, cfg: ArchConfig, device=None, lay: Layout = WHOLE) -> Dict:
    """The mixer's parameters, each ``lay``'s block (drawn whole and cut)."""
    d, di, ds, dc, dtr = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv, cfg.dt_rank
    dt = _dtype(cfg)
    dev = device or gen.device
    f32 = torch.float32
    a = torch.log(torch.arange(1, ds + 1, dtype=f32, device=dev)).expand(di, ds).contiguous()
    p = dict(
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
    return {k: cut(v, lay) for k, v in p.items()}


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


def _in_proj(params: Dict, x: torch.Tensor, lay: Layout):
    """``(x_in, z)``: the rank's channels of both halves of ``x @ in_proj``
    (``x`` the same on every ``model`` rank, entering the rank's columns)."""
    return fused_halves(_matmul(lay.enter("inner", x), lay.whole(params["in_proj"], 0)), lay)


def _x_proj(params: Dict, x_c: torch.Tensor, lay: Layout) -> torch.Tensor:
    """``x_c @ x_proj``: row-parallel over the rank's channels, summed over
    ``model``; every rank then reads the whole of it for its own channels
    (``enter``: their cotangents are summed)."""
    return lay.enter("inner", row_parallel(x_c, params["x_proj"], lay, "inner"))


def _out_proj(params: Dict, y: torch.Tensor, lay: Layout) -> torch.Tensor:
    return row_parallel(y, lay.whole(params["out_proj"], 1), lay, "inner")


def mamba_mixer(params: Dict, x: torch.Tensor, cfg: ArchConfig,
                lay: Layout = WHOLE) -> torch.Tensor:
    """The full-sequence (training and prefill) mixer. x: (B, S, d)."""
    B, S, d = x.shape
    ds, dtr = cfg.d_state, cfg.dt_rank
    di = params["D"].shape[0]  # the rank's channels
    x_in, z = _in_proj(params, x, lay)
    x_c = F.silu(_causal_conv(x_in.float(), params["conv_w"], params["conv_b"]))
    bcdt = _x_proj(params, x_c.to(x.dtype), lay)
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
    return _out_proj(params, y, lay)


def init_mamba_state(cfg: ArchConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
    return dict(
        h=torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=torch.float32,
                         device=device),
    )


def mamba_decode(params: Dict, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ArchConfig, lay: Layout = WHOLE
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One recurrent step. x: (B, 1, d). Returns ``(y, state)``, ``state``'s
    ``h`` and ``conv`` written in place (over a mesh the rank's channels of
    them)."""
    ds, dtr = cfg.d_state, cfg.dt_rank
    x_in, z = _in_proj(params, x[:, 0], lay)
    window = torch.cat([state["conv"], x_in.float()[:, None]], dim=1)  # (B, dc, di)
    with full_f32_matmul():
        conv_out = torch.einsum("bcd,cd->bd", window, params["conv_w"]) + params["conv_b"]
    x_c = F.silu(conv_out)
    bcdt = _x_proj(params, x_c.to(x.dtype), lay)
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
    return _out_proj(params, y, lay)[:, None], state
