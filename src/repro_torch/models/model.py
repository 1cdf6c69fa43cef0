"""Model assembly -- the JAX package's ``models/model.py``: init, the
training loss, prefill and cached decode of each family.

Families served here:
  dense, vlm  -- a GQA decoder-only stack (``vlm`` prepends stub patch
                 embeddings)
  moe         -- every layer's FFN is a shared + routed MoE (qwen2-moe)
  mla_moe     -- MLA attention, leading dense layers, then MoE layers, and
                 a multi-token-prediction (MTP) block in the loss
                 (deepseek-v3)
  encdec      -- whisper: a bidirectional encoder over stub frame
                 embeddings and a causal decoder with cross attention
  xlstm       -- a repeating unit of mLSTM layers and one sLSTM layer
  hybrid      -- jamba: a superblock of ``attn_every`` layers, Mamba
                 mixers and one attention layer, an MoE FFN on every
                 ``moe_every``-th layer

A model is an ``nn.Module`` (``DecoderOnlyLM``, ``EncDecLM``, ``XLSTMLM``,
``HybridLM``) whose parameters sit under the reference's tree paths
(``embed.table``, ``head.w``, ``final_norm``, ``dense_blocks.attn.wq``,
``moe_blocks.moe.w_gate``, ``mtp.proj``, ``enc_blocks.ln1b``,
``dec_blocks.cross_attn.wk``, ``units.m0.core.w_if``,
``units.b0.mix.A_log``, ...), each layer stack with a leading ``layers``
(or ``repeat``) dimension, each parameter's logical spec kept beside it in
``specs``. Where the reference scans over a stack, the port loops over
layers in Python; where it wraps the scan body in ``jax.checkpoint``
(``cfg.remat == "full"``), the port wraps each layer (each xLSTM unit;
each block of a hybrid superblock) in ``torch.utils.checkpoint``.
``ModelBundle``'s functions keep the reference's names and wrap the
module. The parameters are registered without gradients; the training
steps turn them on.

A model built with a ``mesh`` (``build_model(cfg, mesh, rules)``) runs as
one rank of it, laid out as the reference's rules place it (a ``Layout``
from ``rules_layout``; ``layers.py``, ``moe.py``, ``ssm.py`` and
``xlstm.py`` say how each layer computes on its blocks): every leaf is
this rank's block, drawn whole from the single-device stream and cut, and
its batch rows are this rank's. Each layer's ``wembed`` blocks are gathered
over the data axes inside the layer, used and dropped (under
``remat="full"`` the recompute gathers them again; without remat autograd
keeps what the backward reads); the embedding, the head, the MTP block's
``proj`` and the final norm likewise. The MoE layers call ``moe_ffn(...,
mesh)`` where the reference does (decode's call ``moe_ffn_dense`` over the
whole batch).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..sharding.rules import WHOLE, Layout
from ..tree import module_tree
from . import layers as L
from . import mla as MLA
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .layers import Param, split_params


# ----------------------------------------------------------------- helpers
def stack_init(init_fn: Callable, n: int, axis_name: str = "layers"):
    """``n`` independent inits stacked into one Param tree with a leading
    ``axis_name`` dimension. Each layer is written into the stack as it is
    drawn, so only one layer's temporaries exist at a time; a stack of one
    is the layer itself with the dimension added (no copy)."""
    first = init_fn()
    if n == 1:
        return L.tree_map(lambda p: Param(p.value.unsqueeze(0), (axis_name,) + tuple(p.spec)),
                          first)
    stacked = L.tree_map(lambda p: Param(
        torch.empty((n,) + tuple(p.value.shape), dtype=p.value.dtype, device=p.value.device),
        (axis_name,) + tuple(p.spec)), first)

    def put(dst, src, i):
        if L.is_param(src):
            dst.value[i].copy_(src.value)
            return
        for k in src:
            put(dst[k], src[k], i)

    put(stacked, first, 0)
    del first
    for i in range(1, n):
        put(stacked, init_fn(), i)
    return stacked


def _norm(w, x):
    return L.rms_norm(x, w)


# ------------------------------------------------ decoder block (attn+ffn)
def _norm_param(cfg: ArchConfig, dev, lay: Layout = WHOLE) -> Param:
    return L.cut(L.ones((cfg.d_model,), ("embed",), device=dev), lay)


def _init_block(gen, cfg: ArchConfig, kind: str = "dense", device=None, lay: Layout = WHOLE):
    """kind: dense | moe | mla_dense | mla_moe, as the reference's; each
    leaf ``lay``'s block."""
    dev = device or gen.device
    p = dict(ln1=_norm_param(cfg, dev, lay), ln2=_norm_param(cfg, dev, lay))
    if kind.startswith("mla"):
        p["attn"] = MLA.init_mla(gen, cfg, device, lay)
    else:
        p["attn"] = L.init_attention(gen, cfg, device, lay)
    if kind.endswith("moe"):
        p["moe"] = MOE.init_moe(gen, cfg, device, lay=lay)
    else:
        p["ffn"] = L.init_ffn(gen, cfg, device=device, lay=lay)
    return p


def _apply_block(p, x, cfg: ArchConfig, kind: str = "dense", positions=None, mesh=None,
                 lay: Layout = WHOLE):
    h = _norm(p["ln1"], x)
    if kind.startswith("mla"):
        a = MLA.mla_attention(p["attn"], h, cfg, positions, lay)
    else:
        a = L.attention(p["attn"], h, cfg, positions, lay=lay)
    x = x + a
    h = _norm(p["ln2"], x)
    if kind.endswith("moe"):
        f = MOE.moe_ffn(p["moe"], h, cfg, mesh, lay)
    else:
        f = L.ffn(p["ffn"], h, lay)
    return x + f


def _decode_block(p, x, cache_k, cache_v, pos, cfg, kind: str = "dense", mesh=None,
                  rows_split: bool = True, lay: Layout = WHOLE, seq: str = "kv_seq"):
    h = _norm(p["ln1"], x)
    if kind.startswith("mla"):
        a, ck, cv = MLA.mla_decode(p["attn"], h, cache_k, cache_v, pos, cfg, lay, seq)
    else:
        a, ck, cv = L.decode_attention(p["attn"], h, cache_k, cache_v, pos, cfg, lay=lay,
                                       seq=seq)
    x = x + a
    h = _norm(p["ln2"], x)
    if kind.endswith("moe"):  # decode: a token a row
        f = MOE.moe_ffn_dense(p["moe"], h, cfg, mesh, rows_split, lay)
    else:
        f = L.ffn(p["ffn"], h, lay)
    return x + f, ck, cv


def block_kinds(cfg: ArchConfig):
    """``(dense_kind, moe_kind, n_dense, n_moe)`` of ``cfg``: the kinds of
    the two stacks and their layer counts, as ``build_decoder_only``'s; for
    the hybrid family the layers with a dense and with an MoE FFN."""
    if cfg.family == "hybrid":
        n_moe = cfg.n_layers // cfg.attn_every * len(hybrid_moe_positions(cfg))
        return "dense", "moe", cfg.n_layers - n_moe, n_moe
    is_mla = cfg.use_mla
    if cfg.n_experts:
        moe_kind = "mla_moe" if is_mla else "moe"
    else:
        moe_kind = "mla_dense" if is_mla else "dense"
    dense_kind = "mla_dense" if is_mla else "dense"
    n_dense = cfg.first_dense if cfg.n_experts else cfg.n_layers
    n_moe = cfg.n_layers - n_dense if cfg.n_experts else 0
    return dense_kind, moe_kind, n_dense, n_moe


def cache_names(cfg: ArchConfig):
    """The cache's two entries: the latent and rope key for MLA, else k, v."""
    return ("ckv", "kr") if cfg.use_mla else ("k", "v")


# ------------------------------------------------------------------ module
def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class _Node(nn.Module):
    """A plain container: one level of the parameter tree."""


class _TreeLM(nn.Module):
    """A model whose parameters are a Param tree's values under its paths
    (``tree`` is a Param tree, ``bundle.init_tree``'s), each spec in
    ``specs`` under the parameter's dotted name; with a ``lay`` over a
    mesh, one rank of it (the tree then holds the rank's blocks)."""

    def __init__(self, cfg: ArchConfig, tree: Dict, lay: Layout = WHOLE):
        super().__init__()
        self.cfg = cfg
        self.mesh = lay.mesh
        self.lay = lay
        values, spec_tree = split_params(tree)
        self.specs: Dict[str, tuple] = dict(_flatten(spec_tree))
        for name, value in _flatten(values):
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, _Node())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Dict:
        """The parameters as the reference's nested values dict."""
        return module_tree(self)

    def _remat(self) -> bool:
        # remat only where a backward will run: serving keeps no activations
        return self.cfg.remat == "full" and torch.is_grad_enabled()

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The head's logits of the final-normed ``h``, the whole
        vocabulary: over a mesh each rank's block of it gathered over
        ``model`` here (what a caller compares with one device)."""
        return self.lay.gather("vocab", L.lm_logits(dict(w=self.head.w), h, self.lay), -1)


def _stack(tree: Dict) -> list:
    """A stacked Param-values tree as one tree per layer, each leaf a view
    of its stack at the layer's index. One ``unbind`` a leaf, so the
    backward stacks the layers' gradients once instead of adding a
    stack-sized gradient per layer."""
    per_leaf = _unbind(tree)
    n = len(next(iter(_leaves(per_leaf))))
    return [_index(per_leaf, i) for i in range(n)]


class DecoderOnlyLM(_TreeLM):
    """A decoder-only model of the ``dense``, ``vlm``, ``moe`` or
    ``mla_moe`` family, its parameters under the reference's tree paths:
    ``dense_blocks`` (the leading dense layers, or every layer of a model
    without experts), ``moe_blocks`` (the MoE layers) and, with
    ``cfg.mtp_depth``, the ``mtp`` block."""

    def __init__(self, cfg: ArchConfig, tree: Dict, lay: Layout = WHOLE):
        super().__init__(cfg, tree, lay)
        self.dense_kind, self.moe_kind, _, _ = block_kinds(cfg)

    def _layers(self):
        """``(kind, layer parameters)`` of every layer, the dense stack
        first: each layer's parameters are views of its stack (``_stack``)."""
        tree = self.tree()
        out = []
        for name, kind in (("dense_blocks", self.dense_kind), ("moe_blocks", self.moe_kind)):
            if name in tree:
                out += [(kind, lp) for lp in _stack(tree[name])]
        return out

    def embed_inputs(self, batch: Dict):
        """The embedded inputs and where the text region starts (the
        patches' count for ``vlm``, else 0)."""
        x = L.embed_lookup(dict(table=self.embed.table), batch["tokens"], self.lay)
        loss_start = 0
        if self.cfg.family == "vlm" and "patches" in batch:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
            loss_start = batch["patches"].shape[1]
        return x, loss_start

    def backbone(self, x: torch.Tensor) -> torch.Tensor:
        remat = self._remat()
        for kind, lp in self._layers():
            args = (lp, x, self.cfg, kind, None, self.mesh, self.lay)
            x = checkpoint(_apply_block, *args, use_reentrant=False) if remat else \
                _apply_block(*args)
        return x

    def loss(self, batch: Dict) -> torch.Tensor:
        """The mean next-token cross entropy (0-d f32). For ``vlm`` with
        patches, over the text region only: the final norm and the head see
        ``x[:, loss_start:]``, as the reference. With ``cfg.mtp_depth``,
        plus ``0.3`` times the MTP block's cross entropy two tokens ahead."""
        lay = self.lay
        x, loss_start = self.embed_inputs(batch)
        x = self.backbone(x)
        tok = batch["tokens"]
        loss = _lm_losses(self, x[:, loss_start:], tok, lay)
        if self.cfg.mtp_depth and hasattr(self, "mtp"):
            mtp = self.tree()["mtp"]
            emb_next = L.embed_lookup(dict(table=self.embed.table), torch.roll(tok, -1, 1), lay)
            hcat = torch.cat([_norm(mtp["norm"], x[:, loss_start:]), emb_next], dim=-1)
            h2 = _apply_block(mtp["block"], hcat @ lay.whole(mtp["proj"], 0), self.cfg,
                              self.dense_kind, lay=lay)
            logits2 = L.lm_logits(dict(w=self.head.w), _norm(self.final_norm, h2), lay)
            loss = loss + 0.3 * L.softmax_xent(logits2[:, :-2], tok[:, 2:], lay)
        return loss

    def prefill(self, batch: Dict) -> torch.Tensor:
        """The last position's logits (B, 1, vocab), the whole vocabulary
        (``logits``); fills no cache."""
        x = self.backbone(self.embed_inputs(batch)[0])
        return self.logits(_norm(self.final_norm, x[:, -1:]))

    def decode(self, cache: Dict, tokens: torch.Tensor, pos: torch.Tensor,
               long_ctx: bool = False):
        """One token per row at position ``pos`` (a 0-d tensor): logits
        (B, 1, vocab), the whole vocabulary (``logits``), and the cache,
        layer ``i`` of it written in place (the dense layers first, as the
        reference concatenates them). On a mesh, ``long_ctx`` says the rows
        are the whole batch on every rank (else this rank's rows of it),
        which the MoE layers' capacity reads, and that the cache's slots
        split over every axis (``kv_seq_all``; else ``kv_seq``)."""
        a, b = cache_names(self.cfg)
        seq = _seq_name(long_ctx)
        x = L.embed_lookup(dict(table=self.embed.table), tokens, self.lay)
        for i, (kind, lp) in enumerate(self._layers()):
            x, _, _ = _decode_block(lp, x, cache[a][i], cache[b][i], pos, self.cfg, kind,
                                    self.mesh, not long_ctx, self.lay, seq)
        return self.logits(_norm(self.final_norm, x)), cache


def _lm_losses(model: _TreeLM, x, tokens, lay: Layout = WHOLE):
    """The next-token cross entropy of the backbone's output ``x`` over
    ``tokens`` (the text region's, aligned with ``x``)."""
    logits = L.lm_logits(dict(w=model.head.w), _norm(model.final_norm, x), lay)
    return L.softmax_xent(logits[:, :-1], tokens[:, 1:], lay)


def _unbind(v):
    if isinstance(v, dict):
        return {k: _unbind(u) for k, u in v.items()}
    if v.shape[0] == 1:
        return (v.squeeze(0),)  # a view: its backward copies nothing
    return torch.unbind(v, 0)


def _leaves(v):
    if isinstance(v, dict):
        for u in v.values():
            yield from _leaves(u)
    else:
        yield v


def _index(v, i):
    if isinstance(v, dict):
        return {k: _index(u, i) for k, u in v.items()}
    return v[i]


# ------------------------------------------------------------------ encdec
def _lnorm(w, b, x):
    return L.layer_norm(x, w, b)


def _enc_layer(lp, x, cfg: ArchConfig, lay: Layout = WHOLE):
    h = _lnorm(lp["ln1"], lp["ln1b"], x)
    x = x + L.attention(lp["attn"], h, cfg, causal=False, lay=lay)
    h = _lnorm(lp["ln2"], lp["ln2b"], x)
    return x + L.ffn(lp["ffn"], h, lay)


def _dec_layer(lp, x, enc_out, cfg: ArchConfig, lay: Layout = WHOLE):
    h = _lnorm(lp["ln1"], lp["ln1b"], x)
    x = x + L.attention(lp["self_attn"], h, cfg, causal=True, lay=lay)
    h = _lnorm(lp["ln2"], lp["ln2b"], x)
    x = x + L.attention(lp["cross_attn"], h, cfg, causal=False, kv_x=enc_out, lay=lay)
    h = _lnorm(lp["ln3"], lp["ln3b"], x)
    return x + L.ffn(lp["ffn"], h, lay)


def _seq_name(long_ctx: bool) -> str:
    """The logical name of a decode cache's slots: split over every axis
    for long-context decode, else over ``model``."""
    return "kv_seq_all" if long_ctx else "kv_seq"


class EncDecLM(_TreeLM):
    """The ``encdec`` family (whisper): ``enc_blocks`` (bidirectional
    self-attention and a GELU FFN) over stub frame embeddings, then
    ``enc_norm`` / ``enc_norm_b``; ``dec_blocks`` (causal self-attention,
    cross attention to the encoder's output, a GELU FFN), then
    ``final_norm`` / ``final_norm_b``. Every norm is a layer norm with a
    bias; positions are sinusoidal, added to the inputs."""

    def _run(self, layer, stack: str, x, *args):
        remat = self._remat()
        for lp in _stack(self.tree()[stack]):
            if remat:
                x = checkpoint(layer, lp, x, *args, self.cfg, self.lay, use_reentrant=False)
            else:
                x = layer(lp, x, *args, self.cfg, self.lay)
        return x

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, d) frames, in their own dtype: the encoder's output."""
        pe = L.sinusoidal_positions(frames.shape[1], self.cfg.d_model, frames.device)
        x = self._run(_enc_layer, "enc_blocks", frames + pe.to(frames.dtype))
        return _lnorm(self.enc_norm, self.enc_norm_b, x)

    def run_decoder(self, tokens: torch.Tensor, enc_out: torch.Tensor, pos0: int = 0):
        """The decoder's final-normed output for ``tokens`` at positions
        ``pos0`` on."""
        S = tokens.shape[1]
        x = L.embed_lookup(dict(table=self.embed.table), tokens, self.lay)
        pe = L.sinusoidal_positions(pos0 + S, self.cfg.d_model, x.device)[pos0:]
        x = self._run(_dec_layer, "dec_blocks", x + pe.to(x.dtype), enc_out)
        return _lnorm(self.final_norm, self.final_norm_b, x)

    def loss(self, batch: Dict) -> torch.Tensor:
        x = self.run_decoder(batch["tokens"], self.encode(batch["frames"]))
        logits = L.lm_logits(dict(w=self.head.w), x, self.lay)
        return L.softmax_xent(logits[:, :-1], batch["tokens"][:, 1:], self.lay)

    def prefill(self, batch: Dict) -> torch.Tensor:
        """The last position's logits (B, 1, vocab); fills no cache."""
        x = self.run_decoder(batch["tokens"], self.encode(batch["frames"]))
        return self.logits(x[:, -1:])

    def decode(self, cache: Dict, tokens: torch.Tensor, pos: torch.Tensor,
               long_ctx: bool = False):
        """One token per row at position ``pos`` (a 0-d tensor): logits
        (B, 1, vocab) and the cache, its self-attention ``k`` / ``v``
        written in place at ``pos``; the cross cache ``xk`` / ``xv`` is
        read (every slot) and returned unchanged. The position embedding is
        the table's row at ``pos`` clamped into the cache, as the
        reference's ``dynamic_slice``. Over a mesh every cache entry is the
        rank's block of the slots (``kv_seq``; ``kv_seq_all`` with
        ``long_ctx``): the table and the cross attention's last position
        are the cache's whole number of slots'."""
        cfg, lay = self.cfg, self.lay
        seq = _seq_name(long_ctx)
        x = L.embed_lookup(dict(table=self.embed.table), tokens, lay)
        S = cache["k"].shape[2] * lay.size(seq)
        idx = torch.clamp(pos.reshape(1).long(), 0, S - 1)
        pe = L.sinusoidal_positions(S, cfg.d_model, x.device).index_select(0, idx)
        x = x + pe[None].to(x.dtype)
        for i, lp in enumerate(_stack(self.tree()["dec_blocks"])):
            xk, xv = cache["xk"][i], cache["xv"][i]
            h = _lnorm(lp["ln1"], lp["ln1b"], x)
            a, _, _ = L.decode_attention(lp["self_attn"], h, cache["k"][i], cache["v"][i], pos,
                                         cfg, rope=False, lay=lay, seq=seq)
            x = x + a
            h = _lnorm(lp["ln2"], lp["ln2b"], x)
            a, _, _ = L.decode_attention(lp["cross_attn"], h, xk, xv,
                                         xk.shape[1] * lay.size(seq) - 1, cfg,
                                         update_cache=False, rope=False, lay=lay, seq=seq)
            x = x + a
            h = _lnorm(lp["ln3"], lp["ln3b"], x)
            x = x + L.ffn(lp["ffn"], h, lay)
        return self.logits(_lnorm(self.final_norm, self.final_norm_b, x)), cache


# ------------------------------------------------------------------- xlstm
def _unit_apply(up, x, cfg: ArchConfig, lay: Layout = WHOLE):
    unit = cfg.slstm_every
    for i in range(unit):
        if i == unit - 1:
            p = up[f"s{i}"]
            x = x + XL.slstm_mixer(p["core"], _norm(p["ln"], x), cfg, lay)
        else:
            p = up[f"m{i}"]
            x = x + XL.mlstm_mixer(p["core"], _norm(p["ln"], x), cfg, lay)
    return x


class XLSTMLM(_TreeLM):
    """The ``xlstm`` family: ``units``, a stack (leading ``repeat``
    dimension) of repeating units of ``cfg.slstm_every`` layers, the mLSTM
    layers ``m0 ...`` and the sLSTM layer last, each ``{ln, core}`` with a
    pre-norm residual."""

    def backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_lookup(dict(table=self.embed.table), tokens, self.lay)
        remat = self._remat()
        for up in _stack(self.tree()["units"]):
            if remat:
                x = checkpoint(_unit_apply, up, x, self.cfg, self.lay, use_reentrant=False)
            else:
                x = _unit_apply(up, x, self.cfg, self.lay)
        return x

    def loss(self, batch: Dict) -> torch.Tensor:
        return _lm_losses(self, self.backbone(batch["tokens"]), batch["tokens"], self.lay)

    def prefill(self, batch: Dict) -> torch.Tensor:
        """The last position's logits (B, 1, vocab); fills no state."""
        x = self.backbone(batch["tokens"])
        return self.logits(_norm(self.final_norm, x[:, -1:]))

    def decode(self, cache: Dict, tokens: torch.Tensor, pos: torch.Tensor,
               long_ctx: bool = False):
        """One token per row: logits (B, 1, vocab) and the cache, every
        layer's recurrent state (``C``, ``N``, ``m`` of the mLSTM layers;
        ``sc``, ``sn``, ``sh``, ``sm`` of the sLSTM's) updated in place,
        whole over ``model`` (over a mesh every ``model`` rank updates it
        alike). ``pos`` is not read (the state carries the position);
        ``long_ctx`` says the rows are the whole batch on every rank (the
        cache's batch is then whole)."""
        cfg, lay = self.cfg, self.lay
        last = cfg.slstm_every - 1
        x = L.embed_lookup(dict(table=self.embed.table), tokens, lay)
        for r, up in enumerate(_stack(self.tree()["units"])):
            for i in range(last):
                p = up[f"m{i}"]
                st = dict(C=cache["C"][r, i], N=cache["N"][r, i], m=cache["m"][r, i])
                x = x + XL.mlstm_decode(p["core"], _norm(p["ln"], x), st, cfg, lay)[0]
            p = up[f"s{last}"]
            st = dict(c=cache["sc"][r], n=cache["sn"][r], h=cache["sh"][r], m=cache["sm"][r])
            x = x + XL.slstm_decode(p["core"], _norm(p["ln"], x), st, cfg, lay)[0]
        return self.logits(_norm(self.final_norm, x)), cache


# ------------------------------------------------------------------ hybrid
def hybrid_attn_position(cfg: ArchConfig) -> int:
    """The attention layer's position in a hybrid superblock of
    ``attn_every`` layers: ``attn_every // 2 - 1`` (layer 3 of 8), as the
    reference's ``build_hybrid``; every other position is a Mamba mixer."""
    return cfg.attn_every // 2 - 1


def hybrid_moe_positions(cfg: ArchConfig) -> tuple:
    """The superblock positions with an MoE FFN: ``i % moe_every ==
    moe_every - 1`` (none without experts)."""
    if not cfg.n_experts:
        return ()
    return tuple(i for i in range(cfg.attn_every) if i % cfg.moe_every == cfg.moe_every - 1)


def _hybrid_block(bp, x, cfg: ArchConfig, attn: bool, moe: bool, mesh=None,
                  lay: Layout = WHOLE):
    h = _norm(bp["ln1"], x)
    x = x + (L.attention(bp["mix"], h, cfg, lay=lay) if attn
             else SSM.mamba_mixer(bp["mix"], h, cfg, lay))
    h = _norm(bp["ln2"], x)
    return x + (MOE.moe_ffn(bp["ffn"], h, cfg, mesh, lay) if moe else L.ffn(bp["ffn"], h, lay))


class HybridLM(_TreeLM):
    """The ``hybrid`` family (jamba): ``units``, a stack (leading
    ``repeat`` dimension) of superblocks of ``cfg.attn_every`` layers
    ``b0 ...``, each ``{ln1, ln2, mix, ffn}`` with pre-norm residuals:
    ``mix`` is the attention at ``hybrid_attn_position`` and a Mamba mixer
    elsewhere, ``ffn`` an MoE at ``hybrid_moe_positions`` and a dense
    SwiGLU elsewhere. Prefill and the loss route the MoE with capacity;
    decode runs ``moe_ffn_dense``, a token a row, as the reference."""

    def __init__(self, cfg: ArchConfig, tree: Dict, lay: Layout = WHOLE):
        super().__init__(cfg, tree, lay)
        self.attn_pos = hybrid_attn_position(cfg)
        self.moe_pos = hybrid_moe_positions(cfg)

    def backbone(self, tokens: torch.Tensor) -> torch.Tensor:
        x = L.embed_lookup(dict(table=self.embed.table), tokens, self.lay)
        remat = self._remat()
        for up in _stack(self.tree()["units"]):
            for i in range(self.cfg.attn_every):
                args = (up[f"b{i}"], x, self.cfg, i == self.attn_pos, i in self.moe_pos,
                        self.mesh, self.lay)
                x = checkpoint(_hybrid_block, *args, use_reentrant=False) if remat else \
                    _hybrid_block(*args)
        return x

    def loss(self, batch: Dict) -> torch.Tensor:
        return _lm_losses(self, self.backbone(batch["tokens"]), batch["tokens"], self.lay)

    def prefill(self, batch: Dict) -> torch.Tensor:
        """The last position's logits (B, 1, vocab); fills no cache."""
        x = self.backbone(batch["tokens"])
        return self.logits(_norm(self.final_norm, x[:, -1:]))

    def decode(self, cache: Dict, tokens: torch.Tensor, pos: torch.Tensor,
               long_ctx: bool = False):
        """One token per row at position ``pos`` (a 0-d tensor): logits
        (B, 1, vocab) and the cache, updated in place: the attention
        layer's ``k`` / ``v`` at ``pos``, each Mamba layer's ``h`` and
        ``conv`` (the zero cache is the mixer's own start: ``h = 0`` and
        the conv's zero padding). ``long_ctx`` as ``DecoderOnlyLM``'s."""
        cfg, lay = self.cfg, self.lay
        seq = _seq_name(long_ctx)
        x = L.embed_lookup(dict(table=self.embed.table), tokens, lay)
        for r, up in enumerate(_stack(self.tree()["units"])):
            mi = 0
            for i in range(cfg.attn_every):
                bp = up[f"b{i}"]
                h = _norm(bp["ln1"], x)
                if i == self.attn_pos:
                    y = L.decode_attention(bp["mix"], h, cache["k"][r], cache["v"][r], pos,
                                           cfg, lay=lay, seq=seq)[0]
                else:
                    st = dict(h=cache["h"][r, mi], conv=cache["conv"][r, mi])
                    y = SSM.mamba_decode(bp["mix"], h, st, cfg, lay)[0]
                    mi += 1
                x = x + y
                h = _norm(bp["ln2"], x)
                x = x + (MOE.moe_ffn_dense(bp["ffn"], h, cfg, self.mesh, not long_ctx, lay)
                         if i in self.moe_pos else L.ffn(bp["ffn"], h, lay))
        return self.logits(_norm(self.final_norm, x)), cache


# ---------------------------------------------------------------- Bundle
@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable  # (generator, device=None) -> the family's module (``meta``: nothing drawn)
    init_tree: Callable  # (generator, device=None) -> Param tree (``meta``: specs alone)
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> logits of the last position
    decode: Callable  # (params, cache, tokens, pos, long_ctx=False) -> (logits, cache)
    cache_shape: Callable  # (batch, seq) -> {name: (shape, dtype, logical names)}


# dimensions the layers compute whole: a rules table that splits one of
# them is refused (``rules_layout``)
KEPT_WHOLE = ("embed", "kv_heads", "head_dim", "lora", "expert_mlp", "layers", "repeat",
              "conv", "state")


def rules_layout(cfg: ArchConfig, mesh=None, rules=None) -> Layout:
    """The ``Layout`` of ``cfg``'s model on ``mesh`` by ``rules`` (default:
    the mesh's ``default_rules``); ``WHOLE`` without a mesh. Raises where
    the rules split a dimension the family's layers keep whole
    (``KEPT_WHOLE``; for xLSTM also ``heads``: its recurrence runs over the
    whole heads on every rank)."""
    if mesh is None:
        return WHOLE
    lay = Layout(mesh, rules)
    kept = KEPT_WHOLE + (("heads",) if cfg.family == "xlstm" else ())
    split = [n for n in kept if lay.axis(n) is not None]
    if split:
        raise NotImplementedError(f"the {cfg.family} layers keep {split} whole; the rules split "
                                  f"them")
    return lay


def build_decoder_only(cfg: ArchConfig, lay: Layout = WHOLE) -> ModelBundle:
    """The ``dense``, ``vlm``, ``moe`` and ``mla_moe`` families, laid out
    by ``lay``."""
    dense_kind, moe_kind, n_dense, n_moe = block_kinds(cfg)

    def init_tree(gen: torch.Generator, device=None) -> Dict:
        dev = device or gen.device
        p = dict(
            embed=L.init_embedding(gen, cfg, device, lay),
            head=L.init_lm_head(gen, cfg, device, lay),
            final_norm=_norm_param(cfg, dev, lay),
        )
        if n_dense:
            p["dense_blocks"] = stack_init(
                lambda: _init_block(gen, cfg, dense_kind, device, lay), n_dense)
        if n_moe:
            p["moe_blocks"] = stack_init(
                lambda: _init_block(gen, cfg, moe_kind, device, lay), n_moe)
        if cfg.mtp_depth:
            p["mtp"] = dict(
                proj=L.cut(L.make(gen, (2 * cfg.d_model, cfg.d_model), ("wembed", None), 1.0,
                                  L._dtype(cfg), device), lay),
                block=_init_block(gen, cfg, dense_kind, device, lay),
                norm=_norm_param(cfg, dev, lay),
            )
        return p

    def cache_shape(batch: int, seq: int):
        # bf16 whatever the model's dtype, as the reference
        names = ("layers", "batch", "kv_seq", None)
        if cfg.use_mla:
            return dict(ckv=((cfg.n_layers, batch, seq, cfg.kv_lora), torch.bfloat16, names),
                        kr=((cfg.n_layers, batch, seq, cfg.qk_rope), torch.bfloat16, names))
        names = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        return dict(k=(shape, torch.bfloat16, names), v=(shape, torch.bfloat16, names))

    return _bundle(cfg, DecoderOnlyLM, init_tree, cache_shape, lay)


def _bundle(cfg: ArchConfig, module, init_tree: Callable, cache_shape: Callable,
            lay: Layout = WHOLE) -> ModelBundle:
    """The bundle of a family's module class and its tree and cache, one
    rank of ``lay``'s mesh."""

    def init(gen: torch.Generator, device=None):
        """Parameters drawn from ``gen`` on its device, then moved to
        ``device`` (default: the generator's); on ``meta`` nothing is
        drawn."""
        if device is not None and torch.device(device).type == "meta":
            return module(cfg, init_tree(gen, "meta"), lay)
        model = module(cfg, init_tree(gen), lay)
        return model if device is None else model.to(device)

    def loss(params, batch: Dict) -> torch.Tensor:
        return params.loss(batch)

    def prefill(params, batch: Dict) -> torch.Tensor:
        return params.prefill(batch)

    def decode(params, cache: Dict, tokens, pos, long_ctx: bool = False):
        return params.decode(cache, tokens, pos, long_ctx)

    return ModelBundle(cfg, init, init_tree, loss, prefill, decode, cache_shape)


def _norm_params(cfg: ArchConfig, dev, *names, lay: Layout = WHOLE) -> Dict:
    """Layer-norm weights (ones) and biases (zeros, names ending in
    ``b``) of width ``d_model``, each ``lay``'s block."""
    return {n: L.cut((L.zeros if n.endswith("b") else L.ones)((cfg.d_model,), ("embed",),
                                                              device=dev), lay)
            for n in names}


def build_encdec(cfg: ArchConfig, lay: Layout = WHOLE) -> ModelBundle:
    """The ``encdec`` family (whisper-base), laid out by ``lay``."""

    def enc_block(gen, device):
        dev = device or gen.device
        return dict(**_norm_params(cfg, dev, "ln1", "ln1b", "ln2", "ln2b", lay=lay),
                    attn=L.init_attention(gen, cfg, device, lay),
                    ffn=L.init_ffn(gen, cfg, gelu=True, device=device, lay=lay))

    def dec_block(gen, device):
        dev = device or gen.device
        return dict(**_norm_params(cfg, dev, "ln1", "ln1b", "ln2", "ln2b", "ln3", "ln3b",
                                   lay=lay),
                    self_attn=L.init_attention(gen, cfg, device, lay),
                    cross_attn=L.init_attention(gen, cfg, device, lay),
                    ffn=L.init_ffn(gen, cfg, gelu=True, device=device, lay=lay))

    def init_tree(gen: torch.Generator, device=None) -> Dict:
        dev = device or gen.device
        return dict(
            embed=L.init_embedding(gen, cfg, device, lay),
            head=L.init_lm_head(gen, cfg, device, lay),
            enc_blocks=stack_init(lambda: enc_block(gen, device), cfg.enc_layers),
            dec_blocks=stack_init(lambda: dec_block(gen, device), cfg.n_layers),
            **_norm_params(cfg, dev, "enc_norm", "enc_norm_b", "final_norm", "final_norm_b",
                           lay=lay),
        )

    def cache_shape(batch: int, seq: int):
        # the cross cache holds the encoder's length at the frames' ratio
        enc_s = max(seq // cfg.enc_frames_div, 64)
        kv = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        xkv = (cfg.n_layers, batch, enc_s, cfg.n_kv_heads, cfg.head_dim)
        spec = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return dict(k=(kv, torch.bfloat16, spec), v=(kv, torch.bfloat16, spec),
                    xk=(xkv, torch.bfloat16, spec), xv=(xkv, torch.bfloat16, spec))

    return _bundle(cfg, EncDecLM, init_tree, cache_shape, lay)


def build_xlstm(cfg: ArchConfig, lay: Layout = WHOLE) -> ModelBundle:
    """The ``xlstm`` family (xlstm-125m), laid out by ``lay``."""
    unit = cfg.slstm_every  # layers per repeating unit; the last one is the sLSTM
    if cfg.n_layers % unit:
        raise ValueError(f"{cfg.n_layers} layers are not whole units of {unit}")
    n_rep = cfg.n_layers // unit

    def init_unit(gen, device):
        dev = device or gen.device
        p = {}
        for i in range(unit):
            ln = _norm_param(cfg, dev, lay)
            if i == unit - 1:
                p[f"s{i}"] = dict(ln=ln, core=XL.init_slstm(gen, cfg, device, lay))
            else:
                p[f"m{i}"] = dict(ln=ln, core=XL.init_mlstm(gen, cfg, device, lay))
        return p

    def init_tree(gen: torch.Generator, device=None) -> Dict:
        dev = device or gen.device
        return dict(
            embed=L.init_embedding(gen, cfg, device, lay),
            head=L.init_lm_head(gen, cfg, device, lay),
            units=stack_init(lambda: init_unit(gen, device), n_rep, "repeat"),
            final_norm=_norm_param(cfg, dev, lay),
        )

    def cache_shape(batch: int, seq: int):
        H = cfg.n_heads
        dh = cfg.d_inner // H
        d = cfg.d_model
        f32 = torch.float32
        return dict(
            C=((n_rep, unit - 1, batch, H, dh, dh), f32, ("repeat", None, "batch", None, None, None)),
            N=((n_rep, unit - 1, batch, H, dh), f32, ("repeat", None, "batch", None, None)),
            m=((n_rep, unit - 1, batch, H), f32, ("repeat", None, "batch", None)),
            sc=((n_rep, batch, d), f32, ("repeat", "batch", None)),
            sn=((n_rep, batch, d), f32, ("repeat", "batch", None)),
            sh=((n_rep, batch, d), f32, ("repeat", "batch", None)),
            sm=((n_rep, batch, d), f32, ("repeat", "batch", None)),
        )

    return _bundle(cfg, XLSTMLM, init_tree, cache_shape, lay)


def build_hybrid(cfg: ArchConfig, lay: Layout = WHOLE) -> ModelBundle:
    """The ``hybrid`` family (jamba-v0.1-52b), laid out by ``lay``."""
    unit = cfg.attn_every
    if not unit or cfg.n_layers % unit:
        raise ValueError(f"{cfg.n_layers} layers are not whole superblocks of {unit}")
    n_rep = cfg.n_layers // unit
    attn_pos, moe_pos = hybrid_attn_position(cfg), hybrid_moe_positions(cfg)

    def init_block(gen, device, i: int):
        dev = device or gen.device
        mix = (L.init_attention(gen, cfg, device, lay) if i == attn_pos
               else SSM.init_mamba(gen, cfg, device, lay))
        ffn = (MOE.init_moe(gen, cfg, device, lay) if i in moe_pos
               else L.init_ffn(gen, cfg, device=device, lay=lay))
        return dict(ln1=_norm_param(cfg, dev, lay), ln2=_norm_param(cfg, dev, lay), mix=mix,
                    ffn=ffn)

    def init_tree(gen: torch.Generator, device=None) -> Dict:
        dev = device or gen.device
        # each block position stacked over the superblocks on its own: the
        # same tree as a stack of whole superblocks, with one block's draw
        # alive beside the stacks instead of a superblock's (13.3 B
        # parameters at jamba's published widths)
        return dict(
            embed=L.init_embedding(gen, cfg, device, lay),
            head=L.init_lm_head(gen, cfg, device, lay),
            units={f"b{i}": stack_init(lambda i=i: init_block(gen, device, i), n_rep, "repeat")
                   for i in range(unit)},
            final_norm=_norm_param(cfg, dev, lay),
        )

    def cache_shape(batch: int, seq: int):
        # k and v bf16 whatever the model's dtype, the Mamba states f32, as the reference
        n_mamba = unit - 1
        kv = ((n_rep, batch, seq, cfg.n_kv_heads, cfg.head_dim), torch.bfloat16,
              ("repeat", "batch", "kv_seq", "kv_heads", "head_dim"))
        return dict(
            k=kv, v=kv,
            h=((n_rep, n_mamba, batch, cfg.d_inner, cfg.d_state), torch.float32,
               ("repeat", None, "batch", "inner", None)),
            conv=((n_rep, n_mamba, batch, cfg.d_conv - 1, cfg.d_inner), torch.float32,
                  ("repeat", None, "batch", None, "inner")),
        )

    return _bundle(cfg, HybridLM, init_tree, cache_shape, lay)


# ---------------------------------------------------------------- factory
def build_model(cfg: ArchConfig, mesh=None, rules=None) -> ModelBundle:
    """``cfg``'s bundle; with a ``mesh``, one rank of it laid out by
    ``rules`` (default: the mesh's ``default_rules``; ``rules_layout``)."""
    lay = rules_layout(cfg, mesh, rules)
    if cfg.family in ("dense", "vlm", "moe", "mla_moe"):
        return build_decoder_only(cfg, lay)
    if cfg.family == "encdec":
        return build_encdec(cfg, lay)
    if cfg.family == "xlstm":
        return build_xlstm(cfg, lay)
    if cfg.family == "hybrid":
        return build_hybrid(cfg, lay)
    raise ValueError(f"unknown family {cfg.family}")
