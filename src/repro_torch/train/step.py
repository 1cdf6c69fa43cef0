"""Step builders: the JAX package's ``train/step.py``. ``build_steps``
returns a ``Steps`` object with the model, its device, the optimizer,
``init_state``, ``train_step``, ``prefill_step`` and ``decode_step``, the
logical specs of the state, and the abstract batch and cache of a shape.

``train_step`` takes the loss's gradients with autograd, reads the cosine
schedule at the state's step and runs ``clip_and_update``: the clip by the
global norm (in f32) fused into each leaf's update, added to the
parameters in place one leaf at a time, each gradient dropped once its
update is added. Beside the parameters and the optimizer state only the
gradients and one leaf's temporaries exist (a layer of 256 experts of a
published MoE would not fit with an f32 copy of every gradient). The
serving steps run under ``torch.no_grad()``.

With a ``mesh`` (``launch/mesh.py``: a ``("data", "model")`` mesh of ranks,
or an abstract one for the dry run) the steps are one rank's: the rules
are the mesh's ``default_rules`` with ``cfg.logical_overrides`` merged in,
as the reference's. Every step takes the whole batch, the same on every
rank, and computes this rank's rows of it; ``prefill_step`` and
``decode_step`` return those rows' logits, the whole vocabulary; the cache
is the rank's own (``init_cache``; ``local`` cuts a whole one).

Every family is placed as the reference's rules place it: every state
leaf, batch and cache is this rank's block by the rules
(``Steps.placement`` is the rules' sharding): the batch over the data
axes, ``wembed`` over the data axes (ZeRO-3: each layer gathers its
weights, ``models/layers.py``), ``heads``, ``mlp``, ``vocab``,
``experts`` and ``inner`` over ``model``, the cache's ``kv_seq`` over
``model`` (``kv_seq_all`` over every axis with ``long_ctx``) and its
``inner`` (the Mamba state) over ``model``.

``train_step`` on a mesh is the reference's step on its global batch
(``step_gradients``): each rank backpropagates its rows' mean loss over the
number of data ranks (the global mean is the mean of the data shards'
means); the backward runs through the collectives' transposes
(``launch/mesh.py``): a gathered block's gradient comes out reduce-scattered
over the data axes, and a value the same on every ``model`` rank that
enters a per-rank region sums its cotangents there, so that every
gradient of a leaf whole over ``model`` is whole and the same on every
``model`` rank. What is left is summed in ``step_gradients`` (see there).
The global norm counts a whole leaf's squares once and sums the blocks'
over the ranks; Adafactor's means over a block are the whole leaf's
(``optim/optimizers.py``). The loss reported is the global mean, the same
on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.layers import split_params
from ..models.model import ModelBundle, build_model
from ..sharding.rules import Sharding, default_rules, dp_axes, named_sharding, shard_tensor
from ..optim.optimizers import (AdafactorState, AdamWState, SGDState, clip_scale,
                                cosine_schedule, get_optimizer, global_norm)
from ..tree import leaves, module_tree, unflatten


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _map_specs(fn, specs):
    """``fn`` over the spec tuples of a tree of dicts and named tuples."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(_map_specs(fn, v) for v in specs))
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def _adamw_specs(pspecs):
    return AdamWState(m=pspecs, v=pspecs)


def _adafactor_specs(pspecs):
    def vr(s):
        return s[:-1] if len(s) >= 2 else s

    def vc(s):
        return s[:-2] + s[-1:] if len(s) >= 2 else (None,)

    return AdafactorState(vr=_map_specs(vr, pspecs), vc=_map_specs(vc, pspecs))


def _sgd_specs(pspecs):
    return SGDState(mom=pspecs)


OPT_SPECS = {"adamw": _adamw_specs, "adafactor": _adafactor_specs, "sgd": _sgd_specs}


def opt_state_specs(name: str, param_specs):
    """The parameters' logical specs mirrored onto optimizer ``name``'s
    state leaves."""
    return OPT_SPECS[name](param_specs)


class ShapeDtype(NamedTuple):
    """An abstract tensor: the port's ``jax.ShapeDtypeStruct``."""
    shape: tuple
    dtype: torch.dtype


def mesh_rules(cfg: ArchConfig, mesh) -> Dict[str, Any]:
    """The rules of ``cfg``'s steps on ``mesh``: its ``default_rules`` with
    ``cfg.logical_overrides`` merged in (the reference's ``build_steps``)."""
    rules = default_rules(mesh)
    rules.update(cfg.logical_overrides or {})
    return rules


@dataclasses.dataclass
class Steps:
    cfg: ArchConfig
    bundle: ModelBundle
    device: torch.device

    init_state: Callable  # generator -> {"params": the model module, "opt", "step": int32 0-d}
    train_step: Callable  # (state, batch) -> (state, metrics)
    prefill_step: Callable  # (params, batch) -> logits of the last position
    decode_step: Callable  # (params, cache, tokens, pos) -> (logits, cache)

    state_specs: Any  # logical-name tree mirroring the state
    param_specs: Any  # logical-name tree mirroring the parameters
    mesh: Any = None  # this rank's mesh (None: one device)
    rules: Any = None  # the mesh's rules, overrides merged
    blocks: Optional[List[Optional[Sharding]]] = None  # param_blocks() on a mesh

    def placement(self, spec) -> Sharding:
        """Where a state leaf of logical ``spec`` lies on the mesh: the
        rank's block by the rules."""
        return named_sharding(self.mesh, spec, self.rules)

    def state_shardings(self):
        """The ``placement`` of every state leaf, in the state's tree (the
        ``shardings`` that ``ckpt.checkpoint.restore`` cuts a whole
        checkpoint by)."""
        return _map_specs(self.placement, self.state_specs)

    def param_blocks(self) -> List[Optional[Sharding]]:
        """Per parameter leaf (``leaves(model)``'s order): its placement
        where it is this rank's block, None where it is whole."""
        out = leaves(_map_specs(self.placement, self.param_specs))
        return [s if s.split else None for s in out]

    def local(self, tree, specs):
        """This rank's block of a tree of whole tensors (a batch or a
        cache) by its logical ``specs`` and the rules; the tree itself
        without a mesh."""
        if self.mesh is None:
            return tree
        return {k: shard_tensor(v, specs[k], self.mesh, self.rules) for k, v in tree.items()}

    def batch_spec(self, kind: str, seq: int, batch: int):
        """(abstract batch dict, logical specs) for a shape kind."""
        cfg = self.cfg
        if cfg.family == "encdec":
            # the frames' length here has a floor of 64; TokenPipeline's has 8
            enc_s = max(seq // cfg.enc_frames_div, 64)
            b = dict(frames=ShapeDtype((batch, enc_s, cfg.d_model), torch.bfloat16),
                     tokens=ShapeDtype((batch, seq), torch.int32))
            s = dict(frames=("batch", None, None), tokens=("batch", None))
        elif cfg.family == "vlm":
            P_ = min(cfg.n_patches, max(seq // 4, 16))
            b = dict(patches=ShapeDtype((batch, P_, cfg.d_model), torch.bfloat16),
                     tokens=ShapeDtype((batch, max(seq - P_, 8)), torch.int32))
            s = dict(patches=("batch", None, None), tokens=("batch", None))
        else:
            b = dict(tokens=ShapeDtype((batch, seq), torch.int32))
            s = dict(tokens=("batch", None))
        return b, s

    def cache_spec(self, batch: int, seq: int, long_ctx: bool = False):
        """(abstract cache dict, logical specs). ``long_ctx`` names the
        sequence dim over every mesh axis and replicates batch (batch=1)."""
        sds, specs = {}, {}
        for k, (shape, dtype, names) in self.bundle.cache_shape(batch, seq).items():
            names = tuple(names)
            if long_ctx:
                names = tuple("kv_seq_all" if n == "kv_seq" else (None if n == "batch" else n)
                              for n in names)
            sds[k] = ShapeDtype(tuple(shape), dtype)
            specs[k] = names
        return sds, specs

    def init_cache(self, batch: int, seq: int, long_ctx: bool = False) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_spec(batch, seq, long_ctx)`` on the
        steps' device: this rank's block of it on a mesh."""
        sds, specs = self.cache_spec(batch, seq, long_ctx)
        shapes = {k: s.shape for k, s in sds.items()}
        if self.mesh is not None:
            meta = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
            shapes = {k: v.shape for k, v in self.local(meta, specs).items()}
        return {k: torch.zeros(shapes[k], dtype=s.dtype, device=self.device)
                for k, s in sds.items()}


def loss_and_grads(bundle: ModelBundle, model, batch, scale: Optional[float] = None):
    """``(loss, grads)``: the loss (detached) and the gradients of ``loss *
    scale`` (of the loss without one) with autograd, in the parameters'
    dict shape and dtypes."""
    params = module_tree(model)
    with torch.enable_grad():
        loss = bundle.loss(model, batch)
        grads = torch.autograd.grad(loss if scale is None else loss * scale, leaves(params))
    return loss.detach(), unflatten(params, grads)


def step_gradients(steps: "Steps", model, batch):
    """``(loss, grads)`` of one training step, ``grads`` a list in
    ``leaves(model)``'s order. On one device the batch's; on a mesh (see
    the module) the global mean loss, the same on every rank, and each
    gradient the whole batch's: the rank's rows' loss over the number of
    data ranks backpropagated, then: a leaf split over the data axes was
    gathered and its gradient came reduce-scattered (summed) over them; any
    other leaf's is summed over the data axes. Over ``model`` nothing is
    left to sum: a block's gradient is its own, and a leaf whole over
    ``model`` has its whole gradient on every ``model`` rank (see the
    module), so it is neither summed again (that would count it twice)
    nor averaged."""
    mesh = steps.mesh
    if mesh is None:
        loss, grads = loss_and_grads(steps.bundle, model, batch)
        return loss, leaves(grads)
    dp = dp_axes(mesh)
    n_dp = math.prod(mesh.axis(a).size for a in dp)
    rows = steps.local(batch, {k: ("batch",) for k in batch})
    loss, grads = loss_and_grads(steps.bundle, model, rows, 1.0 / n_dp)
    grads = leaves(grads)
    for i, block in enumerate(steps.blocks):
        axis = mesh.over([a for a in dp if block is None or a not in block.axes])
        if axis is not None:
            grads[i] = axis.psum(grads[i])
    loss = mesh.everyone.psum(loss / n_dp) / (mesh.size // n_dp)
    return loss, grads


def clip_and_update(model, opt, grads, opt_update, lr, step, max_norm: float,
                    blocks=None) -> torch.Tensor:
    """Clip ``grads`` (a list in ``leaves(model)``'s order, emptied as it
    goes) by their global norm and add ``opt_update``'s updates to the
    parameters in place, one leaf at a time: the clip is fused into each
    leaf's update and each gradient is dropped once its update is added.
    ``opt``'s tensors are updated in place. ``blocks`` (``Steps.blocks``)
    says which leaves are a rank's block of a mesh. Returns
    the unclipped norm."""
    gnorm = global_norm(grads, blocks)
    scale = clip_scale(gnorm, max_norm)
    fields = [leaves(f) for f in opt]  # each mirrors the parameters
    with torch.no_grad():
        for i, p in enumerate(leaves(model)):
            g, grads[i] = grads[i], None
            b = blocks[i] if blocks is not None else None
            u, _ = opt_update(g, type(opt)(*(f[i] for f in fields)), p, lr, step, scale, block=b)
            del g
            p.add_(u.to(p.dtype))
            del u
    return gnorm


def build_steps(cfg: ArchConfig, device=None, mesh=None, lr: float = 3e-4, warmup: int = 100,
                total_steps: int = 10_000, grad_clip: float = 1.0) -> Steps:
    """The steps of ``cfg``'s model and optimizer on ``device`` (``cuda``
    unless the caller passes another; raises when CUDA is absent; ``meta``
    draws nothing), or as one rank of ``mesh`` on the mesh's device."""
    dev = resolve_device(mesh.device if mesh is not None else device)
    rules = mesh_rules(cfg, mesh) if mesh is not None else None
    bundle = build_model(cfg, mesh, rules)
    opt_init, opt_update = get_optimizer(cfg.optimizer)
    sched = cosine_schedule(lr, warmup, total_steps)
    # the specs from an init on the meta device: shapes only, nothing drawn
    _, pspecs = split_params(bundle.init_tree(torch.Generator(), device="meta"))
    state_specs = dict(params=pspecs, opt=OPT_SPECS[cfg.optimizer](pspecs), step=())

    def init_state(gen: torch.Generator) -> Dict[str, Any]:
        """Parameters drawn from ``gen`` (on its own device), on the steps'
        device with gradients on, the optimizer's zero state and the step
        (on ``meta``: the shapes alone, nothing drawn)."""
        model = bundle.init(gen, dev).requires_grad_(True)
        return dict(params=model, opt=opt_init(module_tree(model)),
                    step=torch.zeros((), dtype=torch.int32, device=dev))

    def train_step(state, batch):
        """One step: ``(state, {"loss", "grad_norm", "lr"})``. The
        parameters and the optimizer state are updated in place; the
        returned state holds them and the next step count. On a mesh
        ``batch`` is the whole batch (see the module)."""
        model, opt = state["params"], state["opt"]
        # the list is all that holds the gradients: each goes as it lands
        loss, grads = step_gradients(steps, model, batch)
        lr_t = sched(state["step"])
        gnorm = clip_and_update(model, opt, grads, opt_update, lr_t, state["step"], grad_clip,
                                steps.blocks)
        return (dict(params=model, opt=opt, step=state["step"] + 1),
                dict(loss=loss, grad_norm=gnorm, lr=lr_t))

    def rows(batch):
        """This rank's rows of every batch entry (each leads with the batch)."""
        if mesh is None:
            return batch
        return steps.local(batch, {k: ("batch",) for k in batch})

    @torch.no_grad()
    def prefill_step(params, batch):
        """The last position's logits of the batch's rows (this rank's, on a
        mesh)."""
        return bundle.prefill(params, rows(batch))

    @torch.no_grad()
    def decode_step(params, cache, tokens, pos, long_ctx: bool = False):
        """One token a row into ``cache`` (this rank's, on a mesh: ``tokens``
        are the whole batch's, and with ``long_ctx`` every rank takes them
        all, as the cache's batch is then whole)."""
        toks = tokens if long_ctx else rows(dict(tokens=tokens))["tokens"]
        return bundle.decode(params, cache, toks, pos, long_ctx)

    steps = Steps(cfg=cfg, bundle=bundle, device=dev, init_state=init_state,
                  train_step=train_step, prefill_step=prefill_step, decode_step=decode_step,
                  state_specs=state_specs, param_specs=pspecs, mesh=mesh, rules=rules)
    if mesh is not None:
        steps.blocks = steps.param_blocks()
    return steps
