"""The training loop with checkpoint and restart, straggler monitoring and
optional gradient compression: the JAX package's ``train/loop.py``.

``train`` runs on ``device`` (``cuda`` unless the caller passes another),
or as one rank of ``mesh`` (``launch/mesh.py``) on the mesh's device,
every rank calling it alike. The initial weights are drawn from a CPU
generator seeded with ``TrainConfig.seed`` and moved to the device (a rank
draws every weight and keeps its block), so a run starts from the same
state on every device and every mesh. Over a mesh the token pipeline
gives every rank the whole batch (``train_step`` takes the rank's rows),
a step's time is the slowest rank's, checkpoints hold whole leaves
(``ckpt/checkpoint.py``) and a restart restores this mesh's blocks of them
(``restore(..., shardings=)``), whatever mesh wrote them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs.base import ArchConfig
from ..data.tokens import TokenPipeline
from ..optim.compression import ef_init, int8_tree_roundtrip, topk_with_error_feedback
from ..optim.optimizers import cosine_schedule, get_optimizer
from ..resilience.straggler import StragglerMonitor
from ..tree import leaves, module_tree
from .step import Steps, build_steps, clip_and_update, step_gradients


@dataclasses.dataclass
class TrainConfig:
    n_steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    log_every: int = 10
    grad_compression: Optional[str] = None  # None | "topk" | "int8"
    topk_frac: float = 0.1
    seed: int = 0


@dataclasses.dataclass
class TrainResult:
    losses: list
    final_step: int
    restored_from: Optional[int]
    step_times: list
    flagged_hosts: list


def _compressed_step(steps: Steps, tc: TrainConfig):
    """The reference's step with compression: the gradients (over a mesh,
    reduced over the ranks first: the reference compresses the whole
    gradient) compressed (error-feedback top-k or the int8 round trip, a
    block's over its whole leaf) before the clip at 1.0
    (``clip_and_update``, as ``train_step``), the schedule fixed at
    ``cosine_schedule(3e-4, 100, 10_000)``."""
    _, opt_update = get_optimizer(steps.cfg.optimizer)
    sched = cosine_schedule(3e-4, 100, 10_000)

    def step_fn(state, batch, ef_res):
        model = state["params"]
        loss, grads = step_gradients(steps, model, batch)
        if tc.grad_compression == "topk":
            grads, ef_res = topk_with_error_feedback(grads, ef_res, tc.topk_frac, steps.blocks)
        elif tc.grad_compression == "int8":
            grads = int8_tree_roundtrip(grads, steps.blocks)
        grads = leaves(grads)  # the list is all that holds them: each goes as it lands
        lr_t = sched(state["step"])
        gnorm = clip_and_update(model, state["opt"], grads, opt_update, lr_t, state["step"],
                                1.0, steps.blocks)
        return dict(params=model, opt=state["opt"], step=state["step"] + 1), dict(
            loss=loss, grad_norm=gnorm), ef_res

    return step_fn


def train(cfg: ArchConfig, tc: TrainConfig, steps: Optional[Steps] = None,
          device=None, mesh=None) -> TrainResult:
    steps = steps or build_steps(cfg, device, mesh=mesh)
    mesh = steps.mesh
    dev = steps.device
    pipe = TokenPipeline(vocab=cfg.vocab, seq=tc.seq, batch=tc.batch, seed=tc.seed)
    shardings = steps.state_shardings() if mesh is not None else None

    restored_from = None
    state = steps.init_state(torch.Generator().manual_seed(tc.seed))
    start_step = 0
    ckpt = None
    if tc.ckpt_dir:
        ckpt = AsyncCheckpointer(tc.ckpt_dir, shardings=shardings)
        last = latest_step(tc.ckpt_dir)
        if mesh is not None:  # rank 0's reading, on every rank
            last = mesh.broadcast_object(last)
        if last is not None:
            state, start_step = restore(tc.ckpt_dir, state, last, shardings)
            restored_from = start_step
            pipe.skip_to(start_step)

    ef = None
    if tc.grad_compression:
        ef = ef_init(module_tree(state["params"]))
        step_fn = _compressed_step(steps, tc)

    monitor = StragglerMonitor(n_hosts=1)
    losses, times, flagged_all = [], [], []
    try:
        for it in range(start_step, tc.n_steps):
            batch = pipe.next_batch(cfg, dev)
            t0 = time.perf_counter()
            if tc.grad_compression:
                state, metrics, ef = step_fn(state, batch, ef)
            else:
                state, metrics = steps.train_step(state, batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            if mesh is not None:  # the slowest rank's
                dt = float(mesh.everyone.pmax(torch.tensor([dt], dtype=torch.float64,
                                                           device=dev))[0])
            loss = float(metrics["loss"])
            times.append(dt)
            flagged = monitor.observe(np.array([dt]))
            if flagged:
                flagged_all.extend(flagged)
            losses.append(loss)
            if tc.log_every and (it + 1) % tc.log_every == 0 and (mesh is None or mesh.rank == 0):
                print(f"step {it+1} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if ckpt and (it + 1) % tc.ckpt_every == 0:
                ckpt.submit(it + 1, state)
        if ckpt:
            ckpt.submit(tc.n_steps, state)
    finally:
        if ckpt:
            ckpt.close()
    return TrainResult(losses=losses, final_step=tc.n_steps, restored_from=restored_from,
                       step_times=times, flagged_hosts=flagged_all)
