"""Deep Q-Network (paper §5.2/§5.3) in PyTorch.

Policy / target networks with soft updates (Eq. 7, tau=0.001), experience
replay (capacity 256 per §7.1), epsilon-greedy with decay, duplicate-action
masking, and SmoothL1 (sum reduction) loss per §7.6.4 on the TD target
(Eq. 6). The environment loop lives in ``packing.py``; the semantics are
the JAX package's ``core/dqn.py``.

The replay buffer's tensors live on the device and its occupancy on the
host: it grows by one a step up to its capacity, so the host knows when a
train step is due without asking the device (the batched rollout keeps a
copy of pointer and occupancy on the device too, for its CUDA graph). Random draws are uniforms from
a seeded CPU ``torch.Generator``, handed in per step (``draws``): the
train step turns them into replay indices, so a test can also feed the
update indices of its own (``dqn_update``).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .. import full_f32_matmul


class QNet(nn.Module):
    """3-layer MLP (paper: 3 layers, 64 hidden units)."""

    def __init__(self, state_dim: int, n_actions: int, hidden: int = 64, device=None):
        super().__init__()
        # no default init (it would draw from the global RNG): q_init fills them
        device = "cpu" if device is None else device
        self.l0 = nn.utils.skip_init(nn.Linear, state_dim, hidden, device=device)
        self.l1 = nn.utils.skip_init(nn.Linear, hidden, hidden, device=device)
        self.l2 = nn.utils.skip_init(nn.Linear, hidden, n_actions, device=device)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.l0(s))
        h = torch.relu(self.l1(h))
        return self.l2(h)


def q_init(generator: torch.Generator, state_dim: int, n_actions: int, hidden: int = 64,
           device=None) -> QNet:
    """He-normal weights, zero biases, drawn (in, out) from ``generator`` (CPU)
    layer by layer and stored in ``nn.Linear``'s (out, in) layout."""
    net = QNet(state_dim, n_actions, hidden, device=device)
    with torch.no_grad():
        for lin in (net.l0, net.l1, net.l2):
            fan_in = lin.in_features
            w = torch.randn((fan_in, lin.out_features), generator=generator) * math.sqrt(2.0 / fan_in)
            lin.weight.copy_(w.T)
            lin.bias.zero_()
    return net


def q_apply(params: QNet, s: torch.Tensor) -> torch.Tensor:
    return params(s)


@dataclasses.dataclass
class Replay:
    s: torch.Tensor  # (C, D)
    a: torch.Tensor  # (C,) int64
    r: torch.Tensor  # (C,)
    s2: torch.Tensor  # (C, D)
    mask2: torch.Tensor  # (C, A) action mask at s2
    done: torch.Tensor  # (C,)
    ptr: int = 0  # host: the next slot written
    size: int = 0  # host: slots filled


def replay_init(capacity: int, state_dim: int, n_actions: int, device=None) -> Replay:
    return Replay(
        s=torch.zeros((capacity, state_dim), device=device),
        a=torch.zeros((capacity,), dtype=torch.int64, device=device),
        r=torch.zeros((capacity,), device=device),
        s2=torch.zeros((capacity, state_dim), device=device),
        mask2=torch.zeros((capacity, n_actions), dtype=torch.bool, device=device),
        done=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def replay_add(buf: Replay, s, a, r, s2, mask2, done) -> Replay:
    """Write one transition at ``ptr`` (device copies, no sync)."""
    i = buf.ptr
    buf.s[i] = s
    buf.a[i] = a
    buf.r[i] = r
    buf.s2[i] = s2
    buf.mask2[i] = mask2
    buf.done[i] = done
    cap = buf.s.shape[0]
    buf.ptr = (i + 1) % cap
    buf.size = min(buf.size + 1, cap)
    return buf


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.99
    tau: float = 0.001
    lr: float = 1e-3
    batch_size: int = 32
    capacity: int = 256
    hidden: int = 64
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay: float = 0.98  # per-episode multiplicative decay


@dataclasses.dataclass
class TrainState:
    params: QNet
    target: QNet
    opt_m: Dict[str, torch.Tensor]
    opt_v: Dict[str, torch.Tensor]
    step: torch.Tensor  # () int64 on the device: updates made


def train_state_init(generator: torch.Generator, state_dim: int, n_actions: int, cfg: DQNConfig,
                     device=None) -> TrainState:
    p = q_init(generator, state_dim, n_actions, cfg.hidden, device=device)
    return TrainState(
        params=p,
        target=copy.deepcopy(p),
        opt_m={k: torch.zeros_like(a) for k, a in p.named_parameters()},
        opt_v={k: torch.zeros_like(a) for k, a in p.named_parameters()},
        step=torch.zeros((), dtype=torch.int64, device=p.l0.weight.device),
    )


def train_state_from_reference(params: Dict, target: Dict, opt_m: Dict, opt_v: Dict, step: int,
                               device=None) -> TrainState:
    """A ``TrainState`` from the JAX package's as numpy pytrees
    (``{"l0": {"w": (in, out), "b": (out,)}, ...}``): weights and their
    Adam moments transposed into ``nn.Linear``'s (out, in) layout."""
    def net(tree):
        w0 = np.asarray(tree["l0"]["w"])
        n = QNet(w0.shape[0], np.asarray(tree["l2"]["w"]).shape[1], w0.shape[1], device=device)
        load(n, tree)
        return n

    def load(n, tree):
        with torch.no_grad():
            for name, lin in (("l0", n.l0), ("l1", n.l1), ("l2", n.l2)):
                lin.weight.copy_(torch.as_tensor(np.array(tree[name]["w"], np.float32).T))
                lin.bias.copy_(torch.as_tensor(np.array(tree[name]["b"], np.float32)))

    def moments(tree):
        n = net(tree)
        return {k: a.detach().clone() for k, a in n.named_parameters()}

    p = net(params)
    return TrainState(params=p, target=net(target), opt_m=moments(opt_m), opt_v=moments(opt_v),
                      step=torch.tensor(int(step), dtype=torch.int64, device=p.l0.weight.device))


def replay_indices(draws: torch.Tensor, size) -> torch.Tensor:
    """Uniform replay indices in [0, size) from uniforms in [0, 1); ``size``
    a host int or a tensor on the device (the same indices either way)."""
    if not torch.is_tensor(size):
        size = max(int(size), 1)
    return torch.clamp((draws * size).long(), max=size - 1)


@full_f32_matmul()
def dqn_update(ts: TrainState, buf: Replay, idx: torch.Tensor, cfg: DQNConfig) -> torch.Tensor:
    """One gradient step on the replay rows ``idx`` (Eq. 6 with SmoothL1-sum),
    Adam at ``t = step + 1`` (its bias corrections in f32 on the device) and
    the soft target update, in place, with no host sync. Returns the loss
    (on the device)."""
    s, a, r, s2, m2, dn = (buf.s[idx], buf.a[idx], buf.r[idx], buf.s2[idx], buf.mask2[idx],
                           buf.done[idx])
    with torch.no_grad():
        q_next = torch.where(m2, ts.target(s2), -torch.inf)
        max_next = q_next.max(-1).values
        max_next = torch.where(torch.isfinite(max_next), max_next, 0.0)
        tgt = r + cfg.gamma * torch.where(dn, 0.0, max_next)
    names = [k for k, _ in ts.params.named_parameters()]
    params = list(ts.params.parameters())
    qa = ts.params(s).gather(1, a[:, None])[:, 0]
    loss = torch.sum(smooth_l1(qa - tgt))
    grads = torch.autograd.grad(loss, params)
    t = (ts.step + 1).float()
    c1 = 1 - torch.full_like(t, 0.9) ** t
    c2 = 1 - torch.full_like(t, 0.999) ** t
    m = [ts.opt_m[k] for k in names]
    v = [ts.opt_v[k] for k in names]
    targets = list(ts.target.parameters())
    # Adam and the soft target update (Eq. 7) as multi-tensor ops: the same
    # elementwise arithmetic, in a few launches
    with torch.no_grad():
        torch._foreach_mul_(m, 0.9)
        torch._foreach_add_(m, torch._foreach_mul(grads, 0.1))
        torch._foreach_mul_(v, 0.999)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(grads, 0.001), grads))
        step = torch._foreach_mul(torch._foreach_div(m, c1), cfg.lr)
        denom = torch._foreach_sqrt(torch._foreach_div(v, c2))
        torch._foreach_add_(denom, 1e-8)
        torch._foreach_sub_(params, torch._foreach_div(step, denom))
        torch._foreach_mul_(targets, 1 - cfg.tau)
        torch._foreach_add_(targets, torch._foreach_mul(params, cfg.tau))
        ts.step.add_(1)
    return loss.detach()


def dqn_train_step(ts: TrainState, buf: Replay, draws: torch.Tensor, cfg: DQNConfig) -> torch.Tensor:
    """One gradient step on a replay batch drawn from ``draws``
    (``batch_size`` uniforms)."""
    return dqn_update(ts, buf, replay_indices(draws, buf.size), cfg)


@torch.no_grad()
def greedy_action(params: QNet, s: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    q = params(s)
    return torch.argmax(torch.where(mask, q, -torch.inf), dim=-1)


def masked_random_action(draw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Uniform action over the True entries of ``mask`` (last dimension):
    ``j = floor(draw * #valid)`` from a uniform in [0, 1), then the j-th
    valid slot -- on the device, with no sync."""
    nvalid = torch.clamp(mask.sum(-1), min=1)
    j = torch.minimum((draw * nvalid).long(), nvalid - 1)
    hit = (torch.cumsum(mask.long(), -1) - 1 == j[..., None]) & mask
    return torch.argmax(hit.long(), dim=-1)


def train_step_if_ready(
    ts: TrainState, buf: Replay, draws: torch.Tensor, cfg: DQNConfig
) -> Tuple[TrainState, torch.Tensor, bool]:
    """``dqn_train_step`` gated on replay occupancy, which the host knows.
    Returns (ts, loss, trained?); when the buffer is not warm yet the state
    passes through and the loss is 0."""
    if buf.size < cfg.batch_size:
        return ts, torch.zeros((), device=draws.device), False
    return ts, dqn_train_step(ts, buf, draws, cfg), True
