"""Bottom-up packing with reinforcement learning (paper §5 + Alg. 3).

One level of packing is an MDP: N bottom nodes are inserted sequentially
into at most N upper-node slots. The state is the paper's
``(m+1)*N + m``-vector: for each upper slot its m-dim query-label bitmap and
a child count, plus the label of the incoming bottom node. Reward (Eq. 5) is
the reduction in the average number of accessed nodes per query. Duplicated
empty-slot actions are masked (§6 "Action mask in RL").

Accelerations from §6 are implemented here too: stratified sampling of the
training queries (``data/workloads.py``) and spectral-clustering grouping of
bottom clusters before packing.

Two rollout strategies drive each episode (the JAX package's
``core/packing.py``, whose semantics this module keeps):

* ``mode="batched"`` (default) -- the episode is a host loop of device
  operations with the env state (upper-slot label bitmaps, counts) as
  tensors: epsilon-greedy action selection, duplicate-slot masking, the
  Eq. 5 reward, replay insertion and the occupancy-gated train step, with
  no host sync inside an episode; on CUDA the training step is a CUDA
  graph. ``PackingConfig.parallel_episodes`` additionally plays several
  exploration episodes per epoch as a batch.
* ``mode="sequential"`` -- the per-step host loop over the numpy ``_Env``,
  with a sync per step.

Both modes take the same uniforms from one seeded CPU ``torch.Generator``
(the DQN init, then one block per episode: the epsilon draw, the action
draw and the replay-index draws of every step), so on one device they give
the same actions, rewards, replay contents and parameters bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import full_f32_matmul, resolve_device
from .dqn import (
    DQNConfig,
    dqn_update,
    greedy_action,
    masked_random_action,
    replay_add,
    replay_indices,
    replay_init,
    train_state_init,
    train_step_if_ready,
)


@dataclasses.dataclass
class PackingConfig:
    dqn: DQNConfig = dataclasses.field(default_factory=DQNConfig)
    epochs: int = 24
    max_label_queries: int = 48  # m used for state encoding (stratified-sampled)
    min_nodes: int = 3  # stop building levels at or below this width
    max_levels: int = 6
    action_mask: bool = True
    spectral_ratio: float = 1.0  # <1.0 groups bottom clusters first (accel §6)
    # batched mode only: >1 plays this many exploration episodes per epoch
    # (transitions are absorbed episode-major afterwards, so the training
    # schedule differs from the sequential one-episode-at-a-time loop)
    parallel_episodes: int = 1
    seed: int = 0


class _Env:
    """One-level packing environment (numpy; tiny state spaces)."""

    def __init__(self, labels: np.ndarray, use_mask: bool):
        self.labels = labels.astype(bool)  # (N, m)
        self.N, self.m = labels.shape
        self.use_mask = use_mask
        self.reset()

    def reset(self) -> np.ndarray:
        self.upper = np.zeros((self.N, self.m), dtype=bool)
        self.counts = np.zeros(self.N, dtype=np.int64)
        self.t = 0
        return self.state()

    def state(self) -> np.ndarray:
        nxt = self.labels[self.t] if self.t < self.N else np.zeros(self.m, bool)
        per_upper = np.concatenate(
            [self.upper.astype(np.float32), (self.counts[:, None] > 0).astype(np.float32)], axis=1
        )
        return np.concatenate([per_upper.reshape(-1), nxt.astype(np.float32)])

    def mask(self) -> np.ndarray:
        if not self.use_mask:
            return np.ones(self.N, dtype=bool)
        m = self.counts > 0
        empties = np.nonzero(~m)[0]
        if empties.size:
            m[empties[0]] = True  # expose exactly one empty slot
        return m

    def access_count(self) -> int:
        """#(labeled query, nonempty upper node) pairs: m times the average
        number of upper nodes a query must traverse into."""
        return int(self.upper[self.counts > 0].sum())

    def step(self, a: int) -> Tuple[np.ndarray, np.float32, bool]:
        before = self.access_count()
        self.upper[a] |= self.labels[self.t]
        self.counts[a] += 1
        self.t += 1
        after = self.access_count()
        done = self.t >= self.N
        r = np.float32(before - after) / np.float32(max(self.m, 1))
        return self.state(), r, done


def _episode_draws(gen: torch.Generator, lead: Tuple[int, ...], N: int, cfg: DQNConfig,
                   device) -> torch.Tensor:
    """One episode's uniforms, per step: the epsilon draw, the action draw,
    then ``batch_size`` replay-index draws; drawn as one block, then moved."""
    return torch.rand(lead + (N, 2 + cfg.batch_size), generator=gen).to(device)


def _run_episode(env: _Env, ts, buf, draws, eps: float, cfg: PackingConfig, train: bool):
    """Play one packing episode with the per-step host loop.

    Returns (assignment, rewards, buf, ts, losses, n_syncs) where
    ``n_syncs`` counts the host's waits on the device (each greedy action,
    each loss read) -- the batched rollout waits once an episode.
    """
    dev = buf.s.device
    s = env.reset()
    assign = np.zeros(env.N, dtype=np.int64)
    rewards = np.zeros(env.N, dtype=np.float32)
    host = draws.cpu().numpy() if train else None
    eps32 = np.float32(eps)
    losses = []
    n_disp = 0
    for t in range(env.N):
        mask = env.mask()
        if train and host[t, 0] < eps32:
            valid = np.nonzero(mask)[0]
            j = min(int(host[t, 1] * np.float32(valid.size)), valid.size - 1)
            a = int(valid[j])
        else:
            # a batch of one, as the batched rollout's, for the same bits
            a = int(greedy_action(ts.params, torch.from_numpy(s).to(dev)[None],
                                  torch.from_numpy(mask).to(dev)[None])[0])
            n_disp += 1
        s2, r, done = env.step(a)
        assign[t] = a
        rewards[t] = r
        if train:
            mask2 = env.mask() if not done else np.zeros(env.N, bool)
            buf = replay_add(buf, torch.from_numpy(s).to(dev), a, float(r),
                             torch.from_numpy(s2).to(dev), torch.from_numpy(mask2).to(dev), done)
            ts, loss, trained = train_step_if_ready(ts, buf, draws[t, 2:], cfg.dqn)
            if trained:
                losses.append(float(loss))
                n_disp += 1
        s = s2
    return assign, rewards, buf, ts, losses, n_disp


# ------------------------------------------------- device-resident rollout path
def _env_math(labels: torch.Tensor, use_mask: bool):
    """Tensor twins of _Env.state/.mask/.access_count over a batch of env
    states (leading dimension P), plus the epsilon-greedy transition the
    batched rollouts play. The step ``t`` is a (1,) tensor on the device."""
    N, m = labels.shape
    slots = torch.arange(N, device=labels.device)

    def label_at(t):  # the incoming node's labels, zeros past the last node
        return labels.index_select(0, torch.clamp(t, max=N - 1))[0] & (t < N)

    def state_vec(upper, counts, nxt):
        per_upper = torch.cat([upper.float(), (counts > 0)[..., None].float()], -1)
        nxt = nxt.float().expand(upper.shape[:-2] + (m,))
        return torch.cat([per_upper.flatten(-2), nxt], -1)

    def mask_of(counts):
        used = counts > 0
        if not use_mask:
            return torch.ones_like(used)
        has_empty = (~used).any(-1, keepdim=True)
        first_empty = torch.argmax((~used).long(), dim=-1, keepdim=True)  # expose one empty slot
        return used | ((slots == first_empty) & has_empty)

    def access_count(upper, counts):
        # integer numerator of the average accesses: reward = (before-after)/m exactly
        return (upper & (counts > 0)[..., None]).sum((-2, -1))

    def transition(params, upper, counts, t, draw_eps, draw_act, eps, explore: bool):
        """One env step: act (epsilon-greedy when ``explore``), apply, score.
        Returns (s, a, r, upper2, counts2, s2, mask2, done)."""
        label = label_at(t)
        s = state_vec(upper, counts, label)
        msk = mask_of(counts)
        a = greedy_action(params, s, msk)
        if explore:
            a = torch.where(draw_eps < eps, masked_random_action(draw_act, msk), a)
        pick = slots == a[..., None]  # (P, N) one-hot of the chosen slot
        before = access_count(upper, counts)
        upper2 = upper | (pick[..., None] & label)
        counts2 = counts + pick.long()
        after = access_count(upper2, counts2)
        r = (before - after).float() / float(max(m, 1))
        done = t + 1 >= N
        s2 = state_vec(upper2, counts2, label_at(t + 1))
        mask2 = mask_of(counts2) & ~done
        return s, a, r, upper2, counts2, s2, mask2, done

    return N, m, transition


class _Rollout:
    """One level's batched rollout: the env state, the step, the replay
    pointer and occupancy and the per-step outputs as fixed tensors on the
    device, so every training step is the same kernels on the same tensors.
    On CUDA that step is captured once as a CUDA graph (after one eager
    training step has warmed it up) and replayed; the host's launch
    overhead otherwise sets the pace of a step of ~150 small operations.
    The host keeps ``buf.ptr`` and ``buf.size`` in step as plain ints."""

    def __init__(self, labels: torch.Tensor, ts, buf, cfg: DQNConfig, use_mask: bool):
        self.N, m, self.transition = _env_math(labels, use_mask)
        self.ts, self.buf, self.cfg = ts, buf, cfg
        dev = labels.device
        self.cuda = dev.type == "cuda"
        self.upper = torch.zeros((1, self.N, m), dtype=torch.bool, device=dev)
        self.counts = torch.zeros((1, self.N), dtype=torch.int64, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        start = (buf.ptr, buf.size) if buf is not None else (0, 0)
        self.ptr, self.size = (torch.tensor([x], dtype=torch.int64, device=dev) for x in start)
        self.draws = torch.zeros((self.N, 2 + cfg.batch_size), device=dev)
        self.eps = torch.zeros((), device=dev)
        self.acts = torch.zeros(self.N, dtype=torch.int64, device=dev)
        self.rewards = torch.zeros(self.N, device=dev)
        self.losses = torch.zeros(self.N, device=dev)
        self.graph = None
        self.warm = False

    def _step(self, explore: bool, learn: bool) -> None:
        d = self.draws.index_select(0, self.t)[0]
        s, a, r, upper, counts, s2, mask2, done = self.transition(
            self.ts.params, self.upper, self.counts, self.t, d[:1], d[1:2], self.eps, explore)
        self.upper.copy_(upper)
        self.counts.copy_(counts)
        self.acts.index_copy_(0, self.t, a)
        self.rewards.index_copy_(0, self.t, r)
        if explore:
            b = self.buf
            for dst, x in ((b.s, s), (b.a, a), (b.r, r), (b.s2, s2), (b.mask2, mask2), (b.done, done)):
                dst.index_copy_(0, self.ptr, x)
            cap = b.s.shape[0]
            self.ptr.add_(1).remainder_(cap)
            self.size.add_(1).clamp_(max=cap)
        if learn:
            loss = dqn_update(self.ts, self.buf, replay_indices(d[2:], self.size), self.cfg)
            self.losses.index_copy_(0, self.t, loss[None])
        self.t.add_(1)

    def episode(self, draws, eps: float, train: bool):
        """Play one episode (training: epsilon-greedy on ``draws``, replay
        insertion and the occupancy-gated train step; else greedy). Returns
        (actions, rewards, losses) on the device and the host's list of
        steps that trained."""
        self.upper.zero_()
        self.counts.zero_()
        self.t.zero_()
        self.eps.fill_(eps)
        if train:
            self.draws.copy_(draws)
        trained = [False] * self.N
        for step in range(self.N):
            learn = False
            if train:
                cap = self.buf.s.shape[0]
                size = min(self.buf.size + 1, cap)
                learn = size >= self.cfg.batch_size
            if learn and self.cuda and self.warm:
                if self.graph is None:
                    self.graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(self.graph):
                        self._step(True, True)
                self.graph.replay()
            else:
                self._step(train, learn)
                self.warm |= learn
            if train:
                self.buf.ptr = (self.buf.ptr + 1) % cap
                self.buf.size = size
            trained[step] = learn
        return self.acts.clone(), self.rewards.clone(), self.losses.clone(), trained


def _rollout_collect(labels: torch.Tensor, params, draws, eps: float, use_mask: bool):
    """Parallel exploration (``PackingConfig.parallel_episodes`` > 1): P
    epsilon-greedy episodes as a batch dimension against frozen ``params``.
    Returns their transitions (s, a, r, s2, mask2, done), each (P, N, ...)."""
    N, m, transition = _env_math(labels, use_mask)
    P = draws.shape[0]
    dev = labels.device
    upper = torch.zeros((P, N, m), dtype=torch.bool, device=dev)
    counts = torch.zeros((P, N), dtype=torch.int64, device=dev)
    t = torch.zeros(1, dtype=torch.int64, device=dev)
    steps = []
    with torch.no_grad():
        for step in range(N):
            s, a, r, upper, counts, s2, mask2, done = transition(
                params, upper, counts, t, draws[:, step, 0], draws[:, step, 1], eps, True)
            steps.append((s, a, r, s2, mask2, done))
            t = t + 1
    trans = [torch.stack([st[i] for st in steps], 1) for i in range(5)]
    done = torch.zeros((P, N), dtype=torch.bool, device=dev)
    done[:, -1] = True
    return trans + [done]


def _absorb_and_train(ts, buf, trans, draws, cfg: DQNConfig):
    """Insert collected transitions episode-major, running the
    occupancy-gated train step after each insertion."""
    P, N = trans[1].shape
    flat = [x.reshape((P * N,) + x.shape[2:]) for x in trans]
    losses = torch.zeros(P * N, device=draws.device)
    trained = [False] * (P * N)
    for i in range(P * N):
        buf = replay_add(buf, *(x[i] for x in flat))
        ts, loss, trained[i] = train_step_if_ready(ts, buf, draws[i], cfg)
        losses[i] = loss
    return ts, buf, losses, trained


@dataclasses.dataclass
class LevelPackResult:
    assign: np.ndarray  # (N,) upper slot per bottom node
    n_upper: int
    sum_rewards: float
    losses: List[float]
    reward_curve: List[float]
    n_dispatches: int = 0  # the host's waits on the device for this level
    n_env_steps: int = 0  # env transitions played (incl. parallel episodes)
    mode: str = "sequential"


def _reward_sum(rewards: np.ndarray) -> float:
    return float(np.asarray(rewards, np.float32).astype(np.float64).sum())


@full_f32_matmul()
def pack_one_level(
    labels: np.ndarray, cfg: PackingConfig, seed: int = 0, mode: str = "batched", device=None
) -> LevelPackResult:
    """Train a DQN for one level on ``device`` (``cuda`` unless the caller
    names another) and return the greedy packing.

    ``mode="batched"`` plays each episode with no host sync inside;
    ``mode="sequential"`` is the per-step host loop. Both take the same
    draws from ``torch.Generator().manual_seed(seed)``, so matched seeds
    yield matched episodes.
    """
    dev = resolve_device(device)
    if mode == "sequential":
        return _pack_one_level_sequential(labels, cfg, seed, dev)
    if mode == "batched":
        return _pack_one_level_batched(labels, cfg, seed, dev)
    raise ValueError(f"unknown packing mode {mode!r}")


def _compact_assign(assign: np.ndarray) -> Tuple[np.ndarray, int]:
    used = np.unique(assign)
    remap = {int(u): i for i, u in enumerate(used)}
    return np.array([remap[int(a)] for a in assign], dtype=np.int32), len(used)


def _pack_one_level_sequential(labels: np.ndarray, cfg: PackingConfig, seed: int, dev) -> LevelPackResult:
    N, m = labels.shape
    env = _Env(labels, cfg.action_mask)
    state_dim = (m + 1) * N + m
    gen = torch.Generator().manual_seed(seed)
    ts = train_state_init(gen, state_dim, N, cfg.dqn, device=dev)
    buf = replay_init(cfg.dqn.capacity, state_dim, N, device=dev)
    eps = cfg.dqn.eps_start
    losses: List[float] = []
    curve: List[float] = []
    n_disp = 0
    for ep in range(cfg.epochs):
        draws = _episode_draws(gen, (), N, cfg.dqn, dev)
        _, rewards, buf, ts, ls, d = _run_episode(env, ts, buf, draws, eps, cfg, train=True)
        losses.extend(ls)
        curve.append(_reward_sum(rewards))
        n_disp += d
        eps = max(cfg.dqn.eps_end, eps * cfg.dqn.eps_decay)
    assign, rewards, _, _, _, d = _run_episode(env, ts, buf, None, 0.0, cfg, train=False)
    n_disp += d
    assign, n_upper = _compact_assign(assign)
    return LevelPackResult(
        assign, n_upper, _reward_sum(rewards), losses, curve,
        n_dispatches=n_disp, n_env_steps=(cfg.epochs + 1) * N, mode="sequential",
    )


def _pack_one_level_batched(labels: np.ndarray, cfg: PackingConfig, seed: int, dev) -> LevelPackResult:
    N, m = labels.shape
    labels_t = torch.as_tensor(labels.astype(bool), device=dev)
    state_dim = (m + 1) * N + m
    gen = torch.Generator().manual_seed(seed)
    ts = train_state_init(gen, state_dim, N, cfg.dqn, device=dev)
    buf = replay_init(cfg.dqn.capacity, state_dim, N, device=dev)
    eps = cfg.dqn.eps_start
    losses: List[float] = []
    curve: List[float] = []
    n_disp = 0
    n_env = 0
    P = max(1, int(cfg.parallel_episodes))
    rollout = _Rollout(labels_t, ts, buf, cfg.dqn, cfg.action_mask)
    for ep in range(cfg.epochs):
        if P == 1:
            draws = _episode_draws(gen, (), N, cfg.dqn, dev)
            _, rewards, ls, trained = rollout.episode(draws, eps, True)
            n_env += N
            rewards, ls = torch.stack([rewards, ls]).cpu().numpy()
            curve.append(_reward_sum(rewards))
        else:
            draws = _episode_draws(gen, (P,), N, cfg.dqn, dev)
            trans = _rollout_collect(labels_t, ts.params, draws, eps, cfg.action_mask)
            absorb = torch.rand((P * N, cfg.dqn.batch_size), generator=gen).to(dev)
            ts, buf, ls, trained = _absorb_and_train(ts, buf, trans, absorb, cfg.dqn)
            n_env += P * N
            rewards, ls = trans[2].cpu().numpy(), ls.cpu().numpy()
            curve.extend(_reward_sum(r) for r in rewards)
        n_disp += 1
        losses.extend(ls[np.asarray(trained, bool)].tolist())
        eps = max(cfg.dqn.eps_end, eps * cfg.dqn.eps_decay)
    acts, rewards, _, _ = rollout.episode(None, 0.0, False)
    n_disp += 1
    n_env += N
    acts, rewards = torch.stack([acts.float(), rewards]).cpu().numpy()
    assign, n_upper = _compact_assign(acts.astype(np.int64))
    return LevelPackResult(
        assign, n_upper, _reward_sum(rewards), losses, curve,
        n_dispatches=n_disp, n_env_steps=n_env, mode="batched",
    )


def spectral_group(mbrs: np.ndarray, n_groups: int, seed: int = 0) -> np.ndarray:
    """Spectral clustering on MBR corner features (§6 accel). Returns group ids."""
    n = mbrs.shape[0]
    n_groups = max(1, min(n_groups, n))
    if n_groups >= n:
        return np.arange(n, dtype=np.int32)
    feats = mbrs.astype(np.float64)
    d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
    sigma2 = np.median(d2[d2 > 0]) + 1e-12 if np.any(d2 > 0) else 1.0
    A = np.exp(-d2 / sigma2)
    np.fill_diagonal(A, 0.0)
    deg = A.sum(1)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    L = np.eye(n) - dinv[:, None] * A * dinv[None, :]
    vals, vecs = np.linalg.eigh(L)
    U = vecs[:, :n_groups]
    U = U / (np.linalg.norm(U, axis=1, keepdims=True) + 1e-12)
    # k-means
    rng = np.random.default_rng(seed)
    centers = U[rng.choice(n, n_groups, replace=False)]
    lab = np.zeros(n, dtype=np.int32)
    for _ in range(25):
        dist = ((U[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        new = dist.argmin(1).astype(np.int32)
        if np.array_equal(new, lab):
            break
        lab = new
        for g in range(n_groups):
            sel = lab == g
            if sel.any():
                centers[g] = U[sel].mean(0)
    # compact
    used = np.unique(lab)
    remap = {int(u): i for i, u in enumerate(used)}
    return np.array([remap[int(x)] for x in lab], dtype=np.int32)


@dataclasses.dataclass
class HierarchyResult:
    """The learned hierarchy: the parent slot of each lower node per built
    level (bottom-up), the levels' query labels and each level's packing.
    ``assemble_index`` reads only ``parents``."""

    parents: List[np.ndarray]  # per built level: parent slot of each lower node
    level_labels: List[np.ndarray] = dataclasses.field(default_factory=list)
    packs: List[LevelPackResult] = dataclasses.field(default_factory=list)
    n_dispatches: int = 0  # summed over packed levels
    n_env_steps: int = 0


def build_hierarchy(
    bottom_labels: np.ndarray,  # (K, m) bool: bottom cluster x sampled-query label
    bottom_mbrs: np.ndarray,
    cfg: Optional[PackingConfig] = None,
    mode: str = "batched",
    device=None,
) -> HierarchyResult:
    """Pack levels bottom-up until few nodes remain or packing stops helping."""
    cfg = cfg or PackingConfig()
    dev = resolve_device(device)
    labels = bottom_labels.astype(bool)
    parents: List[np.ndarray] = []
    packs: List[LevelPackResult] = []
    level_labels: List[np.ndarray] = [labels]

    # optional grouping acceleration on the widest (first) level
    if cfg.spectral_ratio < 1.0 and labels.shape[0] > 8:
        n_groups = max(2, int(np.ceil(labels.shape[0] * cfg.spectral_ratio)))
        gids = spectral_group(bottom_mbrs, n_groups, cfg.seed)
        parents.append(gids)
        ng = gids.max() + 1
        glabels = np.zeros((ng, labels.shape[1]), dtype=bool)
        for i, g in enumerate(gids):
            glabels[g] |= labels[i]
        labels = glabels
        level_labels.append(labels)
        packs.append(LevelPackResult(gids, int(ng), 0.0, [], [], mode=mode))

    seed = cfg.seed
    for lvl in range(cfg.max_levels):
        N = labels.shape[0]
        if N <= cfg.min_nodes:
            break
        res = pack_one_level(labels, cfg, seed=seed + lvl + 1, mode=mode, device=dev)
        if res.n_upper >= N or res.sum_rewards <= -float(N):
            break  # packing stopped reducing accesses (paper's -N termination)
        parents.append(res.assign)
        packs.append(res)
        new_labels = np.zeros((res.n_upper, labels.shape[1]), dtype=bool)
        for i, a in enumerate(res.assign):
            new_labels[a] |= labels[i]
        labels = new_labels
        level_labels.append(labels)
    return HierarchyResult(
        parents=parents,
        level_labels=level_labels,
        packs=packs,
        n_dispatches=sum(p.n_dispatches for p in packs),
        n_env_steps=sum(p.n_env_steps for p in packs),
    )
