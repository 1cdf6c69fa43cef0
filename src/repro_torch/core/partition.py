"""Bottom cluster generation (paper Alg. 2): recursive space splitting where
each split value is *learned* with SGD on the differentiable surrogate cost
(paper Eq. 4):

    L_q(v) = sigma(3(v - q_lo)) * |O1(q)|  +  sigma(3(q_hi - v)) * |O2(q)|

``|O1|/|O2|`` are CDF-bank estimates of keyword-matching objects in the two
sub-spaces (keyword-conditioned over the *whole* sub-space rectangle, per the
cost model). The split of a (sub-)space is accepted when the estimated
verification saving beats the added filtering cost:

    C_s - w2 * best.cost > w1 * |W|      (Alg. 2, line 10)

The learner runs multi-restart Adam on both dimensions of every subspace of
a call at once, on the bank's device: split values ``v`` of shape (B, 2, R)
whose losses are independent, so the gradient of their sum is each
element's own. Only ``F_e^d(v)`` moves from step to step; the CDF values at
the subspace's edges are evaluated once per call, and ``F_e^d(v)`` once per
distinct (entry, coordinate) a step (``cdf.cdf_table_fn``), then gathered per
(query, entry). Gradients reach ``v`` through dense operations only (no
scatter where two elements meet), so a learner's result does not depend on
the order of float atomics. The results come back to the host once a call.

Two execution strategies drive the split recursion (the JAX package's
``core/partition.py``, whose host walks this module copies):

* ``mode="batched"`` (default) -- frontier-parallel rounds: every currently
  splittable subspace is learned in one call per (query-width bucket,
  ``max_split_batch`` chunk), so learner calls scale with tree *depth*, not
  node *count*. Accept/split bookkeeping replays the sequential
  priority-heap walk on host, so the learned cluster set is identical to
  the sequential mode's.
* ``mode="sequential"`` -- the original heap loop (one ``_learn_split`` per
  subspace).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import full_f32_matmul
from .cdf import CLASS_LOW, CDFBank, _clip01, cdf_table_fn
from .cost import DEFAULT_W1, DEFAULT_W2
from .query import round_up_bucket
from .types import ClusterSet, GeoTextDataset, Workload, rects_intersect


@dataclasses.dataclass
class PartitionConfig:
    w1: float = DEFAULT_W1
    w2: float = DEFAULT_W2
    n_restarts: int = 4
    n_steps: int = 120
    lr: float = 0.03
    min_queries: int = 1  # stop splitting below this many intersecting queries
    min_objects: int = 8
    max_clusters: int = 512
    sigmoid_beta: float = 3.0  # paper uses sigma(3x)
    # The paper's sigma(3x) presumes coordinate deltas >> 1; in the unit square
    # we sharpen the relaxation by this factor during SGD (see DESIGN.md). The
    # accept/reject decision always uses hard indicators at the learned value.
    indicator_scale: float = 64.0
    consistent_init_cost: bool = True  # see DESIGN.md: keyword-conditioned C_s
    query_pad: int = 64  # pad workload slices to multiples of this
    # batched mode: cap the subspaces learned in one call
    max_split_batch: int = 16


def _pad_to(a: np.ndarray, size: int, fill) -> np.ndarray:
    if a.shape[0] >= size:
        return a[:size]
    pad = [(0, size - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, constant_values=fill)


@full_f32_matmul()
def _learn_split_impl(
    bank_tables: Dict[str, torch.Tensor],
    nn_params,
    spaces: torch.Tensor,  # (B, 4)
    q_rects: torch.Tensor,  # (B, Q, 4) padded
    q_entries: torch.Tensor,  # (B, Q, E) int64 padded -1
    q_signs: torch.Tensor,  # (B, Q, E) float32
    q_valid: torch.Tensor,  # (B, Q) bool
    lr: float,
    n_steps: int,
    n_restarts: int,
    beta: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (best_cost (B, 2), best_value (B, 2), base_cost (B,)) for dims
    x, y of each subspace, on the device.

    base_cost = estimated keyword-matching objects summed over valid queries
    for the *unsplit* space (used for the consistent init-cost mode).
    """
    B, Q, E = q_entries.shape
    R = n_restarts
    zero = spaces.new_zeros(())
    present = q_entries >= 0
    eids = torch.clamp(q_entries, min=0)
    uniq, inv = torch.unique(eids, return_inverse=True)
    U = uniq.shape[0]
    cnt = bank_tables["count"][eids][:, None]  # (B, 1, Q, E)
    ok = (present & (bank_tables["cls"][eids] != CLASS_LOW))[:, None, None]
    signs = q_signs[:, None, None]
    q_ok = q_valid[:, None, None]
    qlo = q_rects[..., :2].transpose(1, 2)[:, :, None]  # (B, 2, 1, Q)
    qhi = q_rects[..., 2:].transpose(1, 2)[:, :, None]
    lo, hi = spaces[:, :2], spaces[:, 2:]
    span = hi - lo
    idx = inv.reshape(B, 1, 1, Q * E)

    def per_query(table: torch.Tensor) -> torch.Tensor:
        """(B, 2, K, U) per distinct entry -> (B, 2, K, Q, E) per (query,
        entry), 0 at padded entries (``eval_cdf``'s -1 rule)."""
        K = table.shape[2]
        out = torch.gather(table, 3, idx.expand(B, 2, K, Q * E)).reshape(B, 2, K, Q, E)
        return torch.where(present[:, None, None], out, zero)

    def at(x: torch.Tensor) -> torch.Tensor:  # (B, 2, K) -> (B, 2, K, U)
        return x[..., None].expand(x.shape + (U,))

    cdf = cdf_table_fn(bank_tables, nn_params, uniq)
    with torch.no_grad():
        edges = per_query(cdf(at(torch.stack([lo, hi], 2))))
    f_lo, f_hi = edges[:, :, :1], edges[:, :, 1:]  # F_e^d at lo_d, hi_d: (B, 2, 1, Q, E)
    full = _clip01(f_hi - f_lo)  # each dimension's extent of the whole subspace
    other = full.flip(1)  # the extent of the dimension not being split

    def est_queries(fd: torch.Tensor) -> torch.Tensor:
        """(S, B, 2, R, Q, E) clipped extents along the split dimension (S
        sides) -> (S, B, 2, R, Q) estimated matches per query, products in
        ``est_count_rect``'s order (count * fx * fy)."""
        est = torch.stack([(cnt * fd[:, :, 0]) * other[:, 0], (cnt * other[:, 1]) * fd[:, :, 1]], 2)
        est = torch.where(ok, est, zero)
        return torch.maximum((torch.maximum(est, zero) * signs).sum(-1), zero)

    est0 = torch.where(ok[:, 0], (cnt * full[:, 0]) * full[:, 1], zero)
    base_q = torch.maximum((torch.maximum(est0, zero) * signs[:, 0]).sum(-1), zero)
    base = torch.where(q_valid[:, None], base_q, zero).sum(-1)[:, 0]

    def loss_dim(v: torch.Tensor, f_v: torch.Tensor, hard: bool) -> torch.Tensor:
        o1, o2 = est_queries(_clip01(torch.stack([f_v - f_lo, f_hi - f_v])))  # left, right of v
        vq = v[..., None]
        if hard:
            s1 = (vq >= qlo).float()
            s2 = (qhi >= vq).float()
        else:
            s1 = torch.sigmoid(beta * (vq - qlo))
            s2 = torch.sigmoid(beta * (qhi - vq))
        per_q = s1 * o1 + s2 * o2
        return torch.where(q_ok, per_q, zero).sum(-1)  # (B, 2, R)

    restarts = torch.arange(R, dtype=torch.float32, device=spaces.device)
    v = lo[..., None] + span[..., None] * (restarts + 1.0) / (R + 1.0)  # (B, 2, R)
    m = torch.zeros_like(v)
    u = torch.zeros_like(v)
    it = torch.zeros(1, dtype=torch.int64, device=spaces.device)  # the step count, on the device
    t = torch.arange(1, n_steps + 1, dtype=torch.float32, device=spaces.device)
    c1 = 1 - torch.full_like(t, 0.9) ** t
    c2 = 1 - torch.full_like(t, 0.999) ** t
    step = (lr * span)[..., None]
    v_min = (lo + 1e-6)[..., None]
    v_max = (hi - 1e-6)[..., None]

    def adam_step():
        """One Adam step on ``v``, ``m``, ``u`` and ``it`` in place."""
        # F_e^d(v) and dF/dv per distinct entry: each column is its own leaf
        v_u = at(v).clone().requires_grad_(True)
        table = cdf(v_u)
        (slope,) = torch.autograd.grad(table.sum(), v_u)
        f_v = per_query(table.detach()).requires_grad_(True)
        v_leaf = v.clone().requires_grad_(True)
        g_f, g_v = torch.autograd.grad(loss_dim(v_leaf, f_v, False).sum(), [f_v, v_leaf])
        with torch.no_grad():
            g = g_v + (g_f * per_query(slope)).sum((-2, -1))
            m.mul_(0.9).add_(0.1 * g)
            u.mul_(0.999).add_(0.001 * g * g)
            mhat = m / c1.gather(0, it)
            uhat = u / c2.gather(0, it)
            v.copy_(torch.minimum(torch.maximum(v - step * mhat / (torch.sqrt(uhat) + 1e-8), v_min),
                                  v_max))
            it.add_(1)

    _repeat(adam_step, n_steps, (v, m, u, it))
    with torch.no_grad():
        # decision cost with hard indicators (see PartitionConfig docstring)
        ls = loss_dim(v, per_query(cdf(at(v))), True)
        j = torch.argmin(ls, dim=-1, keepdim=True)  # the first minimum, as jnp.argmin
        return ls.gather(-1, j)[..., 0], v.gather(-1, j)[..., 0], base


def _repeat(step, n: int, state) -> None:
    """Run ``step`` ``n`` times. On CUDA the step is captured once as a CUDA
    graph and replayed: the same kernels on the same tensors, without the
    host's launch overhead, which sets the pace of a small step. ``state``
    (the tensors ``step`` updates in place) is put back after the warm-up
    runs that capture needs."""
    if n == 0:
        return
    if state[0].device.type != "cuda":
        for _ in range(n):
            step()
        return
    saved = [x.clone() for x in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    for x, s in zip(state, saved):
        x.copy_(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(n):
        graph.replay()


def _learn_split(
    bank_tables,
    nn_params,
    space,
    q_rects,
    q_entries,
    q_signs,
    q_valid,
    lr: float = 0.03,
    n_steps: int = 120,
    n_restarts: int = 4,
    beta: float = 3.0,
):
    """One-subspace entry point (sequential mode): numpy in, numpy out
    (costs (2,), values (2,), base)."""
    costs, values, base = _learn_split_batched(
        bank_tables, nn_params, space[None], q_rects[None], q_entries[None], q_signs[None],
        q_valid[None], lr=lr, n_steps=n_steps, n_restarts=n_restarts, beta=beta)
    return costs[0], values[0], base[0]


def _learn_split_batched(
    bank_tables,
    nn_params,
    spaces,  # (B, 4)
    q_rects,  # (B, Q, 4)
    q_entries,  # (B, Q, E)
    q_signs,  # (B, Q, E)
    q_valid,  # (B, Q)
    lr: float = 0.03,
    n_steps: int = 120,
    n_restarts: int = 4,
    beta: float = 3.0,
):
    """Learn the split of every subspace of the round's chunk in one call:
    numpy in, numpy out (costs (B, 2), values (B, 2), base (B,)), one copy
    back to the host. Padded queries carry ``q_valid`` False and add 0."""
    dev = bank_tables["count"].device
    sp, qr, qe, qs, qv = (torch.as_tensor(np.ascontiguousarray(a, t), device=dev) for a, t in (
        (spaces, np.float32), (q_rects, np.float32), (q_entries, np.int64), (q_signs, np.float32),
        (q_valid, bool)))
    costs, values, base = _learn_split_impl(
        bank_tables, nn_params, sp, qr, qe, qs, qv, lr, n_steps, n_restarts, beta)
    out = torch.cat([costs, values, base[:, None]], 1).cpu().numpy()
    return out[:, :2], out[:, 2:4], out[:, 4]


@dataclasses.dataclass
class _SubSpace:
    rect: np.ndarray  # (4,)
    obj_ids: np.ndarray
    query_ids: np.ndarray


@dataclasses.dataclass
class PartitionResult:
    clusters: ClusterSet
    n_splits: int
    n_sgd_calls: int  # split-learning problem instances solved
    history: List[Dict]
    # execution-strategy counters: rounds of frontier-parallel processing
    # and learner calls made. In sequential mode n_dispatches ==
    # n_sgd_calls (one call per subspace) and n_rounds degenerates to the
    # same count.
    n_rounds: int = 0
    n_dispatches: int = 0
    mode: str = "sequential"


def _pad_queries(workload: Workload, q_entries, q_signs, s: _SubSpace, Q: int):
    """Pad one subspace's query slice to width Q (validity-masked)."""
    nq = s.query_ids.size
    qr = _pad_to(workload.rects[s.query_ids], Q, 0.0)
    qe = _pad_to(q_entries[s.query_ids], Q, -1)
    qs = _pad_to(q_signs[s.query_ids], Q, 0.0)
    qv = np.zeros(Q, dtype=bool)
    qv[: min(nq, Q)] = True
    return qr, qe, qs, qv


def _split_children(
    dataset: GeoTextDataset, workload: Workload, s: _SubSpace, d: int, val: float
) -> Optional[Tuple[_SubSpace, _SubSpace]]:
    """Materialize the two children of an accepted split, or None when one
    side would be empty (the subspace is finalized instead, per Alg. 2)."""
    locs = dataset.locs[s.obj_ids]
    left_mask = locs[:, d] <= val
    lids, rids = s.obj_ids[left_mask], s.obj_ids[~left_mask]
    if not (lids.size and rids.size):
        return None
    lrect = s.rect.copy()
    lrect[2 + d] = val
    rrect = s.rect.copy()
    rrect[d] = val
    qrects = workload.rects[s.query_ids]
    lq = s.query_ids[rects_intersect(qrects, lrect[None, :]).astype(bool).reshape(-1)]
    rq = s.query_ids[rects_intersect(qrects, rrect[None, :]).astype(bool).reshape(-1)]
    return _SubSpace(lrect, lids, lq), _SubSpace(rrect, rids, rq)


def _decide(cfg: PartitionConfig, m: int, costs, values, base, nq: int, no: int):
    """Alg. 2 line 10 accept test on one learned result; returns history row."""
    d = int(np.argmin(costs))
    best_cost, best_val = float(costs[d]), float(values[d])
    if cfg.consistent_init_cost:
        c_s = cfg.w2 * float(base)
    else:
        c_s = cfg.w2 * no * nq  # paper-literal |O_s| * |W_s| * w2
    gain = c_s - cfg.w2 * best_cost
    loss = cfg.w1 * m
    return d, best_val, gain, loss


def _root_subspace(dataset: GeoTextDataset, m: int) -> _SubSpace:
    space0 = np.array([0.0, 0.0, 1.0, 1.0], dtype=np.float32)
    # shrink to data MBR
    if dataset.n:
        space0 = np.array(
            [
                dataset.locs[:, 0].min(),
                dataset.locs[:, 1].min(),
                dataset.locs[:, 0].max(),
                dataset.locs[:, 1].max(),
            ],
            dtype=np.float32,
        )
    return _SubSpace(space0, np.arange(dataset.n), np.arange(m))


def _finalize(dataset: GeoTextDataset, final: List[_SubSpace]) -> ClusterSet:
    assign = np.zeros(dataset.n, dtype=np.int32)
    keep = [s for s in final if s.obj_ids.size > 0]
    for ci, s in enumerate(keep):
        assign[s.obj_ids] = ci
    return ClusterSet.from_assignment(dataset, assign)


def generate_bottom_clusters(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    config: Optional[PartitionConfig] = None,
    mode: str = "batched",
) -> PartitionResult:
    """Alg. 2: returns the learned flat partition (bottom clusters).

    ``mode="batched"`` runs frontier-parallel rounds (device dispatches scale
    with tree depth); ``mode="sequential"`` is the original one-subspace-per-
    call heap loop (DESIGN.md §5). The batched mode replays the sequential
    heap walk over batch-learned decisions, so both modes accept/reject
    identical splits and produce the identical cluster set -- including when
    the ``max_clusters`` budget binds (tests/test_build_parity.py).
    """
    cfg = config or PartitionConfig()
    if mode == "sequential":
        return _generate_sequential(dataset, workload, bank, q_entries, q_signs, cfg)
    if mode == "batched":
        return _generate_batched(dataset, workload, bank, q_entries, q_signs, cfg)
    raise ValueError(f"unknown partition mode {mode!r}")


def _generate_sequential(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    cfg: PartitionConfig,
) -> PartitionResult:
    root = _root_subspace(dataset, workload.m)
    final, n_splits, n_sgd, history = _walk_sequential(
        dataset, workload, bank, q_entries, q_signs, cfg, root
    )
    clusters = _finalize(dataset, final)
    return PartitionResult(
        clusters=clusters,
        n_splits=n_splits,
        n_sgd_calls=n_sgd,
        history=history,
        n_rounds=n_sgd,
        n_dispatches=n_sgd,
        mode="sequential",
    )


def _walk_sequential(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    cfg: PartitionConfig,
    root: _SubSpace,
) -> Tuple[List[_SubSpace], int, int, List[Dict]]:
    """The Alg. 2 heap walk from an arbitrary root subspace. Returns the
    final (un-finalized) subspaces so callers can either build a full
    ``ClusterSet`` (``generate_bottom_clusters``) or splice the result into
    an existing partition (``refine_partition``)."""
    tables = bank.tables()
    nn_params = bank.nn_params
    m = workload.m

    heap: List[Tuple[int, int, _SubSpace]] = []
    counter = 0
    heapq.heappush(heap, (-root.query_ids.size, counter, root))
    final: List[_SubSpace] = []
    n_splits = 0
    n_sgd = 0
    history: List[Dict] = []

    while heap:
        _, _, s = heapq.heappop(heap)
        nq, no = s.query_ids.size, s.obj_ids.size
        done = (
            nq < cfg.min_queries
            or no <= cfg.min_objects
            or len(final) + len(heap) + 1 >= cfg.max_clusters
        )
        if not done:
            Q = int(np.ceil(max(nq, 1) / cfg.query_pad) * cfg.query_pad)
            qr, qe, qs, qv = _pad_queries(workload, q_entries, q_signs, s, Q)
            costs, values, base = _learn_split(
                tables,
                nn_params,
                s.rect,
                qr,
                qe,
                qs,
                qv,
                lr=cfg.lr,
                n_steps=cfg.n_steps,
                n_restarts=cfg.n_restarts,
                beta=cfg.sigmoid_beta * cfg.indicator_scale,
            )
            n_sgd += 1
            d, best_val, gain, loss = _decide(
                cfg, m, np.asarray(costs), np.asarray(values), base, nq, no
            )
            history.append(
                dict(rect=s.rect.tolist(), nq=nq, no=no, dim=d, val=best_val, gain=gain, loss=loss)
            )
            if gain > loss:
                children = _split_children(dataset, workload, s, d, best_val)
                if children is not None:
                    n_splits += 1
                    for child in children:
                        counter += 1
                        heapq.heappush(heap, (-child.query_ids.size, counter, child))
                    continue
        final.append(s)

    return final, n_splits, n_sgd, history


def _learn_frontier(
    workload: Workload,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    cfg: PartitionConfig,
    tables,
    nn_params,
    batch: List[_SubSpace],
) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray, float]], int]:
    """Learn every subspace in ``batch``, one learner call per power-of-two
    query-width bucket and ``max_split_batch`` chunk (DESIGN.md §5). Returns
    ``{id(subspace): (costs, values, base)}`` plus the call count."""
    E = q_entries.shape[1]
    results: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
    n_dispatches = 0
    by_q: Dict[int, List[_SubSpace]] = {}
    for s in batch:
        Q = round_up_bucket(max(int(s.query_ids.size), 1), cfg.query_pad)
        by_q.setdefault(Q, []).append(s)
    for Q, group in sorted(by_q.items()):
        for lo_i in range(0, len(group), cfg.max_split_batch):
            chunk = group[lo_i : lo_i + cfg.max_split_batch]
            B = len(chunk)
            spaces = np.zeros((B, 4), np.float32)
            qr = np.zeros((B, Q, 4), np.float32)
            qe = np.full((B, Q, E), -1, np.int32)
            qs = np.zeros((B, Q, E), np.float32)
            qv = np.zeros((B, Q), bool)
            for bi, s in enumerate(chunk):
                spaces[bi] = s.rect
                qr[bi], qe[bi], qs[bi], qv[bi] = _pad_queries(workload, q_entries, q_signs, s, Q)
            costs_b, values_b, base_b = _learn_split_batched(
                tables,
                nn_params,
                spaces,
                qr,
                qe,
                qs,
                qv,
                lr=cfg.lr,
                n_steps=cfg.n_steps,
                n_restarts=cfg.n_restarts,
                beta=cfg.sigmoid_beta * cfg.indicator_scale,
            )
            n_dispatches += 1
            costs_b = np.asarray(costs_b)
            values_b = np.asarray(values_b)
            base_b = np.asarray(base_b)
            for bi, s in enumerate(chunk):
                results[id(s)] = (costs_b[bi], values_b[bi], float(base_b[bi]))
    return results, n_dispatches


def _generate_batched(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    cfg: PartitionConfig,
) -> PartitionResult:
    """Frontier-parallel Alg. 2 (DESIGN.md §5).

    Each round learns the splits of *all* currently splittable heap
    residents in batched learner calls, then replays the sequential
    priority-heap walk over the learned decisions -- identical pop order,
    identical pop-time ``max_clusters`` check -- so the accepted cluster set
    matches the sequential mode exactly (even under a binding budget), while
    device dispatches scale with the walk's blocking depth (~tree depth)
    instead of node count.
    """
    root = _root_subspace(dataset, workload.m)
    final, n_splits, n_sgd, history, n_rounds, n_dispatches = _walk_batched(
        dataset, workload, bank, q_entries, q_signs, cfg, root
    )
    clusters = _finalize(dataset, final)
    return PartitionResult(
        clusters=clusters,
        n_splits=n_splits,
        n_sgd_calls=n_sgd,
        history=history,
        n_rounds=n_rounds,
        n_dispatches=n_dispatches,
        mode="batched",
    )


def _walk_batched(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    cfg: PartitionConfig,
    root: _SubSpace,
) -> Tuple[List[_SubSpace], int, int, List[Dict], int, int]:
    """Frontier-parallel Alg. 2 walk from an arbitrary root subspace (the
    batched twin of ``_walk_sequential``; same replay-parity contract)."""
    tables = bank.tables()
    nn_params = bank.nn_params
    m = workload.m

    heap: List[Tuple[int, int, _SubSpace]] = []
    counter = 0
    heapq.heappush(heap, (-root.query_ids.size, counter, root))
    final: List[_SubSpace] = []
    decided: Dict[int, Tuple[np.ndarray, np.ndarray, float]] = {}
    n_splits = 0
    n_sgd = 0
    n_rounds = 0
    n_dispatches = 0
    history: List[Dict] = []

    while heap:
        # ---- learning round: every undecided, non-size-terminal resident.
        # (Residents the budget later finalizes are learned speculatively;
        # that waste is bounded by one heap's width.)
        batch = [
            s
            for (_, _, s) in heap
            if id(s) not in decided
            and s.query_ids.size >= cfg.min_queries
            and s.obj_ids.size > cfg.min_objects
        ]
        if batch:
            n_rounds += 1
            n_sgd += len(batch)
            results, nd = _learn_frontier(
                workload, q_entries, q_signs, cfg, tables, nn_params, batch
            )
            decided.update(results)
            n_dispatches += nd

        # ---- replay the sequential heap walk until an unlearned child
        # reaches the top (next round) or the heap drains
        progressed = False
        while heap:
            _, _, s = heap[0]
            nq, no = s.query_ids.size, s.obj_ids.size
            # pop-time check identical to the sequential loop's (the peeked
            # node is still in the heap, hence no +1 here)
            terminal = (
                nq < cfg.min_queries
                or no <= cfg.min_objects
                or len(final) + len(heap) >= cfg.max_clusters
            )
            if not terminal and id(s) not in decided:
                break
            heapq.heappop(heap)
            progressed = True
            if terminal:
                # drop any speculative decision: keeps the id()-keyed cache
                # covering live heap residents only (no stale-id hazard)
                decided.pop(id(s), None)
                final.append(s)
                continue
            costs, values, base = decided.pop(id(s))
            d, best_val, gain, loss = _decide(cfg, m, costs, values, base, nq, no)
            history.append(
                dict(rect=s.rect.tolist(), nq=nq, no=no, dim=d, val=best_val, gain=gain, loss=loss)
            )
            children = _split_children(dataset, workload, s, d, best_val) if gain > loss else None
            if children is None:
                final.append(s)
            else:
                n_splits += 1
                for child in children:
                    counter += 1
                    heapq.heappush(heap, (-child.query_ids.size, counter, child))
        if heap and not progressed and not batch:  # defensive: cannot happen
            _, _, s = heapq.heappop(heap)
            final.append(s)

    return final, n_splits, n_sgd, history, n_rounds, n_dispatches


# ----------------------------------------------- warm-start partial refinement
@dataclasses.dataclass
class RefineResult:
    """A partition spliced from kept clusters + re-learned subspaces.

    ``source[c]`` is the previous cluster each new cluster came from
    (identity for kept clusters) -- the mapping the warm-start hierarchy
    graft uses to inherit parent slots (core/build.py:warm_start_rebuild).
    """

    clusters: ClusterSet
    source: np.ndarray  # (k_new,) int32 previous-cluster id per new cluster
    n_refined: int  # regressed leaves re-learned
    n_kept: int  # clusters kept verbatim
    n_splits: int
    n_sgd_calls: int
    n_dispatches: int


def refine_partition(
    dataset: GeoTextDataset,
    workload: Workload,
    bank: CDFBank,
    q_entries: np.ndarray,
    q_signs: np.ndarray,
    prev: ClusterSet,
    regressed: np.ndarray,
    config: Optional[PartitionConfig] = None,
    mode: str = "batched",
) -> RefineResult:
    """Re-learn the splits of the ``regressed`` leaves only (DESIGN.md §7).

    Every non-regressed cluster of ``prev`` is kept verbatim; each
    regressed leaf becomes the root of its own Alg. 2 walk (rect = leaf
    MBR, objects = members, queries = the new workload's queries that
    intersect it and share a keyword) with an equal share of the remaining
    ``max_clusters`` budget. The result is the warm-start rebuild's bottom
    partition: identical learned splits where the workload did not move,
    fresh ones where it did.
    """
    cfg = config or PartitionConfig()
    regressed = np.asarray(regressed, bool)
    k_prev = prev.k
    keep = np.nonzero(~regressed)[0]
    refine = np.nonzero(regressed)[0]
    budget_left = max(cfg.max_clusters - keep.size, 2 * refine.size)
    per_leaf_budget = max(2, budget_left // max(refine.size, 1))

    n_splits = n_sgd = n_disp = 0
    assign = np.full(dataset.n, -1, np.int64)
    source: List[int] = []
    next_id = 0
    for c in keep:
        ids = prev.order[prev.offsets[c] : prev.offsets[c + 1]]
        assign[ids] = next_id
        source.append(int(c))
        next_id += 1
    for c in refine:
        obj_ids = prev.order[prev.offsets[c] : prev.offsets[c + 1]].astype(np.int64)
        rect = prev.mbrs[c].copy()
        qsel = (
            rects_intersect(workload.rects, rect[None, :]).reshape(-1)
            & np.any(workload.kw_bitmap & prev.bitmaps[c][None, :] != 0, axis=-1)
        )
        root = _SubSpace(rect, obj_ids, np.nonzero(qsel)[0])
        sub_cfg = dataclasses.replace(cfg, max_clusters=per_leaf_budget)
        if mode == "sequential":
            final, ns, nq, _ = _walk_sequential(
                dataset, workload, bank, q_entries, q_signs, sub_cfg, root
            )
            nd = nq
        else:
            final, ns, nq, _, _, nd = _walk_batched(
                dataset, workload, bank, q_entries, q_signs, sub_cfg, root
            )
        n_splits += ns
        n_sgd += nq
        n_disp += nd
        for s in final:
            if s.obj_ids.size == 0:
                continue
            assign[s.obj_ids] = next_id
            source.append(int(c))
            next_id += 1
    clusters = ClusterSet.from_assignment(dataset, assign.astype(np.int32))
    return RefineResult(
        clusters=clusters,
        source=np.asarray(source, np.int32),
        n_refined=int(refine.size),
        n_kept=int(keep.size),
        n_splits=n_splits,
        n_sgd_calls=n_sgd,
        n_dispatches=n_disp,
    )
