"""Keyword-conditioned CDF models (paper §4.3.1 + §6 "Choice of CDF models").

Per keyword ``k`` and spatial dimension ``d`` we model the marginal CDF
``F_k^d`` of the locations of objects containing ``k``. Keywords are
stratified by frequency (thresholds are *fractions of the dataset size*,
matching the paper's percentage bands):

* high   (freq ratio >= ``high_thresh``): an MLP (1->16->16->1 by default),
  ReLU hidden, sigmoid head, trained with MSE on empirical quantiles --
  trained for *all* high keywords at once as batched matrix products over
  the bank dimension, with an explicit Adam, on the device;
* medium (``low_thresh`` <= ratio < ``high_thresh``): Gaussian CDF with
  moment-matched (mu, sigma);
* low    (< ``low_thresh``): ignored (estimate 0), per the paper.

The bank also hosts *frequent itemset* entries (appended virtual keywords)
so multi-keyword queries can be corrected by inclusion-exclusion (§6).

The class tables are numpy; the MLP weights are ``(B, ...)`` tensors on the
device, ``w{i}`` laid out ``(in, out)`` as in the JAX package's
``core/cdf.py``, whose semantics this module keeps. Every random draw comes
from a seeded CPU ``torch.Generator`` and is then moved to the device, so a
bank's weights do not depend on the device it trains on. ``cdf_table_fn``
evaluates the bank once per distinct (entry, coordinate), the form the
split learner (``core/partition.py``) uses.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import full_f32_matmul, resolve_device
from .types import GeoTextDataset

CLASS_LOW, CLASS_MED, CLASS_HIGH = 0, 1, 2

_SQRT2 = math.sqrt(2.0)


def mlp_init(
    generator: torch.Generator,
    widths: Sequence[int],
    n_models: Optional[int] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """He-normal weights ``w{i}`` (in, out) and zero biases ``b{i}`` for one
    CDF MLP, or a bank of ``n_models`` with a leading dimension; widths e.g.
    (1, 16, 16, 1). Drawn from ``generator`` (CPU), then moved to ``device``."""
    lead = () if n_models is None else (n_models,)
    params = {}
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        w = torch.randn(lead + (fan_in, fan_out), generator=generator) * math.sqrt(2.0 / fan_in)
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(lead + (fan_out,), device=device)
    return params


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: (..., P, 1) -> (..., P) in [0, 1]; params with the same leading
    dimensions as ``x`` (none for one model)."""
    h = x
    n_layers = len(params) // 2
    for i in range(n_layers):
        h = torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(-2)
        if i < n_layers - 1:
            h = torch.relu(h)
    return torch.sigmoid(h[..., 0])


def _empirical_quantiles(values: np.ndarray, n_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Return (x, F(x)) pairs: quantile coordinates and CDF targets."""
    v = np.sort(values)
    # targets: mid-rank CDF, plus anchors at domain edges
    qs = (np.arange(n_points) + 0.5) / n_points
    xs = np.quantile(v, qs)
    xs = np.concatenate([[0.0], xs, [1.0]])
    ys = np.concatenate([[0.0], qs, [1.0]])
    return xs.astype(np.float32), ys.astype(np.float32)


@dataclasses.dataclass
class CDFBank:
    """Stacked CDF models over ``n_entries = V + n_itemsets`` entries.

    cls:      (E,) int8 class per entry
    count:    (E,) float32 #objects containing the entry's keyword(-set)
    gauss:    (E, 2, 2) float32 (mu, sigma) per dim (valid where cls==MED)
    nn_slot:  (E,) int32 slot into the stacked NN params, -1 if none
    nn_params: dict of (2 * n_high, ...) tensors on ``device``, model
              ``2 * slot + dim`` (valid where cls==HIGH)
    """

    cls: np.ndarray
    count: np.ndarray
    gauss: np.ndarray
    nn_slot: np.ndarray
    nn_params: Optional[Dict[str, torch.Tensor]]
    vocab_size: int
    train_loss: float = 0.0
    device: torch.device = torch.device("cpu")

    @property
    def n_entries(self) -> int:
        return int(self.cls.shape[0])

    def tables(self) -> Dict[str, torch.Tensor]:
        """The class tables as tensors on the bank's device."""
        dev = self.device
        return dict(
            cls=torch.as_tensor(self.cls, dtype=torch.int32, device=dev),
            count=torch.as_tensor(self.count, dtype=torch.float32, device=dev),
            gauss=torch.as_tensor(self.gauss, dtype=torch.float32, device=dev),
            nn_slot=torch.as_tensor(self.nn_slot, dtype=torch.int64, device=dev),
        )

    def to(self, device) -> "CDFBank":
        """The same bank with its weights on ``device``."""
        dev = torch.device(device)
        params = None if self.nn_params is None else {
            k: a.to(dev) for k, a in self.nn_params.items()}
        return dataclasses.replace(self, nn_params=params, device=dev)


def bank_from_reference(fields: Dict, device=None) -> CDFBank:
    """A ``CDFBank`` from the JAX package's bank as numpy arrays: ``cls``,
    ``count``, ``gauss``, ``nn_slot``, ``nn_params`` (``w0, b0, ...`` with a
    leading B, or None), ``vocab_size`` and ``train_loss``. The layouts are
    the same, so the weights carry over unchanged."""
    dev = resolve_device(device)
    nn = fields["nn_params"]
    return CDFBank(
        cls=np.asarray(fields["cls"], np.int8),
        count=np.asarray(fields["count"], np.float32),
        gauss=np.asarray(fields["gauss"], np.float32),
        nn_slot=np.asarray(fields["nn_slot"], np.int32),
        nn_params=None if nn is None else {
            k: torch.as_tensor(np.array(a, np.float32), device=dev) for k, a in nn.items()},
        vocab_size=int(fields["vocab_size"]),
        train_loss=float(fields["train_loss"]),
        device=dev,
    )


@full_f32_matmul()
def _train_mlp_bank(
    params: Dict[str, torch.Tensor],
    xs: torch.Tensor,  # (B, P) quantile coords per model
    ys: torch.Tensor,  # (B, P) cdf targets
    lr: float = 0.05,
    n_steps: int = 300,
) -> Tuple[Dict[str, torch.Tensor], float]:
    """Adam on the MSE over the whole bank, batched over its B models.
    Returns the trained weights and the loss of the last step (before its
    update), read back once."""
    p = {k: a.detach().clone() for k, a in params.items()}
    m = {k: torch.zeros_like(a) for k, a in p.items()}
    v = {k: torch.zeros_like(a) for k, a in p.items()}
    t = torch.arange(1, n_steps + 1, dtype=torch.float32, device=xs.device)
    c1 = 1 - torch.full_like(t, 0.9) ** t
    c2 = 1 - torch.full_like(t, 0.999) ** t
    x = xs[..., None]
    loss = torch.zeros((), device=xs.device)
    for i in range(n_steps):
        leaves = {k: a.requires_grad_(True) for k, a in p.items()}
        d = mlp_apply(leaves, x) - ys
        loss = (d * d).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, a), g in zip(leaves.items(), grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                mhat = m[k] / c1[i]
                vhat = v[k] / c2[i]
                p[k] = a.detach() - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return p, float(loss.detach())


def build_cdf_bank(
    dataset: GeoTextDataset,
    itemsets: Optional[List[Tuple[int, ...]]] = None,
    itemset_members: Optional[List[np.ndarray]] = None,
    high_thresh: float = 0.001,  # >=0.1% of objects -> NN (paper: >=0.1%)
    low_thresh: float = 0.00001,  # <0.001% -> ignored
    n_points: int = 128,
    n_steps: int = 300,
    hidden: int = 16,
    n_hidden_layers: int = 2,
    seed: int = 0,
    force_class: Optional[str] = None,  # "gauss" | "nn" for the ablation
    device=None,
) -> CDFBank:
    """Fit the stratified CDF bank for all keywords (+ frequent itemsets),
    the MLPs on ``device`` (``cuda`` unless the caller names another).

    ``itemsets`` are tuples of keyword ids; ``itemset_members[i]`` are the
    object ids containing *all* keywords of itemset i (from the miner).
    """
    dev = resolve_device(device)
    V = dataset.vocab_size
    itemsets = itemsets or []
    itemset_members = itemset_members or []
    E = V + len(itemsets)
    n = max(dataset.n, 1)

    # member object lists per entry
    member_lists: List[np.ndarray] = [None] * E  # type: ignore
    rows, cols = np.nonzero(dataset.kw_ids >= 0)
    ids = dataset.kw_ids[rows, cols]
    order = np.argsort(ids, kind="stable")
    ids_s, rows_s = ids[order], rows[order]
    uk, start = np.unique(ids_s, return_index=True)
    bounds = np.append(start, ids_s.size)
    for j, k in enumerate(uk):
        member_lists[int(k)] = rows_s[bounds[j] : bounds[j + 1]]
    for i, mem in enumerate(itemset_members):
        member_lists[V + i] = np.asarray(mem, dtype=np.int64)

    counts = np.array([0 if m is None else m.size for m in member_lists], dtype=np.float32)
    ratio = counts / n
    cls = np.full(E, CLASS_LOW, dtype=np.int8)
    cls[(ratio >= low_thresh) & (counts >= 2)] = CLASS_MED
    cls[(ratio >= high_thresh) & (counts >= 4)] = CLASS_HIGH
    if force_class == "gauss":
        cls[cls == CLASS_HIGH] = CLASS_MED
    elif force_class == "nn":
        cls[(cls == CLASS_MED) & (counts >= 4)] = CLASS_HIGH

    gauss = np.zeros((E, 2, 2), dtype=np.float32)
    gauss[:, 1, :] = 1.0  # sd row defaults to 1 (safe for unfitted entries)
    nn_slot = np.full(E, -1, dtype=np.int32)

    high_ids = np.nonzero(cls == CLASS_HIGH)[0]
    med_ids = np.nonzero(cls == CLASS_MED)[0]

    for e in med_ids:
        pts = dataset.locs[member_lists[e]]
        mu = pts.mean(axis=0)
        sd = pts.std(axis=0) + 1e-4
        gauss[e, 0] = mu
        gauss[e, 1] = sd

    nn_params = None
    final_loss = 0.0
    if high_ids.size:
        nn_slot[high_ids] = np.arange(high_ids.size, dtype=np.int32)
        # quantile training data: (n_high*2, P) -- x and y dims interleaved
        P = n_points
        xs = np.zeros((high_ids.size, 2, P + 2), dtype=np.float32)
        ys = np.zeros((high_ids.size, 2, P + 2), dtype=np.float32)
        for j, e in enumerate(high_ids):
            pts = dataset.locs[member_lists[e]]
            for d in range(2):
                xs[j, d], ys[j, d] = _empirical_quantiles(pts[:, d], P)
        widths = (1,) + (hidden,) * n_hidden_layers + (1,)
        B = high_ids.size * 2
        params = mlp_init(torch.Generator().manual_seed(seed), widths, n_models=B, device=dev)
        nn_params, final_loss = _train_mlp_bank(
            params,
            torch.as_tensor(xs.reshape(B, -1), device=dev),
            torch.as_tensor(ys.reshape(B, -1), device=dev),
            n_steps=n_steps,
        )

    return CDFBank(
        cls=cls,
        count=counts,
        gauss=gauss,
        nn_slot=nn_slot,
        nn_params=nn_params,
        vocab_size=V,
        train_loss=final_loss,
        device=dev,
    )


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: max then min, whose gradient at a tie is
    split in half (``torch.clamp`` would pass all of it)."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def _gauss_cdf(x: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    sd = torch.clamp(sd, min=1e-5)  # guard: sd=0 would make erf'(inf) NaN-poison grads
    return 0.5 * (1.0 + torch.erf((x - mu) / (sd * _SQRT2)))


def cdf_table_fn(
    bank_tables: Dict[str, torch.Tensor],
    nn_params: Optional[Dict[str, torch.Tensor]],
    entries: torch.Tensor,  # (U,) distinct entries, >= 0
):
    """The bank evaluated once per distinct (entry, coordinate): for fixed
    ``entries`` (their classes, Gaussians and MLP weights read once) a
    function of ``x`` (..., 2, K, U) -- dimension, point, entry -- giving
    ``F_u^d(x[..., d, k, u])`` clipped to [0, 1], each entry's MLP run on
    its own column. Differentiable in ``x``, with no scatter in its
    gradient."""
    U = entries.shape[0]
    high = bank_tables["cls"][entries] == CLASS_HIGH
    gauss = bank_tables["gauss"][entries]  # (U, 2, 2)
    mu = gauss[:, 0, :].T[:, None, :]  # (2, 1, U)
    sd = gauss[:, 1, :].T[:, None, :]
    p = None
    if nn_params is not None:
        slot = torch.clamp(bank_tables["nn_slot"][entries], min=0)
        models = torch.stack([slot * 2, slot * 2 + 1]).reshape(-1)  # (2U,) by (dim, entry)
        p = {k: a[models] for k, a in nn_params.items()}

    def table(x: torch.Tensor) -> torch.Tensor:
        g = _gauss_cdf(x, mu, sd)
        if p is None:
            return _clip01(g)
        lead = x.shape[:-3]
        K = x.shape[-2]
        cols = x.movedim(-1, 0).movedim(-2, 0)  # (2, U, ..., K)
        nn = mlp_apply(p, cols.reshape(2 * U, -1, 1))
        nn = nn.reshape((2, U) + lead + (K,)).movedim(1, -1).movedim(0, -3)
        return _clip01(torch.where(high, nn, g))

    return table


_EVAL_CHUNK = 1 << 16  # elements a weight gather holds at once in eval_cdf


def eval_cdf(
    bank_tables: Dict[str, torch.Tensor],
    nn_params: Optional[Dict[str, torch.Tensor]],
    entry_ids: torch.Tensor,  # (B,) entries (keywords or itemset slots), -1 = invalid
    x: torch.Tensor,  # (B,) coordinates
    dim: int,  # 0 = x, 1 = y
) -> torch.Tensor:
    """F_e^dim(x) per element. Invalid/low entries return 0 contribution later
    (the *count* estimator multiplies by entry count which is 0-masked)."""
    eids = torch.clamp(entry_ids, min=0)
    cls = bank_tables["cls"][eids]
    mu = bank_tables["gauss"][eids, 0, dim]
    sd = bank_tables["gauss"][eids, 1, dim]
    out = _gauss_cdf(x, mu, sd)
    if nn_params is not None:
        slot = torch.clamp(bank_tables["nn_slot"][eids], min=0) * 2 + dim
        nn = torch.cat([
            mlp_apply({k: a[slot[i:i + _EVAL_CHUNK]] for k, a in nn_params.items()},
                      x[i:i + _EVAL_CHUNK, None, None])[:, 0]
            for i in range(0, x.shape[0], _EVAL_CHUNK)] or [x[:0]])
        out = torch.where(cls == CLASS_HIGH, nn, out)
    out = _clip01(out)
    return torch.where(entry_ids < 0, out.new_zeros(()), out)


def est_count_rect(
    bank_tables: Dict[str, torch.Tensor],
    nn_params: Optional[Dict[str, torch.Tensor]],
    entry_ids: torch.Tensor,  # (B,)
    rect: torch.Tensor,  # (B, 4) or (4,)
) -> torch.Tensor:
    """Estimated #objects containing entry e inside rect (Lemma 4.2):
    n_e * (Fx(xu)-Fx(xl)) * (Fy(yu)-Fy(yl)). Low-class entries contribute 0.
    """
    rect = torch.broadcast_to(rect, entry_ids.shape + (4,))
    eids = torch.clamp(entry_ids, min=0)
    cnt = bank_tables["count"][eids]
    cls = bank_tables["cls"][eids]
    fx = eval_cdf(bank_tables, nn_params, entry_ids, rect[..., 2], 0) - eval_cdf(
        bank_tables, nn_params, entry_ids, rect[..., 0], 0
    )
    fy = eval_cdf(bank_tables, nn_params, entry_ids, rect[..., 3], 1) - eval_cdf(
        bank_tables, nn_params, entry_ids, rect[..., 1], 1
    )
    est = cnt * _clip01(fx) * _clip01(fy)
    valid = (entry_ids >= 0) & (cls != CLASS_LOW)
    return torch.where(valid, est, est.new_zeros(()))
