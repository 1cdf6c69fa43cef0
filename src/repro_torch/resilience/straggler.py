"""Straggler detection and mitigation policy: the JAX package's
``resilience/straggler.py`` (host numpy, kept as the port's own copy).

Each host reports its per-step wall time; the monitor keeps an EMA and an
EMVar per host and flags hosts whose step time exceeds ``mean + k * std``
for ``patience`` consecutive steps. The training loop consults the policy
each step: flagged hosts trigger either a re-dispatch recommendation
(synchronous mode) or stale-gradient dropping (async data parallelism).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.2  # EMA coefficient
    k_sigma: float = 3.0
    patience: int = 3
    min_steps: int = 8  # warmup before flagging


class StragglerMonitor:
    def __init__(self, n_hosts: int, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.n = n_hosts
        self.ema = np.zeros(n_hosts)
        self.emvar = np.zeros(n_hosts)
        self.count = 0
        self.breach = np.zeros(n_hosts, dtype=np.int64)

    def observe(self, step_times: np.ndarray) -> List[int]:
        """step_times: (n_hosts,) seconds. Returns flagged host ids."""
        a = self.cfg.alpha
        if self.count == 0:
            self.ema = step_times.astype(float).copy()
        else:
            delta = step_times - self.ema
            self.ema += a * delta
            self.emvar = (1 - a) * (self.emvar + a * delta**2)
        self.count += 1
        if self.count < self.cfg.min_steps:
            return []
        fleet_mean = float(np.median(self.ema))
        fleet_std = float(np.sqrt(np.median(self.emvar) + 1e-12))
        slow = step_times > fleet_mean + self.cfg.k_sigma * max(fleet_std, 0.02 * fleet_mean)
        self.breach = np.where(slow, self.breach + 1, 0)
        return [int(i) for i in np.nonzero(self.breach >= self.cfg.patience)[0]]

    def fleet_step_time(self) -> float:
        return float(np.max(self.ema)) if self.count else 0.0


@dataclasses.dataclass
class MitigationPlan:
    flagged_hosts: List[int]
    action: str  # "none" | "redispatch" | "drop_stale"

    @staticmethod
    def decide(flagged: List[int], async_dp: bool) -> "MitigationPlan":
        if not flagged:
            return MitigationPlan([], "none")
        return MitigationPlan(flagged, "drop_stale" if async_dp else "redispatch")
