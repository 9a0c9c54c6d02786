"""Straggler detection + mitigation — port of
``repro/runtime/stragglers.py`` (a copy: numpy only, no tensors).

At thousands of nodes, per-step time is gated by the slowest host; a
persistent straggler (thermal throttling, flaky ICI link, noisy
neighbor) silently costs its whole pod.  We keep an EWMA + EW-variance
of per-host step time and flag hosts exceeding ``mu + k·sigma`` for
``patience`` consecutive steps.

Mitigations surfaced to the caller:
  * for the KNN-join workload: rebalance via the paper's own lever —
    recompute ρ from the observed per-engine times (Eq. 6, reused
    *online*): a slow sparse engine shifts queries to the dense engine
    and vice versa (``suggest_rho``).
  * for LM training: flag the host for exclusion at the next elastic
    restart boundary (the supervisor owns the restart).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.2          # EWMA weight for the newest sample
    k_sigma: float = 3.0        # flag threshold
    patience: int = 3           # consecutive flags before reporting
    warmup_steps: int = 5       # ignore compile/cache warmup


class StragglerDetector:
    def __init__(self, n_hosts: int, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.n_hosts = n_hosts
        self.mu = np.zeros(n_hosts)
        self.var = np.zeros(n_hosts)
        self.count = 0
        self.flags = np.zeros(n_hosts, dtype=int)

    def update(self, step_times: np.ndarray) -> List[int]:
        """Feed per-host wall times for one step; returns hosts that have
        been flagged for >= patience consecutive steps."""
        step_times = np.asarray(step_times, dtype=float)
        assert step_times.shape == (self.n_hosts,)
        self.count += 1
        a = self.cfg.alpha
        if self.count == 1:
            self.mu = step_times.copy()
            self.var = np.zeros_like(step_times)
        else:
            delta = step_times - self.mu
            self.mu += a * delta
            self.var = (1 - a) * (self.var + a * delta * delta)
        if self.count <= self.cfg.warmup_steps:
            return []
        # a host straggles relative to the fleet, not to its own history
        fleet_mu = float(np.median(self.mu))
        fleet_sigma = float(np.sqrt(np.median(self.var)) + 1e-9)
        over = step_times > fleet_mu + self.cfg.k_sigma * fleet_sigma
        self.flags = np.where(over, self.flags + 1, 0)
        return [int(i) for i in np.nonzero(self.flags >= self.cfg.patience)[0]]

    def healthy_hosts(self) -> List[int]:
        return [i for i in range(self.n_hosts)
                if self.flags[i] < self.cfg.patience]

    # -- serving-side view (hedged sub-queries, DESIGN.md §7) -------------

    @property
    def warmed_up(self) -> bool:
        """True once enough steps have been absorbed that the fleet
        statistics are meaningful (compile/cache warmup excluded)."""
        return self.count > self.cfg.warmup_steps

    def fleet_threshold(self) -> Optional[float]:
        """The ``mu + k·sigma`` straggler cut at fleet level — the hedge
        trigger for serving sub-queries: a sub-query slower than this is
        re-issued to a sibling replica.  ``None`` during warmup (hedging
        on compile-time noise would hedge every cold query)."""
        if not self.warmed_up:
            return None
        fleet_mu = float(np.median(self.mu))
        fleet_sigma = float(np.sqrt(np.median(self.var)) + 1e-9)
        return fleet_mu + self.cfg.k_sigma * fleet_sigma

    def observed_step(self, times: Dict[int, float]) -> List[int]:
        """Partial-observation update for serving: one query batch only
        exercises a subset of the (replica × shard) lanes.  Observed
        lanes feed their measured times; unobserved lanes are filled
        with a neutral value (their own mu once seen, else the median of
        this step's observations) so their statistics neither drift nor
        poison the fleet median with zeros."""
        fill = float(np.median(list(times.values()))) if times else 0.0
        step = self.mu.copy() if self.count > 0 \
            else np.full(self.n_hosts, fill)
        for host, t in times.items():
            step[host] = t
        return self.update(step)


def suggest_rho(t1_per_query: float, t2_per_query: float) -> float:
    """The paper's Eq. 6, reused online as the straggler-rebalance lever
    for the hybrid join: rho = T2 / (T1 + T2).  Clamped to the valid
    [0, 1] split range — clock skew or subtraction noise can hand in a
    (slightly) negative per-engine time, and a ρ outside the range
    would crash the splitter rather than degrade the balance."""
    denom = t1_per_query + t2_per_query
    if denom <= 0:
        return 0.5
    return float(np.clip(t2_per_query / denom, 0.0, 1.0))


class OnlineRho:
    """Serve-time EWMA of the paper's per-engine times feeding the
    Eq. 6 re-suggestion (DESIGN.md §7): each serve step notes its
    measured T₁ (sparse) / T₂ (dense) per-query seconds, and
    ``suggestion`` returns the smoothed ρ — or None until BOTH engines
    have been observed at least ``warmup`` times, so a cold index never
    rebalances on compile noise or on one engine's time alone."""

    def __init__(self, alpha: float = 0.3, warmup: int = 1):
        assert 0.0 < alpha <= 1.0 and warmup >= 1
        self.alpha = alpha
        self.warmup = warmup
        self._t1: Optional[float] = None
        self._t2: Optional[float] = None
        self._n1 = 0
        self._n2 = 0

    def note(self, t1_per_query: float, t2_per_query: float) -> None:
        """Feed one serve step's measured per-engine times; zero means
        "engine did not run this step" and leaves its EWMA untouched."""
        a = self.alpha
        if t1_per_query > 0.0:
            self._t1 = t1_per_query if self._t1 is None else \
                (1 - a) * self._t1 + a * t1_per_query
            self._n1 += 1
        if t2_per_query > 0.0:
            self._t2 = t2_per_query if self._t2 is None else \
                (1 - a) * self._t2 + a * t2_per_query
            self._n2 += 1

    @property
    def warmed_up(self) -> bool:
        return self._n1 >= self.warmup and self._n2 >= self.warmup

    @property
    def suggestion(self) -> Optional[float]:
        """The smoothed Eq. 6 ρ in [0, 1], or None during warmup."""
        if not self.warmed_up:
            return None
        return suggest_rho(self._t1, self._t2)
