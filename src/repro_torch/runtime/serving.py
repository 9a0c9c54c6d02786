"""Serving-side fault policy: routing, retry, hedging, replica health —
port of ``repro/runtime/serving.py`` (a copy: numpy only).

``ShardedKNNIndex`` decomposes each query batch into one sub-query per
shard.  On a (replicas × shards) mesh every shard can be served by any
of R replica lanes, which turns each sub-query into a tiny reliability
problem with three escalating answers (DESIGN.md §7):

  hedge     — a sub-query slower than the fleet's ``mu + k·sigma``
              (tracked per lane by ``StragglerDetector``) is re-issued
              to a sibling replica; the query takes whichever copy
              finishes first.  Tail latency, not correctness.
  retry     — a sub-query that *raises* is retried on the next healthy
              replica with backoff, driven through the dormant
              ``Supervisor``'s restart loop (one sub-query == a 1-step
              supervised run whose elastic ``on_restart`` hook advances
              the replica cursor).  Repeated failures mark the replica
              unhealthy and routing stops offering it traffic.
  degrade   — when every replica has failed a shard, the shard is
              *lost* for this serve call: the merge sees (+inf, −1)
              for its block and the result carries a per-query
              ``coverage`` mask with that column False.  Never raise,
              never silently return wrong rows.

Latency bookkeeping is *effective-time* based so fault tests stay
deterministic: injected spike seconds are added to measured wall time,
and a hedged sub-query's effective latency is
``min(t_primary, threshold + t_hedge)`` — the time a concurrent hedge
would have delivered the result.  No thread races, bit-exact replay.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.stragglers import StragglerConfig, StragglerDetector
from repro_torch.runtime.supervisor import Supervisor, SupervisorConfig


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Fault policy for a replicated sharded index."""

    hedging: bool = True            # re-issue slow sub-queries
    hedge_min_factor: float = 1.5   # never hedge below factor·fleet_mu —
                                    # guards against hedge storms when the
                                    # fleet is so uniform that mu + k·sigma
                                    # sits inside timing noise
    max_attempts: int = 3           # attempts per sub-query across replicas
    backoff_seconds: float = 0.0    # retry backoff (×attempt); 0 in tests
    unhealthy_after: int = 2        # consecutive failures before a replica
                                    # is dropped from routing
    adapt_rho: bool = False         # feed suggest_rho back into the splitter
    detector: StragglerConfig = dataclasses.field(
        default_factory=StragglerConfig)

    def __post_init__(self):
        assert self.max_attempts >= 1 and self.unhealthy_after >= 1
        assert self.hedge_min_factor >= 1.0


@dataclasses.dataclass
class SubQueryOutcome:
    """What one shard sub-query came back with (or didn't)."""

    result: object = None           # whatever attempt_fn returned; None if lost
    replica: int = -1               # replica that produced ``result``
    t_effective: float = 0.0        # latency under the hedging policy
    served: bool = False            # False == shard lost (degrade path)
    hedged: bool = False
    hedge_won: bool = False
    retries: int = 0                # failed attempts that were re-issued
    failures: int = 0               # attempts that raised
    times: Dict[int, float] = dataclasses.field(default_factory=dict)
                                    # lane id -> observed effective seconds


class ServingSupervisor:
    """Per-index fault brain: owns the straggler detector, replica
    health, and the retry/hedge decision for every sub-query."""

    def __init__(self, n_replicas: int, n_shards: int,
                 cfg: Optional[ServingConfig] = None):
        self.cfg = cfg or ServingConfig()
        self.n_replicas = n_replicas
        self.n_shards = n_shards
        # one detector lane per (replica, shard) pair
        self.detector = StragglerDetector(n_replicas * n_shards,
                                          self.cfg.detector)
        self._streak = np.zeros(n_replicas, dtype=int)

    # -- lanes / routing ---------------------------------------------------

    def lane(self, replica: int, shard: int) -> int:
        return replica * self.n_shards + shard

    def replica_healthy(self, replica: int) -> bool:
        return int(self._streak[replica]) < self.cfg.unhealthy_after

    def healthy_replicas(self) -> List[int]:
        return [r for r in range(self.n_replicas) if self.replica_healthy(r)]

    def route(self, shard: int, step: int) -> List[int]:
        """Replica preference order for ``shard`` at serve step ``step``:
        healthy replicas, rotated by shard + step so concurrent shards
        (and successive steps) spread across the replica group instead
        of hammering replica 0."""
        healthy = self.healthy_replicas()
        if not healthy:
            return []
        off = (shard + step) % len(healthy)
        return healthy[off:] + healthy[:off]

    # -- hedge policy ------------------------------------------------------

    def hedge_threshold(self) -> Optional[float]:
        """Seconds beyond which a sub-query is hedged; None while the
        detector is warming up (hedging on compile noise hedges every
        cold query)."""
        t = self.detector.fleet_threshold()
        if t is None:
            return None
        fleet_mu = float(np.median(self.detector.mu))
        return max(t, self.cfg.hedge_min_factor * fleet_mu)

    # -- the sub-query reliability loop ------------------------------------

    def run_subquery(self, shard: int, step: int,
                     attempt_fn: Callable[[int], Tuple[object, float]],
                     ) -> SubQueryOutcome:
        """Serve one shard sub-query with retry + hedging.

        ``attempt_fn(replica)`` performs the actual work on that replica
        lane and returns ``(result, effective_seconds)``; it raises on
        (injected or real) failure.  Results must be replica-independent
        — replicas serve identical shard state, so any success is THE
        answer and hedging/retry never change what the query returns.
        """
        out = SubQueryOutcome()
        candidates = self.route(shard, step)
        if not candidates:
            return out                              # all replicas dead

        cursor = {"i": 0}

        def step_fn(state, _step):
            r = candidates[cursor["i"]]
            try:
                res, t = attempt_fn(r)
            except Exception:
                self._streak[r] += 1
                raise
            self._streak[r] = 0
            out.result, out.replica, out.t_effective = res, r, t
            out.served = True
            out.times[self.lane(r, shard)] = t
            return state

        # One sub-query == a 1-step supervised run: the Supervisor's
        # restart loop is the retry-with-backoff, and its elastic
        # on_restart hook advances the replica cursor (the "resize onto
        # surviving hosts" path, at sub-query granularity).
        attempts = min(self.cfg.max_attempts, len(candidates))
        sup = Supervisor(
            SupervisorConfig(max_restarts=attempts - 1,
                             max_same_step_failures=attempts - 1,
                             checkpoint_every=10**9,
                             backoff_seconds=self.cfg.backoff_seconds),
            save_fn=lambda _s, _state: None,
            restore_fn=lambda: (None, 0),
            on_restart=lambda _n: cursor.__setitem__(
                "i", min(cursor["i"] + 1, len(candidates) - 1)),
        )
        _, report = sup.run(None, step_fn, 0, 1)
        out.failures = len(report.failures)
        out.retries = max(0, out.failures - (0 if report.completed else 1))
        if not report.completed:
            return out

        # Hedge: primary succeeded but blew past the fleet threshold —
        # a concurrent re-issue to a sibling would have returned at
        # threshold + t_hedge; account the minimum of the two copies.
        thresh = self.hedge_threshold()
        if self.cfg.hedging and thresh is not None \
                and out.t_effective > thresh:
            sibling = next((r for r in candidates if r != out.replica), None)
            if sibling is not None:
                try:
                    res_h, t_h = attempt_fn(sibling)
                except Exception:
                    self._streak[sibling] += 1
                else:
                    self._streak[sibling] = 0
                    out.hedged = True
                    out.times[self.lane(sibling, shard)] = t_h
                    hedged_t = thresh + t_h
                    if hedged_t < out.t_effective:
                        out.hedge_won = True
                        out.result = res_h
                        out.t_effective = hedged_t
        return out

    # -- detector feed -----------------------------------------------------

    def observe(self, times: Dict[int, float]) -> List[int]:
        """Feed one serve step's lane observations (lane id → effective
        seconds); returns lanes flagged as persistent stragglers."""
        if not times:
            return []
        return self.detector.observed_step(times)
