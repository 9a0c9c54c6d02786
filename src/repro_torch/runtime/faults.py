"""Deterministic fault injection for the serving layer (DESIGN.md §7) —
port of ``repro/runtime/faults.py``.

Production failure modes — stragglers, flaky replicas, lost shards,
crashes mid-checkpoint — are rare and timing-dependent; a serving stack
whose recovery paths only run in production is untested by definition.
This module makes every one of them a *scripted, repeatable* event:

  * ``FaultInjector`` is the hook surface ``ShardedKNNIndex`` consults
    before each sub-query (and ``CrashingCheckpointManager`` consults
    mid-write).  The default implementation injects nothing, so the
    healthy path carries one cheap virtual call and no behavior change.

  * ``ScriptedFaults`` scripts faults by (replica, shard, step):
    latency spikes (returned as *synthetic* extra seconds — no real
    sleeping, so fault tests stay fast and exactly reproducible),
    sub-query exceptions, and replica kills from a given step on.

  * ``CrashingCheckpointManager`` crashes the durable-write path at the
    phase hooks of ``CheckpointManager._write`` — before anything is
    written, after the arrays but before the manifest, and after the
    atomic rename but before the ``LATEST`` pointer moves — the three
    distinct partial states a real crash can leave on disk.  The write
    itself is the manager's own, so the on-disk format is unchanged.

Latency injection is *additive and virtual*: the injector returns extra
seconds that the serving layer adds to the measured sub-query wall time
before feeding the straggler detector and the hedging policy.  The
observable behavior (hedge decisions, effective latency accounting,
detector state) is exactly what a real spike of that size produces,
without tests paying the wall-clock cost.

The same virtual-time principle extends to *load*: ``VirtualClock`` is
an injectable monotonic clock the overload serving layer
(``runtime.server.KNNServer``) reads instead of ``time.monotonic``, and
``open_loop_trace`` turns a query set + target QPS into a deterministic
open-loop ``Arrival`` schedule.  Overload tests advance the clock
explicitly (arrival times, modeled service durations) — no sleeping,
no wall-clock races, bit-exact replay of an entire overload scenario.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import CheckpointManager


class VirtualClock:
    """A monotonic clock under test control (seconds, starts at ``t0``).

    Drop-in for ``time.monotonic`` wherever a clock *callable* is
    injected: ``clock()`` reads the current virtual time; the caller
    moves it forward with ``advance``/``advance_to``.  Time never goes
    backwards — ``advance`` rejects negative deltas and ``advance_to``
    clamps to the current reading — so consumers keep the monotonic
    contract real clocks give them.
    """

    def __init__(self, t0: float = 0.0):
        self._now = float(t0)

    def __call__(self) -> float:
        return self._now

    @property
    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError(f"cannot advance a monotonic clock by "
                             f"{seconds}s (negative)")
        self._now += float(seconds)
        return self._now

    def advance_to(self, t: float) -> float:
        self._now = max(self._now, float(t))
        return self._now


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled single-query request of an overload trace."""

    t: float                          # arrival time (clock seconds)
    query: object                     # one (n_dims,) point
    k: Optional[int] = None           # per-request k override
    deadline: Optional[float] = None  # seconds from arrival; None = default


def open_loop_trace(queries, qps: float, *, t0: float = 0.0,
                    seed: Optional[int] = None, k: Optional[int] = None,
                    deadline: Optional[float] = None) -> List[Arrival]:
    """Schedule one ``Arrival`` per query row at a target offered load.

    Open-loop means arrivals do NOT wait for responses — the generator
    keeps offering ``qps`` regardless of how the server is doing, which
    is what makes overload visible at all (a closed loop self-throttles
    to capacity).  ``seed=None`` spaces arrivals uniformly at 1/qps
    (fully deterministic); an int seed draws exponential gaps (Poisson
    arrivals) from a fixed rng, deterministic per seed.
    """
    q = np.asarray(queries, np.float32)
    if q.ndim != 2 or len(q) == 0:
        raise ValueError(f"queries must be a non-empty (rows, dims) "
                         f"array, got shape {q.shape}")
    if not qps > 0:
        raise ValueError(f"qps must be positive, got {qps}")
    if seed is None:
        gaps = np.full(len(q), 1.0 / qps)
    else:
        gaps = np.random.default_rng(seed).exponential(1.0 / qps, len(q))
    times = float(t0) + np.cumsum(gaps) - gaps[0]
    return [Arrival(t=float(t), query=q[i], k=k, deadline=deadline)
            for i, t in enumerate(times)]


class SubQueryFault(RuntimeError):
    """An injected (or real) sub-query failure the supervisor retries."""


class CheckpointCrash(RuntimeError):
    """An injected crash inside the checkpoint write path."""


class FaultInjector:
    """No-op base: the healthy serving path.  Subclass (or use
    ``ScriptedFaults``) to inject."""

    def subquery(self, replica: int, shard: int, step: int) -> float:
        """Called before the (replica, shard) sub-query of serve step
        ``step``.  Return extra synthetic latency in seconds (0.0 =
        healthy); raise ``SubQueryFault`` to fail the attempt."""
        return 0.0

    def checkpoint_phase(self, phase: str, step: int) -> None:
        """Called by ``CrashingCheckpointManager`` at each write phase
        (``"pre-arrays"``, ``"pre-manifest"``, ``"pre-latest"``).
        Raise ``CheckpointCrash`` to crash there."""


@dataclasses.dataclass
class _Kill:
    at_step: int


class ScriptedFaults(FaultInjector):
    """Deterministic fault script keyed on (replica, shard, step).

    >>> f = ScriptedFaults()
    >>> f.add_latency(0, 1, 0.25, steps=range(4, 100, 4))
    >>> f.fail_subquery(1, 0, steps=[6, 7])
    >>> f.kill_replica(1, at_step=10)          # every later sub-query fails
    >>> f.crash_checkpoint("pre-manifest")     # next ckpt write crashes

    ``log`` records every injected event as (kind, replica, shard, step)
    so tests can assert exactly which faults fired.
    """

    def __init__(self):
        self._latency: Dict[Tuple[int, int, int], float] = {}
        self._fail: set = set()
        self._kills: Dict[int, _Kill] = {}
        self._ckpt_crash: Optional[str] = None
        self.log: List[Tuple[str, int, int, int]] = []

    # -- scripting ---------------------------------------------------------

    def add_latency(self, replica: int, shard: int, seconds: float,
                    steps) -> "ScriptedFaults":
        for s in steps:
            self._latency[(replica, shard, int(s))] = float(seconds)
        return self

    def fail_subquery(self, replica: int, shard: int,
                      steps) -> "ScriptedFaults":
        for s in steps:
            self._fail.add((replica, shard, int(s)))
        return self

    def kill_replica(self, replica: int, at_step: int) -> "ScriptedFaults":
        self._kills[replica] = _Kill(int(at_step))
        return self

    def crash_checkpoint(self, phase: str) -> "ScriptedFaults":
        assert phase in ("pre-arrays", "pre-manifest", "pre-latest"), phase
        self._ckpt_crash = phase
        return self

    # -- injection hooks ---------------------------------------------------

    def subquery(self, replica: int, shard: int, step: int) -> float:
        kill = self._kills.get(replica)
        if kill is not None and step >= kill.at_step:
            self.log.append(("kill", replica, shard, step))
            raise SubQueryFault(
                f"replica {replica} killed at step {kill.at_step} "
                f"(sub-query shard={shard} step={step})"
            )
        if (replica, shard, step) in self._fail:
            self.log.append(("fail", replica, shard, step))
            raise SubQueryFault(
                f"injected sub-query failure replica={replica} "
                f"shard={shard} step={step}"
            )
        extra = self._latency.get((replica, shard, step), 0.0)
        if extra:
            self.log.append(("latency", replica, shard, step))
        return extra

    def checkpoint_phase(self, phase: str, step: int) -> None:
        if self._ckpt_crash == phase:
            self._ckpt_crash = None          # crash once, then recover
            self.log.append(("ckpt-crash", -1, -1, step))
            raise CheckpointCrash(f"injected crash at {phase} of step {step}")

    # -- introspection -----------------------------------------------------

    def count(self, kind: str) -> int:
        return sum(1 for k, *_ in self.log if k == kind)


class CrashingCheckpointManager(CheckpointManager):
    """A ``CheckpointManager`` whose write path consults a
    ``FaultInjector`` at each phase — the crash-mid-checkpoint harness.
    Always synchronous (a crash on the background thread would be
    swallowed by the Future until the next ``wait()``)."""

    def __init__(self, directory: str, injector: FaultInjector, *,
                 keep: int = 3):
        super().__init__(directory, keep=keep, async_save=False)
        self.injector = injector

    def _phase(self, name: str, step: int) -> None:
        self.injector.checkpoint_phase(name, step)
