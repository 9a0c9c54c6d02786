"""Fault-tolerant step supervisor: checkpoint/restart with elastic resume —
port of ``repro/runtime/supervisor.py`` (a copy).

``Supervisor.run`` drives a train loop through transient failures:

    host crash / device loss          -> restore last durable checkpoint,
                                         rebuild state, continue
    repeated failure at the same step -> back off, then give up loudly
    straggler flagged                 -> downsize to healthy hosts at the
                                         next restart (elastic path: the
                                         checkpoint re-shards onto the
                                         surviving mesh via
                                         CheckpointManager.restore)

The loop body is a callable ``(state, step) -> state`` supplied by the
trainer; fault injection in tests exercises every path.  This component
is deliberately framework-free: it supervises *any* steppable state.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class SupervisorConfig:
    max_restarts: int = 5
    max_same_step_failures: int = 3
    checkpoint_every: int = 50
    backoff_seconds: float = 0.0       # kept 0 in tests


@dataclasses.dataclass
class RunReport:
    final_step: int
    restarts: int
    failures: list
    completed: bool


class Supervisor:
    def __init__(self, cfg: SupervisorConfig, *,
                 save_fn: Callable[[int, Any], None],
                 restore_fn: Callable[[], tuple],
                 on_restart: Optional[Callable[[int], None]] = None):
        """save_fn(step, state); restore_fn() -> (state, step) from the
        latest durable checkpoint; on_restart(restart_idx) lets the caller
        resize the mesh / rebuild compiled fns (elastic hook)."""
        self.cfg = cfg
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.on_restart = on_restart

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            start_step: int, total_steps: int) -> tuple[Any, RunReport]:
        restarts = 0
        failures: list = []
        step = start_step
        same_step_fail = 0
        while step < total_steps:
            try:
                state = step_fn(state, step)
                step += 1
                same_step_fail = 0
                if step % self.cfg.checkpoint_every == 0 or step == total_steps:
                    self.save_fn(step, state)
            except Exception as e:   # noqa: BLE001 — supervisor boundary
                failures.append((step, repr(e)))
                same_step_fail += 1
                restarts += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, restarts, self.cfg.max_restarts)
                if restarts > self.cfg.max_restarts or \
                        same_step_fail > self.cfg.max_same_step_failures:
                    return state, RunReport(step, restarts, failures, False)
                if self.cfg.backoff_seconds:
                    time.sleep(self.cfg.backoff_seconds * restarts)
                if self.on_restart is not None:
                    self.on_restart(restarts)
                state, step = self.restore_fn()
        return state, RunReport(step, restarts, failures, True)
