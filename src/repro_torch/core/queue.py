"""Multi-round work-queue scheduler (paper §V-A, §V-F, Table III), for the
PyTorch port.

Port of ``repro/core/queue.py``, scheduler logic line for line: the dense
assignment is dequeued densest-first in ``n_batches`` batches, the sparse
round is dispatched asynchronously and harvested between dense batches,
T₁/T₂ from the first round feed ρ^Model (Eq. 6) and online demotion pops
the least-populated dense queries off the queue tail.  Work only ever
moves dense → sparse, so the ρ floor is never starved.

The engines are callables (dense, sparse, brute), so tests drive the
scheduler with numpy stubs.  An ``AsyncEngineCall`` over CUDA work polls
a ``torch.cuda.Event`` recorded right after the dispatch; CPU results are
ready at once.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import splitter as split_lib


class AsyncEngineCall:
    """Handle over an in-flight engine invocation.  ``raw`` is whatever the
    engine returned (tensors, or numpy arrays for stub engines);
    ``finalize`` converts it into the scheduler-facing result tuple.
    With ``device`` a CUDA device, an event recorded on its current stream
    marks when the dispatched work is done."""

    def __init__(self, raw, finalize: Optional[Callable] = None, device=None,
                 t_dispatch: Optional[float] = None):
        self._raw = raw
        self._finalize = finalize or (lambda x: x)
        self._event = None
        if device is not None and torch.device(device).type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        # An eager engine spends host time enqueuing its kernels before it
        # returns; a caller passes the time it started so T₁ covers that.
        self.t_dispatch = time.perf_counter() if t_dispatch is None else t_dispatch
        self.elapsed: Optional[float] = None

    def ready(self) -> bool:
        """Non-blocking readiness poll."""
        return self._event is None or self._event.query()

    def get(self):
        if self._event is not None:
            self._event.synchronize()
        if self.elapsed is None:
            self.elapsed = time.perf_counter() - self.t_dispatch
        return self._finalize(self._raw)


@dataclasses.dataclass
class QueueReport:
    """Per-run accounting folded into ``JoinStats``."""

    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    t_batches: List[float] = dataclasses.field(default_factory=list)
    n_dense_batches: int = 0
    n_sparse_rounds: int = 0
    n_rebalanced: int = 0
    n_failed: int = 0
    n_uncertified: int = 0
    n_sparse_engine_total: int = 0
    t_dense: float = 0.0
    t_sparse: float = 0.0
    t_brute: float = 0.0
    t_wall: float = 0.0
    t1_per_query: float = 0.0
    t2_per_query: float = 0.0
    rho_online: float = 0.0


class WorkQueue:
    """Dense-engine work queue: head dequeue (densest home cells first),
    tail demotion (least-populated first)."""

    def __init__(self, dense_ids: Sequence[int], home_counts: Sequence[int],
                 n_batches: int = 1):
        ids = np.asarray(dense_ids, np.int32)
        if len(ids):
            counts = np.asarray(home_counts)[ids]
            order = np.argsort(-counts, kind="stable")
            ids = ids[order]
        self._ids = ids
        self._counts = (
            np.asarray(home_counts)[ids] if len(ids) else np.zeros((0,), np.int64)
        )
        self._head = 0
        self._tail = len(ids)
        self.n_batches = max(int(n_batches), 1)
        self.batch_size = -(-len(ids) // self.n_batches) if len(ids) else 0
        self.n_demoted = 0

    @property
    def remaining(self) -> int:
        return self._tail - self._head

    def next_batch(self) -> np.ndarray:
        """Dequeue up to ``batch_size`` ids from the dense (head) end."""
        take = min(self.batch_size, self.remaining)
        out = self._ids[self._head: self._head + take]
        self._head += take
        return out

    def demote(self, n: int) -> np.ndarray:
        """Pop ≤ n ids off the tail, least-populated home cells first."""
        take = min(max(int(n), 0), self.remaining)
        out = self._ids[self._tail - take: self._tail][::-1].copy()
        self._tail -= take
        self.n_demoted += take
        return out

    def peek_tail_counts(self, n: int) -> np.ndarray:
        """Home-cell populations of the next-to-demote queries (tests)."""
        take = min(max(int(n), 0), self.remaining)
        return self._counts[self._tail - take: self._tail][::-1].copy()


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    parts = [p for p in parts if len(p)]
    if not parts:
        return np.zeros((0,), np.int32)
    return np.concatenate(parts).astype(np.int32)


def run_work_queue(
    *,
    npts: int,
    k: int,
    dense_ids: np.ndarray,
    sparse_ids: np.ndarray,
    home_counts: np.ndarray,
    dense_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray, float]],
    sparse_fn: Callable[[np.ndarray], AsyncEngineCall],
    brute_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]],
    n_batches: int = 1,
    online_rebalance: bool = True,
    sync_t1_after: int = 1,
    min_sparse: int = 0,
    demote_quantum: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, QueueReport]:
    """Drive one join through the multi-round queue (see the JAX
    ``run_work_queue`` for the engine contract).  Ids are query ids and
    ``npts`` is |Q|.  Returns ``(final_d, final_i, source, report)`` with
    squared-L2 distances and ``source`` ∈ {0 dense, 1 sparse, 2 brute}."""
    dense_ids = np.asarray(dense_ids, np.int32)
    sparse_ids = np.asarray(sparse_ids, np.int32)
    if len(sparse_ids) < min_sparse:
        raise ValueError(
            f"initial sparse assignment {len(sparse_ids)} violates the "
            f"ρ floor {min_sparse} — splitter must enforce it first"
        )

    t_start = time.perf_counter()
    final_d = np.full((npts, k), np.inf, np.float32)
    final_i = np.full((npts, k), -1, np.int32)
    source = np.full((npts,), 1, np.int8)
    report = QueueReport()

    queue = WorkQueue(dense_ids, home_counts, n_batches)
    backlog: List[np.ndarray] = []
    failed: List[np.ndarray] = []
    uncertified: List[np.ndarray] = []
    inflight = None
    t1: Optional[float] = None
    t2: Optional[float] = None
    dense_ok_total = 0

    def dispatch_sparse(ids: np.ndarray, pure: bool = True) -> None:
        """``pure=False`` marks the terminal round carrying §V-E dense
        failures: it must not feed the T₁ load model."""
        nonlocal inflight
        t0 = time.perf_counter()
        inflight = (ids, sparse_fn(ids), t0, pure)
        report.n_sparse_rounds += 1
        report.n_sparse_engine_total += len(ids)

    def harvest_sparse() -> None:
        nonlocal inflight, t1
        ids, handle, t0, pure = inflight
        d, i, cert = handle.get()
        dt = handle.elapsed if handle.elapsed is not None else (
            time.perf_counter() - t0
        )
        inflight = None
        report.t_sparse += dt
        cert = np.asarray(cert, bool)
        cid = ids[cert]
        final_d[cid] = np.asarray(d)[cert]
        final_i[cid] = np.asarray(i)[cert]
        source[cid] = 1
        uncertified.append(ids[~cert])
        if len(ids) and (pure or t1 is None):
            t1 = dt / len(ids)
            report.t1_per_query = t1

    if len(sparse_ids):
        dispatch_sparse(sparse_ids)

    while queue.remaining:
        batch = queue.next_batch()
        d, i, fail, dt = dense_fn(batch)
        report.n_dense_batches += 1
        report.batch_sizes.append(int(len(batch)))
        report.t_batches.append(dt)
        report.t_dense += dt
        fail = np.asarray(fail, bool)
        ok = batch[~fail]
        final_d[ok] = np.asarray(d)[~fail]
        final_i[ok] = np.asarray(i)[~fail]
        source[ok] = 0
        failed.append(batch[fail])
        dense_ok_total += len(ok)
        if len(batch):
            t2 = dt / len(batch)

        if inflight is not None and (
            inflight[1].ready()
            or (
                sync_t1_after
                and t1 is None
                and report.n_dense_batches >= sync_t1_after
            )
        ):
            harvest_sparse()

        if (
            online_rebalance
            and t1 is not None
            and t2 is not None
            and queue.remaining
        ):
            rho_online = split_lib.rho_model(t1, t2)
            report.rho_online = rho_online
            assigned = report.n_sparse_engine_total + sum(
                len(b) for b in backlog
            )
            deficit = int(math.ceil(rho_online * npts)) - assigned
            # Slivers below one engine block aren't worth a round.
            if deficit < queue.remaining and deficit < max(demote_quantum, 1):
                deficit = 0
            if deficit > 0:
                demoted = queue.demote(deficit)
                if len(demoted):
                    backlog.append(demoted)
                    report.n_rebalanced += len(demoted)

        if inflight is None and backlog:
            dispatch_sparse(_concat(backlog))
            backlog = []

    if inflight is not None:
        harvest_sparse()

    # Terminal sparse round: leftover demotions + §V-E failure lane.
    report.n_failed = int(sum(len(f) for f in failed))
    tail_ids = _concat(backlog + failed)
    if len(tail_ids):
        dispatch_sparse(tail_ids, pure=False)
        harvest_sparse()

    # Brute backstop — exactness regardless of parameter choices.
    unc = _concat(uncertified)
    report.n_uncertified = len(unc)
    if len(unc):
        t0 = time.perf_counter()
        d, i = brute_fn(unc)
        report.t_brute = time.perf_counter() - t0
        final_d[unc] = np.asarray(d)[: len(unc)]
        final_i[unc] = np.asarray(i)[: len(unc)]
        source[unc] = 2

    if dense_ok_total:
        report.t2_per_query = report.t_dense / dense_ok_total
    report.t_wall = time.perf_counter() - t_start
    return final_d, final_i, source, report
