"""Overload-robust serving front-end (DESIGN.md §8) — port of
``repro/runtime/server.py`` over the port's ``KNNIndex``.

``index.query()`` is a blocking whole-batch call; production traffic is
millions of *single-query* arrivals.  ``KNNServer`` is the layer in
between — an admission queue plus a deadline-driven micro-batcher that
turns concurrent arrivals into the pow2-bucket batches the engine
bucket cache already serves compile-free:

  admission — the queue is bounded (``max_queue``); a full queue, or a
      request whose predicted queue-wait + service already exceeds its
      deadline budget, is rejected AT SUBMIT with an explicit
      ``Rejected(reason, retry_after)`` — never silent latency
      collapse.  Requests that expire while queued are cancelled the
      same way (reason ``"expired"``).

  micro-batching — pending requests with the same ``k`` coalesce FIFO
      into one batch, flushed when the bucket is full (``max_batch``),
      when the head request has waited ``max_wait``, or at the *latest
      start time* that still meets the head's deadline given the EWMA
      service estimate.  Batches ride ``index.query``'s pow2 query
      bucketing, so the zero-compile steady state holds by
      construction: a warm trace replay compiles nothing.

  degradation — pressure = (queue backlog in estimated seconds) /
      (deadline budget).  Rising pressure steps batches down a
      configured ladder of ``DegradationLevel``s — reduced hedging,
      coarser bucket rounding (bigger batches, fewer engines), then
      ``coverage``-flagged partial answers over a shard subset — with
      hysteresis so the level doesn't flap.  Shedding is the last
      resort, degradation buys throughput before it.

The core invariant: an admitted-and-served request at the full-service
level is BIT-IDENTICAL to a direct ``index.query()`` of the same batch
— the server never changes what the engines compute, only when and in
what grouping they run.  Degraded responses say so explicitly
(``Served.degraded``, ``Served.coverage``).

In the port an engine "compile" is a first-seen engine shape bucket
(``runtime/knn_index.py``), and the CUDA kernels build once per process
inside whichever call first launches them; a caller that measures
service time warms its buckets first.

All time flows through an injectable ``clock`` callable (default
``time.monotonic``).  With ``faults.VirtualClock`` plus an optional
``service_model`` (modeled seconds per batch), an entire overload
scenario — arrivals, queue waits, service, expiries — runs
deterministically with zero sleeping (``run_trace`` consumes the
``faults.open_loop_trace`` schedule).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.runtime.knn_index import validate_k, validate_points
from repro_torch.runtime.stragglers import StragglerConfig, StragglerDetector
from repro_torch.utils import pow2_bucket


@dataclasses.dataclass(frozen=True)
class DegradationLevel:
    """One rung of the pressure ladder.  ``enter_pressure`` is the
    pressure at which this rung activates; the server steps back down
    when pressure falls below ``exit_hysteresis × enter_pressure``."""

    name: str
    enter_pressure: float = 0.0
    hedging: bool = True        # allow hedged sub-query re-issue
    bucket_growth: int = 0      # pad batches to pow2 multiples of
                                # query_block << growth (coarser bucket:
                                # fewer engines, better amortization)
    shard_frac: float = 1.0     # fraction of shards served (< 1.0 =
                                # coverage-flagged partial answers)

    @property
    def degraded(self) -> bool:
        """True when responses at this rung are NOT bit-identical to a
        full-service ``index.query`` of the same request set.  Reduced
        hedging changes only latency, never bits; coarser buckets
        change the batch composition; a shard subset changes the
        answer itself (exact over the served shards)."""
        return self.bucket_growth > 0 or self.shard_frac < 1.0


#: full service → drop hedges (latency-only) → coarser buckets →
#: partial answers.  Pressure 1.0 = the queue holds one deadline-budget
#: of estimated work.
DEFAULT_LADDER: Tuple[DegradationLevel, ...] = (
    DegradationLevel("full"),
    DegradationLevel("no-hedge", enter_pressure=0.35, hedging=False),
    DegradationLevel("coarse", enter_pressure=0.6, hedging=False,
                     bucket_growth=1),
    DegradationLevel("partial", enter_pressure=0.85, hedging=False,
                     bucket_growth=1, shard_frac=0.5),
)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Admission / batching / shedding policy for ``KNNServer``."""

    deadline: float = 0.25        # default per-request budget (seconds
                                  # from arrival to response)
    max_queue: int = 1024         # admission queue bound
    max_batch: int = 256          # flush when this many coalesce
    max_wait: float = 0.02        # hard cap on head-of-line batching wait
    safety: float = 1.2           # margin on the service estimate for
                                  # shed / latest-start decisions
    shed_on_admission: bool = True  # reject provably-unmeetable deadlines
                                  # at submit (vs letting them expire)
    ladder: Tuple[DegradationLevel, ...] = DEFAULT_LADDER
    exit_hysteresis: float = 0.7  # step down below this × enter_pressure
    service_alpha: float = 0.3    # EWMA weight for the service estimate
    record_batches: bool = False  # keep per-flush BatchRecords (replay /
                                  # bit-identity audits)

    def __post_init__(self):
        assert self.deadline > 0 and self.max_wait >= 0
        assert self.max_queue >= 1 and self.max_batch >= 1
        assert self.safety >= 1.0
        assert 0.0 < self.exit_hysteresis <= 1.0
        assert self.ladder, "need at least the full-service level"
        assert self.ladder[0].enter_pressure == 0.0 \
            and not self.ladder[0].degraded and self.ladder[0].hedging, (
                "ladder[0] must be the full-service level")
        enters = [lv.enter_pressure for lv in self.ladder]
        assert enters == sorted(enters), (
            "ladder enter_pressures must be non-decreasing")


@dataclasses.dataclass
class Served:
    """A served response: one row of the batch that answered it."""

    request_id: int
    dists: np.ndarray             # (k,) ascending distances
    ids: np.ndarray               # (k,) neighbor ids
    level: int                    # ladder index the batch ran at
    level_name: str
    degraded: bool                # False ⇒ bit-identical to index.query
    coverage: Optional[np.ndarray]  # (n_shards,) bool row; None = total
    t_arrival: float
    t_queue: float                # arrival → batch flush
    t_response: float             # arrival → response (effective latency)
    batch_seq: int                # which flush served it


@dataclasses.dataclass
class Rejected:
    """A shed request: why, and when retrying could succeed."""

    request_id: int
    reason: str                   # "queue-full" | "deadline-unmeetable"
                                  # | "expired"
    retry_after: float            # seconds; 0.0 = immediately
    t_arrival: float


@dataclasses.dataclass
class Ticket:
    """Handle returned by ``submit``; ``outcome`` is filled in when the
    request is served, shed, or expires."""

    request_id: int
    outcome: Union[Served, Rejected, None] = None

    @property
    def done(self) -> bool:
        return self.outcome is not None


@dataclasses.dataclass
class BatchRecord:
    """One flush, as composed (``record_batches=True``): enough to
    replay the batch through ``index.query`` bit-for-bit."""

    seq: int
    level: int
    k: int
    request_ids: Tuple[int, ...]
    rows: np.ndarray              # (B, d) unpadded, flush order
    n_padded: int                 # rows actually sent (coarse rounding)
    serve_shards: Optional[Tuple[int, ...]]
    n_compiles: int
    t_service: float


@dataclasses.dataclass
class _Pending:
    rid: int
    row: np.ndarray
    k: int
    t_arrival: float
    deadline: float               # absolute clock time
    ticket: Ticket


class KNNServer:
    """Admission + micro-batching + shedding front-end over a
    ``KNNIndex`` (or any index with its ``query`` / ``config`` /
    ``n_dims`` / ``n_points``; the partial and no-hedge rungs also read a
    sharded index's ``n_shards`` and ``supervisor`` where it has them).

    >>> server = KNNServer(index, ServerConfig(deadline=0.2))
    >>> t = server.submit(q)                  # one (d,) query point
    >>> server.pump()                         # flush due batches
    >>> t.outcome                             # Served(...) | Rejected(...)

    Event-driven and single-threaded: ``submit`` never blocks,
    ``pump()`` resolves whatever is due at the current clock reading,
    ``next_event()`` tells a serving loop when to call again, and
    ``run_trace``/``drain`` run a whole arrival schedule.  The service
    estimate is a one-lane ``StragglerDetector`` EWMA fed only by
    compile-free batches, so cold-start compiles never poison the
    shed/flush arithmetic; until it warms, batches flush immediately
    and nothing is shed on prediction.
    """

    def __init__(
        self,
        index,
        config: Optional[ServerConfig] = None,
        *,
        clock: Optional[Callable[[], float]] = None,
        service_model: Optional[Callable[[int], float]] = None,
    ):
        self.index = index
        self.cfg = config or ServerConfig()
        self.clock = clock if clock is not None else time.monotonic
        self.service_model = service_model
        self._svc = StragglerDetector(
            1, StragglerConfig(alpha=self.cfg.service_alpha,
                               warmup_steps=0))
        self._pending: Deque[_Pending] = deque()
        self._next_rid = 0
        self._batch_seq = 0
        self.level = 0
        # -- accounting (metrics()) ---------------------------------------
        self.n_submitted = 0
        self.n_served = 0
        self.n_degraded = 0
        self.n_deadline_misses = 0
        self.n_shed: Dict[str, int] = {
            "queue-full": 0, "deadline-unmeetable": 0, "expired": 0}
        self.level_occupancy = [0] * len(self.cfg.ladder)
        self.n_batches = 0
        self.batch_sizes: List[int] = []
        self._latencies: List[float] = []
        self.batch_log: List[BatchRecord] = []

    # -- pressure / estimates ---------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    def est_service_per_row(self) -> Optional[float]:
        """EWMA seconds per padded batch row; None until the first
        compile-free batch (or ``prime_service_estimate``)."""
        if self._svc.count == 0:
            return None
        return float(self._svc.mu[0])

    def prime_service_estimate(self, per_row_s: float) -> None:
        """Seed the service EWMA (e.g. from an offline capacity
        measurement) so batching/shedding are active from the first
        request instead of after the first warm batch."""
        self._svc.update(np.array([float(per_row_s)]))

    def backlog_seconds(self) -> float:
        """Estimated seconds of queued work (0.0 while cold)."""
        est = self.est_service_per_row()
        if est is None or not self._pending:
            return 0.0
        return est * len(self._pending)

    def pressure(self) -> float:
        """Queue backlog over the deadline budget — 1.0 means the queue
        already holds one full budget of estimated work."""
        return self.backlog_seconds() / self.cfg.deadline

    # -- admission ---------------------------------------------------------

    def submit(self, query, *, k: Optional[int] = None,
               deadline: Optional[float] = None,
               arrival: Optional[float] = None) -> Ticket:
        """Admit (or shed) one single-query request.  ``query`` is one
        (d,) point; ``deadline`` is this request's budget in seconds
        from arrival (default ``cfg.deadline``).  Never blocks; returns
        a ``Ticket`` whose outcome is set now (rejections) or at flush.

        ``arrival`` (≤ the current clock reading) is the request's true
        arrival time, for callers that process a recorded schedule
        retrospectively — a single-threaded trace replay serves batches
        *between* submit calls, so by the time a request is submitted
        the clock may sit past its scheduled arrival; anchoring keeps
        queue-wait and response-latency accounting honest.  Default:
        now."""
        now = self.clock()
        arr = now if arrival is None else min(float(arrival), now)
        row = np.asarray(query, np.float32)
        if row.ndim == 2 and row.shape[0] == 1:
            row = row[0]
        validate_points(row[None], self.index.n_dims, what="query")
        kq = validate_k(self.index.config.k if k is None else k,
                        self.index.n_points)
        budget = self.cfg.deadline if deadline is None else float(deadline)
        if budget <= 0:
            raise ValueError(f"deadline must be positive seconds from "
                             f"arrival, got {budget}")
        rid = self._next_rid
        self._next_rid += 1
        self.n_submitted += 1
        ticket = Ticket(rid)

        remaining = arr + budget - now
        if remaining <= 0:
            # arrived during a service burst and its whole budget has
            # already elapsed — same contract as cancel-in-queue
            self._reject(ticket, now, "expired", 0.0)
            return ticket

        if len(self._pending) >= self.cfg.max_queue:
            est = self.est_service_per_row()
            retry = (est * min(len(self._pending), self.cfg.max_batch)
                     if est is not None else self.cfg.max_wait)
            self._reject(ticket, now, "queue-full", retry)
            return ticket

        est = self.est_service_per_row()
        if self.cfg.shed_on_admission and est is not None:
            # Provable miss: even if this request's batch started after
            # the current backlog drains, it would finish past its
            # deadline.  Shedding now costs the client one RTT instead
            # of a whole wasted budget.
            finish = (self.backlog_seconds() + est) * self.cfg.safety
            if finish > remaining:
                self._reject(ticket, now, "deadline-unmeetable",
                             max(0.0, finish - remaining))
                return ticket

        self._pending.append(_Pending(
            rid, row, kq, arr, arr + budget, ticket))
        return ticket

    def _reject(self, ticket: Ticket, now: float, reason: str,
                retry_after: float) -> None:
        ticket.outcome = Rejected(ticket.request_id, reason,
                                  float(retry_after), now)
        self.n_shed[reason] += 1

    # -- batching / flushing ----------------------------------------------

    def _select_batch(self, now: Optional[float] = None) -> List[_Pending]:
        """The next batch: FIFO over pending requests sharing the head's
        ``k`` (a static engine parameter — mixed-k batches would need
        per-row k), capped at ``max_batch`` — then trimmed to deadline
        feasibility: a batch whose own predicted service would push its
        tightest member past the wall is cut back a pow2 bucket at a
        time (a smaller batch now beats a guaranteed miss)."""
        head_k = self._pending[0].k
        sel = []
        for p in self._pending:
            if p.k == head_k:
                sel.append(p)
                if len(sel) >= self.cfg.max_batch:
                    break
        est = self.est_service_per_row()
        if est is not None and now is not None:
            qb = self._effective_block()
            while True:
                bucket = pow2_bucket(len(sel), qb)
                t_service = est * bucket * self.cfg.safety
                if bucket <= qb or \
                        now + t_service <= min(p.deadline for p in sel):
                    break
                sel = sel[: bucket // 2]
        return sel

    def _effective_block(self) -> int:
        """Pad-bucket granularity the *current* degradation level will
        serve at.  All feasibility arithmetic (batch trimming, flush
        timing, the unmeetable-in-queue floor) must use this — the
        coarse rung doubles the pad bucket, and pretending batches
        still cost the base bucket would let the server knowingly
        flush guaranteed deadline misses."""
        growth = self.cfg.ladder[self.level].bucket_growth
        return self.index.config.query_block << growth

    def _flush_time(self, batch: List[_Pending]) -> float:
        """When this batch should flush: immediately while the estimate
        is cold; else the earlier of the head's ``max_wait`` cap and
        the latest start that still meets the head's deadline."""
        est = self.est_service_per_row()
        head = batch[0]
        if est is None:
            return head.t_arrival
        qb = self._effective_block()
        t_service = est * pow2_bucket(len(batch), qb) * self.cfg.safety
        return min(head.t_arrival + self.cfg.max_wait,
                   head.deadline - t_service)

    def next_event(self) -> Optional[float]:
        """Clock time of the next scheduled action (flush or expiry);
        None when the queue is empty.  May be in the past — then
        ``pump()`` is already due."""
        if not self._pending:
            return None
        t_expire = min(p.deadline for p in self._pending)
        batch = self._select_batch(self.clock())
        return min(self._flush_time(batch), t_expire)

    def pump(self) -> int:
        """Resolve everything due at the current clock reading: cancel
        expired requests, flush due batches (which advances a virtual
        clock by the service time, possibly making more work due).
        Returns the number of requests resolved.

        The degradation level is decided HERE, at the top of each
        iteration while the full backlog is still queued — expiry
        floors, batch trimming, flush timing, and the serve itself all
        see one consistent level (deciding it mid-flush would trim the
        batch under one pad bucket and serve it under another)."""
        now = self.clock()
        resolved = 0
        while self._pending:
            self._update_level()
            resolved += self._expire(now)
            if not self._pending:
                break
            batch = self._select_batch(now)
            if len(batch) < self.cfg.max_batch \
                    and now < self._flush_time(batch):
                break
            resolved += self._flush(batch, now)
            now = self.clock()
        return resolved

    def _expire(self, now: float) -> int:
        """Cancel-in-queue: requests whose deadline has passed — or
        whose remaining budget is provably below even a lone
        minimum-bucket service (optimistic, no safety margin) — can no
        longer be served in time; shed them explicitly instead of
        burning capacity on a guaranteed miss."""
        if not self._pending:
            return 0
        est = self.est_service_per_row()
        floor = 0.0 if est is None else \
            est * pow2_bucket(1, self._effective_block())
        if min(p.deadline for p in self._pending) > now + floor:
            return 0
        keep: Deque[_Pending] = deque()
        n = 0
        for p in self._pending:
            if p.deadline <= now:
                self._reject(p.ticket, now, "expired", 0.0)
                n += 1
            elif p.deadline - now < floor:
                self._reject(p.ticket, now, "deadline-unmeetable",
                             floor - (p.deadline - now))
                n += 1
            else:
                keep.append(p)
        self._pending = keep
        return n

    def _update_level(self) -> DegradationLevel:
        ladder = self.cfg.ladder
        p = self.pressure()
        target = 0
        for i, lv in enumerate(ladder):
            if i == 0 or p >= lv.enter_pressure:
                target = i
        lvl = self.level
        if target > lvl:
            lvl = target
        else:
            while lvl > target and \
                    p < ladder[lvl].enter_pressure * self.cfg.exit_hysteresis:
                lvl -= 1
        self.level = lvl
        return ladder[lvl]

    def _flush(self, batch: List[_Pending], now: float) -> int:
        # serve at the level pump() decided for this iteration — the
        # same one the batch was trimmed and expiry-floored under
        level = self.cfg.ladder[self.level]
        taken = set(p.rid for p in batch)
        self._pending = deque(p for p in self._pending
                              if p.rid not in taken)
        lvl = self.level
        seq = self._batch_seq
        self._batch_seq += 1

        rows = np.stack([p.row for p in batch])
        n_real = len(batch)
        qb = self.index.config.query_block
        rows_in = rows
        if level.bucket_growth > 0:
            # Coarser rounding: pad (repeating the last row — answers
            # discarded) onto a coarser pow2 grid, collapsing nearby
            # batch sizes onto one engine bucket.
            target = pow2_bucket(n_real, qb << level.bucket_growth)
            if target > n_real:
                rows_in = np.concatenate(
                    [rows, np.repeat(rows[-1:], target - n_real, axis=0)])

        n_shards = getattr(self.index, "n_shards", 1)
        serve_shards = None
        if level.shard_frac < 1.0 and n_shards > 1:
            n_serve = max(1, int(np.ceil(level.shard_frac * n_shards)))
            # rotate the served subset across flushes so no shard's
            # points are systematically invisible under pressure
            start = seq % n_shards
            serve_shards = tuple(sorted(
                (start + i) % n_shards for i in range(n_serve)))

        kw = {}
        if serve_shards is not None:
            kw["_serve_shards"] = serve_shards
        sup = getattr(self.index, "supervisor", None)
        restore_cfg = None
        if sup is not None and not level.hedging and sup.cfg.hedging:
            restore_cfg = sup.cfg
            sup.cfg = dataclasses.replace(sup.cfg, hedging=False)
        try:
            # The port's query returns host numpy arrays, so it returns
            # after the card has finished: this span is the batch's
            # service time, not its enqueue.
            t0 = time.perf_counter()
            res = self.index.query(rows_in, k=batch[0].k, **kw)
            t_measured = time.perf_counter() - t0
        finally:
            if restore_cfg is not None:
                sup.cfg = restore_cfg

        t_service = (self.service_model(len(rows_in))
                     if self.service_model is not None else t_measured)
        if hasattr(self.clock, "advance"):
            self.clock.advance(t_service)
        completion = self.clock()

        n_compiles = res.stats.n_engine_compiles
        if n_compiles == 0:
            # only warm batches feed the estimate: one cold compile is
            # orders of magnitude above steady service and would poison
            # the shed/flush arithmetic for many EWMA steps
            self._svc.update(np.array([t_service / len(rows_in)]))

        cov = res.coverage
        for i, p in enumerate(batch):
            t_resp = completion - p.t_arrival
            p.ticket.outcome = Served(
                request_id=p.rid,
                dists=np.asarray(res.dists[i]),
                ids=np.asarray(res.ids[i]),
                level=lvl,
                level_name=level.name,
                degraded=level.degraded,
                coverage=None if cov is None else np.asarray(cov[i]),
                t_arrival=p.t_arrival,
                t_queue=now - p.t_arrival,
                t_response=t_resp,
                batch_seq=seq,
            )
            self.n_served += 1
            self.n_degraded += int(level.degraded)
            self.level_occupancy[lvl] += 1
            self._latencies.append(t_resp)
            self.n_deadline_misses += int(completion > p.deadline)
        self.n_batches += 1
        self.batch_sizes.append(n_real)
        if self.cfg.record_batches:
            self.batch_log.append(BatchRecord(
                seq=seq, level=lvl, k=batch[0].k,
                request_ids=tuple(p.rid for p in batch),
                rows=rows, n_padded=len(rows_in),
                serve_shards=serve_shards, n_compiles=n_compiles,
                t_service=t_service,
            ))
        return n_real

    # -- trace runners -----------------------------------------------------

    def _advance_to(self, t: float) -> None:
        if hasattr(self.clock, "advance_to"):
            self.clock.advance_to(t)
        else:
            dt = t - self.clock()
            if dt > 0:
                time.sleep(dt)

    def _run_until(self, t_stop: Optional[float]) -> None:
        """Serve events strictly before ``t_stop`` (None = until the
        queue is empty), advancing the clock to each."""
        while self._pending:
            nxt = self.next_event()
            if nxt is None or (t_stop is not None and nxt >= t_stop):
                return
            self._advance_to(nxt)
            if self.pump() == 0:
                raise RuntimeError(
                    f"server made no progress at t={self.clock():.6f} "
                    f"(next_event={nxt:.6f}, depth={self.queue_depth})")

    def run_trace(self, arrivals) -> List[Ticket]:
        """Drive a whole open-loop arrival schedule
        (``faults.open_loop_trace``): for each arrival, serve everything
        due first, advance the clock to the arrival, submit, and flush
        anything bucket-full; then drain the queue.  With a
        ``VirtualClock`` this is fully deterministic and sleep-free."""
        sched = sorted(arrivals, key=lambda a: a.t)
        tickets = []
        i = 0
        while i < len(sched):
            self._run_until(sched[i].t)
            self._advance_to(sched[i].t)
            # Scoop EVERY arrival due by the current clock reading in
            # one go: a service burst advances the clock past many
            # scheduled arrivals, and they must enter the queue
            # together (as they would while a real server was busy)
            # before the flush decision runs — one at a time, each
            # already-overdue head would flush as a singleton.
            now = self.clock()
            while i < len(sched) and sched[i].t <= now:
                a = sched[i]
                tickets.append(self.submit(a.query, k=a.k,
                                           deadline=a.deadline,
                                           arrival=a.t))
                i += 1
            self.pump()
        self.drain()
        return tickets

    def drain(self) -> None:
        """Serve the queue to empty (advancing the clock as needed)."""
        self._run_until(None)

    # -- reporting ---------------------------------------------------------

    def metrics(self) -> Dict[str, object]:
        """Counters + the latency tail, the BENCH-facing view: served /
        shed-by-reason, per-level occupancy, P50/P95/P99 effective
        (arrival → response) latency, deadline misses, live pressure."""
        lat = np.asarray(self._latencies, float)
        pct = (lambda p: float(np.percentile(lat, p))) if len(lat) \
            else (lambda p: 0.0)
        n_shed = sum(self.n_shed.values())
        return {
            "n_submitted": self.n_submitted,
            "n_served": self.n_served,
            "n_shed": dict(self.n_shed),
            "n_shed_total": n_shed,
            "shed_rate": n_shed / max(1, self.n_submitted),
            "n_degraded": self.n_degraded,
            "n_deadline_misses": self.n_deadline_misses,
            "n_batches": self.n_batches,
            "mean_batch_rows": (float(np.mean(self.batch_sizes))
                                if self.batch_sizes else 0.0),
            "level_occupancy": {
                lv.name: self.level_occupancy[i]
                for i, lv in enumerate(self.cfg.ladder)},
            "level": self.level,
            "pressure": self.pressure(),
            "queue_depth": self.queue_depth,
            "p50_response_s": pct(50),
            "p95_response_s": pct(95),
            "p99_response_s": pct(99),
            "max_response_s": float(lat.max()) if len(lat) else 0.0,
        }
