"""The port's overload-robust serving front end (DESIGN.md §8) against the
JAX package: every single-device case of ``tests/test_overload_server.py``
run on ``repro_torch.runtime.KNNServer`` over the port's ``KNNIndex`` on
the CPU — admission bounds, deadline micro-batching, provable-miss
shedding, cancel-in-queue expiry, the degradation ladder with
hysteresis, exact shed / occupancy accounting at 2x capacity,
bit-identical served responses, the zero-bucket warm trace replay.  The
sharded partial-rung case (``test_sharded_partial_rung_flags_coverage``)
is in ``test_torch_fault_mesh.py``.

Parity: the same ``open_loop_trace`` rows and seed go through each
package's ``KNNServer`` and ``VirtualClock`` with the same linear
service model and a primed estimate, over indexes built with ε pinned
and ``backend="ref"``.  Ticket outcome kinds, reject reasons, levels,
batch numbers and the ``metrics()`` counters are equal; ``retry_after``,
``t_queue``, ``t_response`` and the latency fields of ``metrics()`` agree
within 1e-9 s (the service EWMA is fed only by batches that add no
engine bucket, and the packages count buckets in different code); ids
are equal except where float64 distances tie within 1e-5, distances
agree within 1e-5.  ``open_loop_trace`` gives bit-identical times."""
import numpy as np
import pytest
import torch

import repro.core as jax_core
import repro.runtime as jax_rt
import repro_torch.runtime as torch_rt
from conftest import make_mixture
from repro_torch.core import HybridConfig
from repro_torch.runtime import (
    Arrival, DegradationLevel, KNNIndex, KNNServer, Rejected, Served,
    ServerConfig, VirtualClock, open_loop_trace,
)

PER_ROW = 1e-3                    # deterministic service model: seconds/row
DIM = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    under the suite's parallel workers torch's default thread pool only
    contends with them (a 300-row trace ran over 20 times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(k=3, m=4, n_batches=1, backend="ref", online_rebalance=False)


@pytest.fixture(scope="module")
def db():
    return make_mixture(300, 120, dim=DIM, seed=0)


@pytest.fixture(scope="module")
def index(db):
    return KNNIndex.build(db, HybridConfig(**CFG), device="cpu")


def _server(index, *, prime=True, **over):
    clock = VirtualClock()
    kw = dict(deadline=0.2, max_wait=0.02)
    kw.update(over)
    srv = KNNServer(index, ServerConfig(**kw), clock=clock,
                    service_model=lambda n: PER_ROW * n)
    if prime:
        srv.prime_service_estimate(PER_ROW)
    return srv, clock


def _queries(n, seed=1):
    r = np.random.default_rng(seed)
    return r.normal(size=(n, DIM)).astype(np.float32)


# ---------------------------------------------------------------------------
# admission: validation and shedding
# ---------------------------------------------------------------------------

def test_submit_validates_query_k_and_deadline(index):
    srv, _ = _server(index)
    q = _queries(1)[0]
    with pytest.raises(ValueError, match="dims"):
        srv.submit(np.zeros(DIM + 1, np.float32))
    with pytest.raises(ValueError, match=">= 1"):
        srv.submit(q, k=0)
    with pytest.raises(ValueError, match="exceeds"):
        srv.submit(q, k=index.n_points + 1)
    with pytest.raises(ValueError, match="deadline"):
        srv.submit(q, deadline=0.0)
    with pytest.raises(ValueError, match="deadline"):
        srv.submit(q, deadline=-1.0)
    # validation failures never count as submitted or shed
    assert srv.n_submitted == 0 and sum(srv.n_shed.values()) == 0
    # a (1, d) row is accepted as a single query
    t = srv.submit(q[None])
    assert not t.done and srv.queue_depth == 1


def test_queue_full_sheds_with_retry_hint(index):
    srv, _ = _server(index, max_queue=4, shed_on_admission=False,
                     deadline=10.0)
    tickets = [srv.submit(q) for q in _queries(6)]
    assert [t.done for t in tickets] == [False] * 4 + [True] * 2
    for t in tickets[4:]:
        assert isinstance(t.outcome, Rejected)
        assert t.outcome.reason == "queue-full"
        assert t.outcome.retry_after > 0.0
    assert srv.n_shed["queue-full"] == 2 and srv.n_submitted == 6


def test_admission_sheds_provably_unmeetable_deadline(index):
    """With a warm service estimate, a request whose deadline cannot be
    met even if its batch started after the backlog drains is rejected
    at submit — one cheap RTT instead of a wasted budget."""
    srv, _ = _server(index, deadline=0.05, max_queue=10 ** 6)
    tickets = [srv.submit(q) for q in _queries(200)]
    shed = [t for t in tickets if t.done]
    kept = [t for t in tickets if not t.done]
    assert shed and kept, "expected a mix of admitted and shed"
    # FIFO backlog: everything after the first rejection is rejected too
    first = min(t.request_id for t in shed)
    assert all(t.request_id >= first for t in shed)
    for t in shed:
        assert t.outcome.reason == "deadline-unmeetable"
        assert t.outcome.retry_after > 0.0
    # admitted backlog stays within what the deadline can absorb (the
    # last admit saw backlog = now - its own row, plus its row)
    assert srv.backlog_seconds() * srv.cfg.safety <= 0.05 + 1e-9


def test_expired_rejections(index):
    srv, clock = _server(index, prime=False, shed_on_admission=False)
    q = _queries(1)[0]
    # anchored arrival whose whole budget elapsed during a service
    # burst: rejected as expired at submit
    clock.advance(1.0)
    t_old = srv.submit(q, deadline=0.5, arrival=0.0)
    assert t_old.outcome.reason == "expired"
    # cancel-in-queue: admitted with a cold estimate, then the clock
    # passes the deadline before any flush
    t_q = srv.submit(q, deadline=0.05)
    clock.advance(0.1)
    srv.pump()
    assert t_q.outcome.reason == "expired"
    assert srv.n_shed["expired"] == 2


def test_cancel_in_queue_when_even_min_bucket_cannot_fit(index):
    """Queued requests whose remaining budget is below one lone
    min-bucket service are provably dead — pump sheds them instead of
    burning a flush on guaranteed misses."""
    srv, _ = _server(index, deadline=0.05, shed_on_admission=False,
                     max_queue=10 ** 6)
    tickets = [srv.submit(q) for q in _queries(50)]
    assert srv.queue_depth == 50
    srv.pump()   # floor = PER_ROW * 128 = 0.128s > every 0.05s budget
    assert srv.queue_depth == 0
    for t in tickets:
        assert t.outcome.reason == "deadline-unmeetable"
    assert srv.n_served == 0 and srv.n_deadline_misses == 0


# ---------------------------------------------------------------------------
# deadline micro-batching
# ---------------------------------------------------------------------------

def test_single_queries_coalesce_and_flush_on_wait_deadline(index):
    srv, clock = _server(index, max_wait=0.02)
    tickets = [srv.submit(q) for q in _queries(5)]
    srv.pump()
    assert all(not t.done for t in tickets), "flushed before max_wait"
    assert srv.next_event() == pytest.approx(0.02)
    clock.advance_to(srv.next_event())
    srv.pump()
    m = srv.metrics()
    assert m["n_batches"] == 1 and m["mean_batch_rows"] == 5.0
    for t in tickets:
        out = t.outcome
        assert isinstance(out, Served) and not out.degraded
        assert out.t_queue == pytest.approx(0.02)
        assert out.t_response == pytest.approx(0.02 + 5 * PER_ROW)
        assert out.coverage is None
    assert srv.n_deadline_misses == 0


def test_full_bucket_flushes_without_waiting(index):
    srv, _ = _server(index, max_batch=8, max_wait=10.0, deadline=20.0)
    tickets = [srv.submit(q) for q in _queries(8)]
    srv.pump()   # bucket full at t=0: no wait
    assert all(t.done for t in tickets)
    assert {t.outcome.batch_seq for t in tickets} == {0}
    assert all(t.outcome.t_queue == 0.0 for t in tickets)


def test_mixed_k_requests_batch_separately(index):
    """k is a static engine parameter: one flush serves one k."""
    srv, clock = _server(index, max_wait=0.01, deadline=10.0)
    qs = _queries(6)
    tickets = [srv.submit(q, k=(3 if i % 2 == 0 else 2))
               for i, q in enumerate(qs)]
    clock.advance(0.02)
    srv.pump()
    srv.drain()
    assert srv.metrics()["n_batches"] == 2
    for i, t in enumerate(tickets):
        want_k = 3 if i % 2 == 0 else 2
        assert t.outcome.dists.shape == (want_k,)
        assert t.outcome.ids.shape == (want_k,)


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

_LADDER = (
    DegradationLevel("full"),
    DegradationLevel("no-hedge", enter_pressure=0.3, hedging=False),
    DegradationLevel("coarse", enter_pressure=0.6, hedging=False,
                     bucket_growth=1),
)


def test_ladder_steps_up_under_pressure_and_down_with_hysteresis(index):
    srv, clock = _server(index, ladder=_LADDER, deadline=0.4,
                         max_wait=0.0, shed_on_admission=False,
                         max_queue=10 ** 6)
    # burst deep enough for pressure 250 * PER_ROW / 0.4 = 0.625 >= 0.6
    burst = [srv.submit(q) for q in _queries(250)]
    assert srv.pressure() == pytest.approx(0.625)
    srv.pump()
    served_at = {t.outcome.level_name for t in burst if t.done}
    assert "coarse" in served_at
    coarse = [t for t in burst if t.done and t.outcome.level_name == "coarse"]
    assert all(t.outcome.degraded for t in coarse)
    srv.drain()
    # hysteresis: pressure between exit (0.42) and enter (0.6) holds the
    # level; only below enter * exit_hysteresis does it step down
    srv.level = 2
    mid = [srv.submit(q) for q in _queries(200)]    # pressure 0.5
    srv._update_level()
    assert srv.level == 2, "stepped down above the hysteresis exit"
    srv.drain()
    assert all(t.done for t in mid)
    # empty queue: pressure 0 walks the ladder back to full service
    srv._update_level()
    assert srv.level == 0
    m = srv.metrics()
    assert m["n_degraded"] == sum(
        c for name, c in m["level_occupancy"].items() if name == "coarse")


def test_no_hedge_rung_is_not_degraded(index):
    """Disabling hedging changes latency policy, not result bits — the
    no-hedge rung must not be flagged degraded."""
    assert not DegradationLevel("no-hedge", 0.3, hedging=False).degraded
    assert DegradationLevel("c", 0.3, bucket_growth=1).degraded
    assert DegradationLevel("p", 0.3, shard_frac=0.5).degraded


# ---------------------------------------------------------------------------
# the acceptance drill: 2x overload, exact accounting, bit identity
# ---------------------------------------------------------------------------

def test_overload_2x_keeps_served_p99_within_deadline(index):
    """Offered load >= 2x capacity: the server keeps every served
    request within deadline by shedding/degrading, and its accounting
    (shed by reason, per-level occupancy) matches the tickets exactly."""
    deadline = 0.2
    srv, clock = _server(index, deadline=deadline, record_batches=True)
    qps = 2.0 / PER_ROW                       # 2x modeled capacity
    trace = open_loop_trace(_queries(800), qps=qps, seed=7)
    tickets = srv.run_trace(trace)
    m = srv.metrics()

    assert m["n_submitted"] == 800
    assert m["n_served"] + m["n_shed_total"] == 800
    assert m["n_shed_total"] > 0, "2x load must shed"
    assert m["n_deadline_misses"] == 0
    lat = [t.outcome.t_response for t in tickets
           if isinstance(t.outcome, Served)]
    assert np.percentile(lat, 99) <= deadline + 1e-9
    assert max(lat) <= deadline + 1e-9

    # accounting is exact: recount everything from the tickets
    shed_by_reason = {}
    occupancy = {}
    for t in tickets:
        assert t.done
        if isinstance(t.outcome, Rejected):
            shed_by_reason[t.outcome.reason] = \
                shed_by_reason.get(t.outcome.reason, 0) + 1
        else:
            occupancy[t.outcome.level_name] = \
                occupancy.get(t.outcome.level_name, 0) + 1
    assert {r: c for r, c in m["n_shed"].items() if c} == shed_by_reason
    assert {n: c for n, c in m["level_occupancy"].items() if c} == occupancy
    assert sum(m["level_occupancy"].values()) == m["n_served"]


def test_served_responses_bit_identical_to_direct_query(index):
    """Every request served at a non-degraded rung returns bits
    identical to a direct ``index.query`` of the same batch at the same
    settings — the micro-batcher adds latency policy, never answers."""
    srv, clock = _server(index, record_batches=True)
    trace = open_loop_trace(_queries(300), qps=1.0 / PER_ROW, seed=3)
    tickets = srv.run_trace(trace)
    by_rid = {t.request_id: t for t in tickets}
    audited = 0
    for rec in srv.batch_log:
        if srv.cfg.ladder[rec.level].degraded:
            continue
        direct = index.query(rec.rows, k=rec.k)
        for j, rid in enumerate(rec.request_ids):
            out = by_rid[rid].outcome
            np.testing.assert_array_equal(out.dists, direct.dists[j])
            np.testing.assert_array_equal(out.ids, direct.ids[j])
            audited += 1
    assert audited == srv.n_served > 0


def test_warm_trace_replay_compiles_zero_engines(index):
    """Replaying the same arrival trace against a warm index must reuse
    every compiled engine — the serving-path zero-compile invariant
    extended through the micro-batcher."""
    trace = open_loop_trace(_queries(300), qps=1.0 / PER_ROW, seed=5)
    srv1, _ = _server(index)
    srv1.run_trace(trace)                    # may pay residual compiles
    before = index.total_compiles
    srv2, _ = _server(index)
    tickets = srv2.run_trace(trace)
    assert index.total_compiles == before
    assert srv2.n_served == sum(1 for t in tickets
                                if isinstance(t.outcome, Served)) > 0


def test_open_loop_trace_shapes_and_determinism():
    q = _queries(16)
    uniform = open_loop_trace(q, qps=100.0)
    assert len(uniform) == 16 and uniform[0].t == 0.0
    gaps = np.diff([a.t for a in uniform])
    np.testing.assert_allclose(gaps, 0.01, atol=1e-12)
    a = open_loop_trace(q, qps=100.0, seed=3)
    b = open_loop_trace(q, qps=100.0, seed=3)
    assert [x.t for x in a] == [x.t for x in b]
    assert isinstance(a[0], Arrival)
    with pytest.raises(ValueError):
        open_loop_trace(q, qps=0.0)


def test_run_trace_makes_progress_under_service_bursts(index):
    """A service burst can advance the virtual clock past many
    scheduled arrivals; they must still be admitted (anchored at their
    scheduled time) and every ticket resolved."""
    srv, clock = _server(index, deadline=0.3)
    # arrivals spaced tighter than one batch's service
    trace = open_loop_trace(_queries(400), qps=4.0 / PER_ROW, seed=9)
    tickets = srv.run_trace(trace)
    assert all(t.done for t in tickets)
    for t, a in zip(tickets, sorted(trace, key=lambda a: a.t)):
        if isinstance(t.outcome, Served):
            assert t.outcome.t_arrival == pytest.approx(a.t)


# ---------------------------------------------------------------------------
# parity with the JAX package's server
# ---------------------------------------------------------------------------

TIME_TOL = 1e-9
DIST_TOL = 1e-5
LAT_FIELDS = ("pressure", "p50_response_s", "p95_response_s", "p99_response_s",
              "max_response_s")


def _run(pkg, idx, rows, qps, seed, **over):
    kw = dict(deadline=0.2, max_wait=0.02, record_batches=True)
    kw.update(over)
    srv = pkg.KNNServer(idx, pkg.ServerConfig(**kw), clock=pkg.VirtualClock(),
                        service_model=lambda n: PER_ROW * n)
    srv.prime_service_estimate(PER_ROW)
    return srv, srv.run_trace(pkg.open_loop_trace(rows, qps=qps, seed=seed))


def _same_outcomes(tickets_t, tickets_j, rows, db):
    assert len(tickets_t) == len(tickets_j)
    served = 0
    for t, j in zip(tickets_t, tickets_j):
        a, b = t.outcome, j.outcome
        assert t.request_id == j.request_id
        assert type(a).__name__ == type(b).__name__
        assert a.t_arrival == pytest.approx(b.t_arrival, abs=TIME_TOL)
        if isinstance(a, Rejected):
            assert a.reason == b.reason
            assert a.retry_after == pytest.approx(b.retry_after, abs=TIME_TOL)
            continue
        served += 1
        assert (a.level, a.level_name, a.degraded, a.batch_seq) == \
            (b.level, b.level_name, b.degraded, b.batch_seq)
        assert a.coverage is None and b.coverage is None
        assert a.t_queue == pytest.approx(b.t_queue, abs=TIME_TOL)
        assert a.t_response == pytest.approx(b.t_response, abs=TIME_TOL)
        np.testing.assert_allclose(a.dists, np.asarray(b.dists), rtol=DIST_TOL,
                                   atol=DIST_TOL)
        bi = np.asarray(b.ids)
        diff = np.nonzero(a.ids != bi)[0]
        if len(diff):
            q = np.asarray(rows[t.request_id], np.float64)
            full = np.asarray(db, np.float64)
            np.testing.assert_allclose(np.linalg.norm(full[a.ids[diff]] - q, axis=-1),
                                       np.linalg.norm(full[bi[diff]] - q, axis=-1),
                                       rtol=DIST_TOL, atol=DIST_TOL)
    return served


def _same_metrics(mt, mj):
    for key in mj:
        if key in LAT_FIELDS:
            assert mt[key] == pytest.approx(mj[key], abs=TIME_TOL), key
        else:
            assert mt[key] == mj[key], key


@pytest.fixture(scope="module")
def pinned_pair(db, index):
    """Both packages' indexes over the same points with the same ε."""
    eps = float(index.eps)
    jax_idx = jax_rt.KNNIndex.build(db, jax_core.HybridConfig(**CFG), eps)
    return KNNIndex.build(db, HybridConfig(**CFG), eps, device="cpu"), jax_idx


@pytest.mark.parametrize("load,seed,n", [(1.0, 3, 120), (2.0, 7, 500)])
def test_server_trace_matches_jax(db, pinned_pair, load, seed, n):
    """A whole open-loop trace at 1x and 2x modelled capacity: every
    ticket resolves the same way in both packages, the batches are
    composed the same, and the counters agree.  At 2x the trace sheds on
    admission and serves at the full and no-hedge rungs.  (The traces are
    short: each new engine bucket costs the JAX package an XLA compile.)"""
    t_idx, j_idx = pinned_pair
    rows = _queries(n, seed=seed + 100)
    srv_t, tickets_t = _run(torch_rt, t_idx, rows, load / PER_ROW, seed)
    srv_j, tickets_j = _run(jax_rt, j_idx, rows, load / PER_ROW, seed)
    served = _same_outcomes(tickets_t, tickets_j, rows, db)
    _same_metrics(srv_t.metrics(), srv_j.metrics())
    assert [(b.seq, b.level, b.k, b.request_ids, b.n_padded) for b in srv_t.batch_log] == \
        [(b.seq, b.level, b.k, b.request_ids, b.n_padded) for b in srv_j.batch_log]
    for bt, bj in zip(srv_t.batch_log, srv_j.batch_log):
        np.testing.assert_array_equal(bt.rows, bj.rows)
    assert served > 0
    if load > 1.0:
        m = srv_t.metrics()
        assert m["n_shed_total"] > 0 and m["level_occupancy"]["no-hedge"] > 0


def test_open_loop_trace_bit_identical_to_jax():
    q = _queries(64)
    for qps, seed, t0 in ((100.0, None, 0.0), (250.0, 3, 1.5), (1e4, 11, 0.0)):
        a = open_loop_trace(q, qps=qps, seed=seed, t0=t0, k=2, deadline=0.1)
        b = jax_rt.open_loop_trace(q, qps=qps, seed=seed, t0=t0, k=2, deadline=0.1)
        assert [x.t for x in a] == [x.t for x in b]
        assert [(x.k, x.deadline) for x in a] == [(x.k, x.deadline) for x in b]
        np.testing.assert_array_equal(np.stack([x.query for x in a]),
                                      np.stack([np.asarray(x.query) for x in b]))
