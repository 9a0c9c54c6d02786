"""The port's serving fault-policy components against the JAX package:
every case of ``tests/test_robustness_units.py`` run on
``repro_torch.runtime`` (the StragglerDetector's serving-side surface, the
Eq. 6 rho lever, the Supervisor's elastic hook, ServingSupervisor's
routing / retry / hedge decisions, the scripted injector, input
validation), plus parity drills: the same seeded sequences go through
both packages' ``StragglerDetector`` (``update`` and ``observed_step``),
``OnlineRho``, ``suggest_rho``, ``Supervisor.run`` and
``ServingSupervisor.run_subquery`` — each package with its own
``ScriptedFaults`` script — and outputs and state must be equal exactly
(the modules are the same numpy arithmetic in the same order)."""
import dataclasses

import numpy as np
import pytest

import repro.runtime as jax_rt
import repro_torch.runtime as torch_rt
from repro_torch.runtime import (
    OnlineRho, ScriptedFaults, ServingConfig, ServingSupervisor,
    StragglerConfig, StragglerDetector, SubQueryFault, Supervisor,
    SupervisorConfig, suggest_rho, validate_points,
)

# ---------------------------------------------------------------------------
# straggler detector: serving-side surface
# ---------------------------------------------------------------------------


def test_detector_warmup_gates_thresholds():
    det = StragglerDetector(4, StragglerConfig(warmup_steps=5))
    for step in range(5):
        assert not det.warmed_up
        assert det.fleet_threshold() is None     # no hedging on cold cache
        det.update(np.full(4, 0.1))
    det.update(np.full(4, 0.1))
    assert det.warmed_up
    t = det.fleet_threshold()
    # uniform fleet: threshold sits just above mu (sigma ~ 0)
    assert t is not None and 0.1 < t < 0.11


def test_detector_hysteresis_flag_then_recover():
    det = StragglerDetector(4, StragglerConfig(warmup_steps=2, patience=3))
    base = np.full(4, 1.0)
    for _ in range(6):
        det.update(base)
    bad = base.copy()
    bad[2] = 5.0
    assert det.update(bad) == []                  # 1 consecutive flag
    assert det.update(bad) == []                  # 2
    assert det.update(bad) == [2]                 # 3 == patience -> reported
    assert 2 not in det.healthy_hosts()
    det.update(base)                              # one healthy step...
    assert 2 in det.healthy_hosts()               # ...resets the streak
    assert det.update(bad) == []                  # and flagging restarts at 1


def test_detector_partial_observation_feed():
    """Serving only exercises some (replica, shard) lanes per step;
    unobserved lanes must neither drift toward zero nor poison the
    fleet median."""
    det = StragglerDetector(4, StragglerConfig(warmup_steps=1))
    for _ in range(8):
        det.observed_step({0: 0.1, 1: 0.1})       # lanes 2,3 never observed
    assert det.warmed_up
    # unobserved lanes carry the neutral fill, not zeros
    assert det.mu[2] == pytest.approx(0.1) and det.mu[3] == pytest.approx(0.1)
    flagged = det.observed_step({0: 0.1, 3: 9.0})
    # one hiccup on a rarely-seen lane: flagged streak starts, not reported
    assert flagged == [] and det.flags[3] == 1


def test_suggest_rho_direction():
    """Eq. 6 online: a slower sparse engine (t2 up) pushes rho up (more
    queries to the dense engine) and vice versa; degenerate input is
    neutral."""
    assert suggest_rho(1.0, 3.0) == pytest.approx(0.75)
    assert suggest_rho(3.0, 1.0) == pytest.approx(0.25)
    assert suggest_rho(1.0, 3.0) > suggest_rho(1.0, 1.0) > suggest_rho(3.0, 1.0)
    assert suggest_rho(0.0, 0.0) == 0.5


def test_suggest_rho_pressure_ramp_is_monotone_and_clamped():
    """Under a load ramp that slows one engine monotonically, the Eq. 6
    suggestion must move monotonically in the matching direction and
    stay a valid rho at any extremity — overload must never produce an
    out-of-range split the scheduler would assert on."""
    # dense engine (t2) degrading under pressure: rho ratchets up
    ramp = [suggest_rho(1.0, t2) for t2 in np.linspace(0.5, 50.0, 25)]
    assert all(b >= a for a, b in zip(ramp, ramp[1:]))
    # sparse engine (t1) degrading under pressure: rho ratchets down
    ramp = [suggest_rho(t1, 1.0) for t1 in np.linspace(0.5, 50.0, 25)]
    assert all(b <= a for a, b in zip(ramp, ramp[1:]))
    # extremities clamp to a valid rho instead of overshooting
    for t1, t2 in [(0.0, 1e9), (1e9, 0.0), (1e-30, 1e30), (1e30, 1e-30),
                   (0.0, 0.0), (-1.0, 2.0), (2.0, -1.0)]:
        assert 0.0 <= suggest_rho(t1, t2) <= 1.0


def test_online_rho_warmup_never_emits_then_tracks_ramp():
    """The serving EWMA wrapper: no suggestion until BOTH engines have
    ``warmup`` samples (a one-sided estimate would slam rho to an
    extreme), then suggestions follow a pressure ramp monotonically and
    stay clamped."""
    online = OnlineRho(alpha=0.5, warmup=3)
    for i in range(3):
        assert online.suggestion is None          # cold: never emits
        online.note(1.0, 1.0 + i)
    # t1 never fed enough on its own: one-sided feeds keep it gated
    one_sided = OnlineRho(warmup=2)
    for _ in range(5):
        one_sided.note(1.0, 0.0)                  # t2 <= 0: not a sample
    assert one_sided.suggestion is None
    # warmed up: the dense engine slowing under a ramp pushes rho up,
    # monotonically, and never out of [0, 1]
    assert online.suggestion is not None
    got = []
    for t2 in np.linspace(2.0, 100.0, 20):
        online.note(1.0, float(t2))
        s = online.suggestion
        assert 0.0 <= s <= 1.0
        got.append(s)
    assert all(b >= a for a, b in zip(got, got[1:]))
    assert got[-1] > 0.9                          # tracked the ramp


def test_supervisor_elastic_hook_sees_each_restart():
    """The on_restart hook is the elastic-downsize path: it must fire
    once per restart with the restart index (serving advances its
    replica cursor there)."""
    calls = []
    attempts = {"n": 0}

    def step_fn(state, step):
        attempts["n"] += 1
        if attempts["n"] <= 2:
            raise RuntimeError("transient")
        return state

    sup = Supervisor(
        SupervisorConfig(max_restarts=3, max_same_step_failures=3,
                         checkpoint_every=10**9),
        save_fn=lambda s, st: None, restore_fn=lambda: (None, 0),
        on_restart=calls.append)
    _, report = sup.run(None, step_fn, 0, 1)
    assert report.completed and calls == [1, 2]


# ---------------------------------------------------------------------------
# serving supervisor: routing + health
# ---------------------------------------------------------------------------


def _sup(n_replicas=2, n_shards=2, **kw):
    return ServingSupervisor(n_replicas, n_shards, ServingConfig(**kw))


def test_route_rotates_across_shards_and_steps():
    sup = _sup(n_replicas=3)
    # every route is a permutation of the healthy set...
    for shard in range(2):
        for step in range(4):
            assert sorted(sup.route(shard, step)) == [0, 1, 2]
    # ...and concurrent shards at one step start on different replicas
    assert sup.route(0, 0)[0] != sup.route(1, 0)[0]
    # successive steps rotate the same shard's primary
    assert sup.route(0, 0)[0] != sup.route(0, 1)[0]


def test_unhealthy_replica_leaves_routing_and_recovers():
    sup = _sup(unhealthy_after=2)
    sup._streak[1] = 2
    assert sup.healthy_replicas() == [0]
    assert all(r == 0 for r in sup.route(0, 5))
    sup._streak[1] = 0                            # a later success heals it
    assert sup.healthy_replicas() == [0, 1]


def test_run_subquery_success_records_lane_time():
    sup = _sup()
    out = sup.run_subquery(0, 0, lambda r: (f"res{r}", 0.25))
    primary = sup.route(0, 0)[0]
    assert out.served and out.result == f"res{primary}"
    assert out.retries == 0 and out.failures == 0
    assert out.times == {sup.lane(primary, 0): 0.25}


def test_run_subquery_retries_on_sibling():
    sup = _sup()
    primary = sup.route(0, 0)[0]

    def attempt(r):
        if r == primary:
            raise SubQueryFault("injected")
        return "ok", 0.1

    out = sup.run_subquery(0, 0, attempt)
    assert out.served and out.result == "ok" and out.replica != primary
    assert out.failures == 1 and out.retries == 1
    assert sup._streak[primary] == 1              # counted toward unhealthy
    assert sup._streak[out.replica] == 0


def test_run_subquery_exhaustion_marks_lost_never_raises():
    sup = _sup(max_attempts=3)                    # capped by 2 replicas

    def attempt(r):
        raise SubQueryFault("all replicas fail this shard")

    out = sup.run_subquery(0, 0, attempt)
    assert not out.served and out.result is None
    assert out.failures == 2                      # one per replica candidate
    # both replicas now carry a failure streak
    assert (sup._streak >= 1).all()


def test_run_subquery_with_no_healthy_replicas():
    sup = _sup(unhealthy_after=1)
    sup._streak[:] = 1
    out = sup.run_subquery(0, 0, lambda r: ("never", 0.0))
    assert not out.served and out.failures == 0


# ---------------------------------------------------------------------------
# serving supervisor: hedging
# ---------------------------------------------------------------------------


def _warm(sup, t=0.1, steps=6):
    """Feed uniform lane times so the detector warms up with mu ~= t."""
    lanes = {sup.lane(r, s): t for r in range(sup.n_replicas)
             for s in range(sup.n_shards)}
    for _ in range(steps):
        sup.observe(lanes)


def test_hedge_fires_on_transient_spike_and_wins():
    sup = _sup()
    _warm(sup, t=0.1)
    thresh = sup.hedge_threshold()
    assert thresh is not None and thresh < 0.2    # ~ max(mu+3sig, 1.5*mu)
    primary = sup.route(0, 0)[0]
    out = sup.run_subquery(
        0, 0, lambda r: (f"res{r}", 1.0 if r == primary else 0.05))
    assert out.hedged and out.hedge_won
    assert out.result != f"res{primary}"          # sibling's copy won
    assert out.t_effective == pytest.approx(thresh + 0.05)
    # both lanes' observations recorded for the detector feed
    assert len(out.times) == 2


def test_hedge_fires_but_primary_still_wins():
    sup = _sup()
    _warm(sup, t=0.1)
    thresh = sup.hedge_threshold()
    primary = sup.route(0, 0)[0]
    # sibling is just as slow: threshold + t_h >= t_primary
    out = sup.run_subquery(0, 0, lambda r: (f"res{r}", 0.5))
    assert out.hedged and not out.hedge_won
    assert out.result == f"res{primary}"
    assert out.t_effective == pytest.approx(0.5)
    assert thresh + 0.5 > 0.5


def test_hedge_respects_warmup_and_disable():
    # during warmup: no threshold, no hedge, however slow
    cold = _sup()
    out = cold.run_subquery(0, 0, lambda r: ("x", 99.0))
    assert not out.hedged
    # warmed but disabled by config
    off = _sup(hedging=False)
    _warm(off, t=0.1)
    out = off.run_subquery(0, 0, lambda r: ("x", 99.0))
    assert not out.hedged


def test_hedge_min_factor_floors_threshold():
    """A perfectly uniform fleet has sigma ~ 0; the min-factor floor
    keeps mu-level noise from hedging every query."""
    sup = _sup(hedge_min_factor=2.0)
    _warm(sup, t=0.1)
    assert sup.hedge_threshold() == pytest.approx(0.2, rel=1e-2)


# ---------------------------------------------------------------------------
# scripted faults: the injector itself
# ---------------------------------------------------------------------------


def test_scripted_faults_latency_fail_kill_and_log():
    f = (ScriptedFaults()
         .add_latency(0, 1, 0.5, steps=[3])
         .fail_subquery(1, 0, steps=[2])
         .kill_replica(1, at_step=5))
    assert f.subquery(0, 1, 2) == 0.0             # unscripted -> healthy
    assert f.subquery(0, 1, 3) == 0.5
    with pytest.raises(SubQueryFault):
        f.subquery(1, 0, 2)
    assert f.subquery(1, 0, 3) == 0.0             # flaky, not dead yet
    for step in (5, 6, 17):                       # kill is permanent
        with pytest.raises(SubQueryFault):
            f.subquery(1, 1, step)
    assert f.count("latency") == 1 and f.count("fail") == 1
    assert f.count("kill") == 3
    assert ("fail", 1, 0, 2) in f.log


# ---------------------------------------------------------------------------
# input validation (serving surface)
# ---------------------------------------------------------------------------


def test_validate_points_rejects_bad_dtype_shape_dims():
    with pytest.raises(ValueError, match="numeric dtype"):
        validate_points(np.array([["a", "b"]]), 2)
    with pytest.raises(ValueError, match="2-D"):
        validate_points(np.zeros(6, np.float32), 6)
    with pytest.raises(ValueError, match=r"\(rows, 6\)"):
        validate_points(np.zeros((4, 3), np.float32), 6)
    # int input is fine (cast downstream), and passes through unconverted
    a = np.zeros((4, 6), np.int32)
    assert validate_points(a, 6) is a


def test_serving_config_validates():
    with pytest.raises(AssertionError):
        ServingConfig(max_attempts=0)
    with pytest.raises(AssertionError):
        ServingConfig(hedge_min_factor=0.5)


# ---------------------------------------------------------------------------
# parity with the JAX package: same sequences, equal outputs and state
# ---------------------------------------------------------------------------


def _same_detector(t, j):
    assert t.count == j.count
    np.testing.assert_array_equal(t.mu, j.mu)
    np.testing.assert_array_equal(t.var, j.var)
    np.testing.assert_array_equal(t.flags, j.flags)
    assert t.fleet_threshold() == j.fleet_threshold()
    assert t.healthy_hosts() == j.healthy_hosts()


@pytest.mark.parametrize("n_hosts,warmup,patience", [(4, 2, 3), (6, 5, 2), (1, 0, 3)])
def test_detector_parity_update_and_observed_step(n_hosts, warmup, patience):
    """Full-observation steps with a straggler injected now and then, then
    partial observations (the serving feed): flags, EWMA state and the
    fleet threshold equal the JAX detector's after every step."""
    cfg = dict(alpha=0.2, k_sigma=3.0, patience=patience, warmup_steps=warmup)
    t = StragglerDetector(n_hosts, StragglerConfig(**cfg))
    j = jax_rt.StragglerDetector(n_hosts, jax_rt.StragglerConfig(**cfg))
    r = np.random.default_rng(n_hosts * 10 + warmup)
    for step in range(40):
        times = 0.1 + 0.01 * r.random(n_hosts)
        if step % 7 in (3, 4, 5):
            times[step % n_hosts] += 1.0
        assert t.update(times) == j.update(times)
        _same_detector(t, j)
    for step in range(40):
        lanes = r.choice(n_hosts, size=r.integers(0, n_hosts + 1), replace=False)
        obs = {int(h): float(0.1 + 0.02 * r.random() + (2.0 if step % 9 == 0 else 0.0))
               for h in lanes}
        assert t.observed_step(obs) == j.observed_step(obs)
        _same_detector(t, j)
    assert t.warmed_up == j.warmed_up


def test_detector_parity_cold_partial_feed():
    """observed_step on a cold detector fills with this step's median."""
    t = StragglerDetector(5, StragglerConfig(warmup_steps=1))
    j = jax_rt.StragglerDetector(5, jax_rt.StragglerConfig(warmup_steps=1))
    for obs in ({}, {1: 0.3, 4: 0.1}, {0: 0.2}, {2: 0.5, 3: 0.05, 4: 9.0}):
        assert t.observed_step(obs) == j.observed_step(obs)
        _same_detector(t, j)


def test_online_rho_and_suggest_rho_parity():
    r = np.random.default_rng(3)
    pairs = np.concatenate([r.exponential(1.0, (200, 2)),
                            r.normal(0.0, 1.0, (50, 2)),
                            [[0.0, 0.0], [0.0, 1e9], [1e-30, 1e30], [-1.0, 2.0]]])
    for t1, t2 in pairs:
        assert suggest_rho(t1, t2) == jax_rt.suggest_rho(t1, t2)
    for alpha, warmup in ((0.3, 1), (0.5, 3), (1.0, 2)):
        t, j = OnlineRho(alpha, warmup), jax_rt.OnlineRho(alpha, warmup)
        for t1, t2 in r.exponential(1.0, (60, 2)) * (r.random((60, 2)) > 0.3):
            t.note(float(t1), float(t2))
            j.note(float(t1), float(t2))
            assert t.warmed_up == j.warmed_up
            assert t.suggestion == j.suggestion


def test_supervisor_run_parity():
    """A step function that fails on scripted attempts: the same reports
    (final step, restarts, failures, completed), saves and restart hooks."""
    def drive(sup_cls, cfg_cls, fail_on, max_restarts):
        log = []
        attempts = {"n": 0}

        def step_fn(state, step):
            attempts["n"] += 1
            if attempts["n"] in fail_on:
                raise RuntimeError(f"attempt {attempts['n']}")
            return state + [step]

        sup = sup_cls(cfg_cls(max_restarts=max_restarts, max_same_step_failures=2,
                              checkpoint_every=3),
                      save_fn=lambda s, st: log.append(("save", s, list(st))),
                      restore_fn=lambda: ([], 0),
                      on_restart=lambda n: log.append(("restart", n)))
        state, rep = sup.run([], step_fn, 0, 8)
        return state, dataclasses.astuple(rep), log

    for fail_on, max_restarts in (((), 5), ((2, 5), 5), ((4, 5, 6), 5), ((1, 2, 3, 4), 2)):
        assert drive(Supervisor, SupervisorConfig, set(fail_on), max_restarts) == \
            drive(jax_rt.Supervisor, jax_rt.SupervisorConfig, set(fail_on), max_restarts)


def _script(pkg):
    """The same fault script in either package's own ``ScriptedFaults``."""
    return (pkg.ScriptedFaults()
            .add_latency(0, 1, 0.5, steps=range(8, 60, 5))
            .add_latency(2, 0, 2.0, steps=[12, 13, 30])
            .fail_subquery(1, 0, steps=[3, 4, 5, 21])
            .fail_subquery(2, 1, steps=[9, 10, 11])
            .fail_subquery(0, 0, steps=[40])
            .kill_replica(1, at_step=45))


def _drill(pkg, hedging=True):
    """60 serve steps over 3 replicas × 2 shards: each sub-query's base
    time is seeded, the script adds latency or raises, the supervisor
    routes, retries and hedges, and the observed lane times feed the
    detector.  Returns everything observable."""
    sup = pkg.ServingSupervisor(3, 2, pkg.ServingConfig(
        hedging=hedging, max_attempts=3, unhealthy_after=2,
        detector=pkg.StragglerConfig(warmup_steps=4)))
    faults = _script(pkg)
    r = np.random.default_rng(17)
    base = 0.1 + 0.02 * r.random((60, 3, 2))
    trail = []
    for step in range(60):
        times = {}
        for shard in range(2):
            def attempt(rep, shard=shard, step=step):
                extra = faults.subquery(rep, shard, step)
                return (rep, shard, step), float(base[step, rep, shard]) + extra

            out = sup.run_subquery(shard, step, attempt)
            trail.append((step, shard, dataclasses.astuple(out), sup.hedge_threshold(),
                          tuple(int(x) for x in sup._streak), tuple(sup.route(shard, step))))
            times.update(out.times)
        trail.append(("observe", sup.observe(times), sup.detector.mu.tolist(),
                      sup.detector.var.tolist(), sup.detector.flags.tolist()))
    return trail, list(faults.log), sup.healthy_replicas()


@pytest.mark.parametrize("hedging", [True, False])
def test_run_subquery_parity_under_scripted_faults(hedging):
    """Routing, retries across replicas, health streaks, hedges (fired and
    won or lost), the kill and every ``SubQueryOutcome`` field equal the
    JAX package's step for step, as do the fault logs."""
    trail_t, log_t, healthy_t = _drill(torch_rt, hedging)
    trail_j, log_j, healthy_j = _drill(jax_rt, hedging)
    assert log_t == log_j and healthy_t == healthy_j
    assert len(trail_t) == len(trail_j)
    for a, b in zip(trail_t, trail_j):
        assert a == b
    outs = [x[2] for x in trail_t if x[0] != "observe"]
    fields = [f.name for f in dataclasses.fields(jax_rt.SubQueryOutcome)]
    hedged, won, retries = (fields.index(n) for n in ("hedged", "hedge_won", "retries"))
    assert any(o[retries] for o in outs), "the drill never retried"
    if hedging:
        assert any(o[hedged] for o in outs) and any(o[won] for o in outs), \
            "the drill never hedged and won"
