"""The port's fault-tolerant serving on the slot mesh (DESIGN.md §7): every
mesh case of ``tests/test_fault_serving.py`` and the sharded partial rung of
``tests/test_overload_server.py``, run on ``repro_torch`` in process over
``device="cpu"`` meshes (one process drives every slot; no subprocess and
no fake devices are needed).

Each test holds what its JAX test asserts; where the JAX test compares the
sharded index with a single-device one, the comparison here is with the
port's single-device ``KNNIndex`` — ids equal, distances within 2e-6 where
the JAX test allows that, bit-identical where it demands it.  Fault
scenarios are the ones ``tests/faults.py`` composes, scripted on the port's
``ScriptedFaults``: deterministic, no sleeps."""
import numpy as np
import pytest
import torch

from repro_torch.core import HybridConfig
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import (
    DegradationLevel, KNNIndex, KNNServer, ScriptedFaults, Served, ServerConfig,
    ServingConfig, ShardedKNNIndex, StragglerConfig, VirtualClock, clear_engine_cache,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    under the suite's parallel workers torch's thread pool only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_buckets():
    """Each JAX drill runs in a fresh process; here the bucket keys are
    process-global, so every test starts with none seen."""
    clear_engine_cache()


def make_db(seed=0, n_core=300, n_bg=140, dim=6):
    r = np.random.default_rng(seed)
    core = (0.05 * r.normal(size=(n_core, dim))).astype(np.float32)
    bg = r.uniform(-3.0, 3.0, (n_bg, dim)).astype(np.float32)
    return np.concatenate([core, bg]).astype(np.float32)


def make_queries(seed=1, n=60, dim=6):
    r = np.random.default_rng(seed)
    near = (0.05 * r.normal(size=(n - n // 3, dim))).astype(np.float32)
    far = r.uniform(3.0, 6.0, (n // 3, dim)).astype(np.float32)
    return np.concatenate([near, far]).astype(np.float32)


CFG = HybridConfig(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                   online_rebalance=False)


def mesh(shards, replicas=1):
    return make_serving_mesh(shards, replicas=replicas, device="cpu")


def build_pair(db, replicas=2, shards=2, cfg=CFG, epsilon=None):
    sharded = KNNIndex.build(db, cfg, epsilon, mesh=mesh(shards, replicas))
    single = KNNIndex.build(db, cfg, epsilon, device="cpu")
    return sharded, single


# The scenarios of tests/faults.py, on the port's ScriptedFaults.

def transient_spikes(replica=0, shards=(0, 1), seconds=5.0, period=4, start=6, until=40):
    f = ScriptedFaults()
    for s in shards:
        f.add_latency(replica, s, seconds, steps=range(start, until, period))
    return f


def flaky_replica(replica=1, shards=(0, 1), steps=(1, 2)):
    f = ScriptedFaults()
    for s in shards:
        f.fail_subquery(replica, s, steps=steps)
    return f


def killed_replica(replica=1, at_step=1):
    return ScriptedFaults().kill_replica(replica, at_step=at_step)


def lost_shard(shard=0, replicas=(0, 1), at_step=1, until=40):
    f = ScriptedFaults()
    for r in replicas:
        f.fail_subquery(r, shard, steps=range(at_step, until))
    return f


# ---------------------------------------------------------------------------
# healthy replicated serving
# ---------------------------------------------------------------------------

def test_replicated_mesh_healthy_parity():
    """2 replicas × 2 shards answers like the single-device index, reports
    full coverage, and replica groups add no engine bucket."""
    db, q = make_db(seed=30), make_queries(seed=31)
    sharded, single = build_pair(db)
    assert isinstance(sharded, ShardedKNNIndex)
    assert sharded.placement_shape == (2, 2)
    assert sharded.n_shards == 2 and sharded.n_replicas == 2

    want = single.query(q)
    res = sharded.query(q)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_allclose(res.dists, want.dists, rtol=2e-6, atol=2e-6)
    assert sharded.supervisor is not None
    assert res.coverage is not None and res.coverage.shape == (60, 2)
    assert res.coverage.all() and res.fully_covered
    assert res.stats.shards_lost == ()
    assert res.stats.n_subquery_failures == 0

    before = sharded.total_compiles
    for step in range(3):
        r = sharded.query(make_queries(seed=40 + step))
        np.testing.assert_array_equal(r.ids, single.query(make_queries(seed=40 + step)).ids)
    assert sharded.total_compiles == before
    assert sharded.compile_counts["merge"] == 1


# ---------------------------------------------------------------------------
# faults: retry, health, kill, degrade
# ---------------------------------------------------------------------------

def test_replica_kill_is_invisible_in_results():
    """A killed replica's sub-queries are retried on the sibling: results
    stay identical, no shard is lost, the replica leaves the routing set."""
    sharded, single = build_pair(make_db(seed=32))
    f = killed_replica(replica=1, at_step=1)
    sup = sharded.configure_serving(faults=f)
    retries = 0
    for step in range(6):
        q = make_queries(seed=50 + step)
        res = sharded.query(q)
        np.testing.assert_array_equal(res.ids, single.query(q).ids)
        assert res.coverage.all(), f"lost coverage at step {step}"
        assert res.stats.shards_lost == ()
        retries += res.stats.n_subquery_retries
    assert retries > 0, "kill never exercised the retry path"
    assert f.count("kill") > 0
    assert not sup.replica_healthy(1)
    assert sup.healthy_replicas() == [0]
    n_kills = f.count("kill")
    sharded.query(make_queries(seed=60))
    assert f.count("kill") == n_kills


def test_flaky_replica_recovers_health():
    """One failure, then success: the streak resets before
    ``unhealthy_after`` trips and the replica stays routed."""
    sharded, single = build_pair(make_db(seed=33))
    f = flaky_replica(replica=1, shards=(0, 1), steps=(1,))
    sup = sharded.configure_serving(faults=f)
    for step in range(5):
        q = make_queries(seed=70 + step)
        res = sharded.query(q)
        np.testing.assert_array_equal(res.ids, single.query(q).ids)
        assert res.coverage.all()
    assert f.count("fail") > 0
    assert sup.replica_healthy(1)
    assert sup.healthy_replicas() == [0, 1]


def test_lost_shard_degrades_with_exact_coverage():
    """Every replica fails shard 0: no raise, exactly shard 0's column is
    False, rows whose neighbours all live elsewhere stay identical, and no
    shard-0 id appears."""
    db, q = make_db(seed=34), make_queries(seed=35)
    sharded, single = build_pair(db)
    f = lost_shard(shard=0, replicas=(0, 1), at_step=0)
    sharded.configure_serving(ServingConfig(max_attempts=2), faults=f)

    want = single.query(q)
    res = sharded.query(q)
    assert res.stats.shards_lost == (0,)
    assert res.stats.n_subquery_failures >= 2
    assert not res.fully_covered
    assert (~res.coverage[:, 0]).all() and res.coverage[:, 1].all()
    owned0 = set(np.asarray(sharded._live[0].gids[0]).tolist())
    hit0 = np.isin(want.ids, list(owned0)).any(axis=1)
    np.testing.assert_array_equal(res.ids[~hit0], want.ids[~hit0])
    assert (~hit0).sum() > 0, "test db gave shard 0 every neighbor"
    assert not np.isin(res.ids, list(owned0)).any()
    assert (res.ids >= 0).all()


def test_transient_spikes_trigger_hedging():
    """Sparse 5 s spikes on replica 0 after the detector's warm-up are
    hedged to the sibling, the hedge wins, effective latency is accounted at
    threshold + t_sibling, and answers stay identical — every assertion of
    the JAX test (``tests/test_fault_serving.py``)."""
    sharded, single = build_pair(make_db(seed=36))
    f = transient_spikes(replica=0, shards=(0, 1), seconds=5.0, period=4, start=6)
    sharded.configure_serving(ServingConfig(detector=StragglerConfig(warmup_steps=4)),
                              faults=f)
    hedged = wins = 0
    t_eff = t_wall = 0.0
    for step in range(14):
        q = make_queries(seed=80 + step)
        res = sharded.query(q)
        np.testing.assert_array_equal(res.ids, single.query(q).ids)
        assert res.coverage.all()
        hedged += res.stats.n_hedged
        wins += res.stats.n_hedge_wins
        t_eff += res.stats.t_effective
        t_wall += res.stats.t_wall
    assert f.count("latency") > 0, "no spike ever fired"
    assert hedged > 0, "spikes never hedged"
    assert wins > 0, "hedge never beat a 5s spike"
    injected = 5.0 * f.count("latency")
    assert t_eff < t_wall + injected - 1.0, (t_eff, t_wall, injected)


def test_adapt_rho_feeds_splitter_online():
    """adapt_rho: the serve-time EWMA re-suggests ρ and the splitter takes
    it; answers stay identical (ρ only moves work between exact engines).

    ε is pinned to the one the JAX package selects for this cloud: the
    port's ε sampling differs from ``jax.random``, and at the port's own
    (0.1422) no query of either 220-point shard is dense, so no dense time
    is ever observed and the suggestion cannot warm up."""
    sharded, single = build_pair(make_db(seed=37), epsilon=0.1449330449104309)
    sharded.configure_serving(ServingConfig(adapt_rho=True))
    for step in range(3):
        q = make_queries(seed=90 + step)
        np.testing.assert_array_equal(sharded.query(q).ids, single.query(q).ids)
    rho = sharded.rho_suggestion
    assert rho is not None and 0.0 <= rho <= 1.0


# ---------------------------------------------------------------------------
# persistence across mesh shapes
# ---------------------------------------------------------------------------

def test_save_single_load_onto_replicated_mesh(tmp_path):
    """A single-device generation restores onto 2 × 2 and 1 × 4 with the
    same ids; a repeat in the bucket adds no bucket."""
    db, q = make_db(seed=38), make_queries(seed=39)
    single = KNNIndex.build(db, CFG, device="cpu")
    want = single.query(q)
    single.save(str(tmp_path))

    m22 = KNNIndex.load(str(tmp_path), mesh=mesh(2, replicas=2))
    assert isinstance(m22, ShardedKNNIndex)
    assert m22.placement_shape == (2, 2)
    r22 = m22.query(q)
    np.testing.assert_array_equal(r22.ids, want.ids)
    np.testing.assert_allclose(r22.dists, want.dists, rtol=2e-6, atol=2e-6)
    m14 = KNNIndex.load(str(tmp_path), mesh=mesh(4))
    assert m14.placement_shape == (1, 4)
    np.testing.assert_array_equal(m14.query(q).ids, want.ids)
    before = m22.total_compiles
    for step in range(3):
        m22.query(make_queries(seed=100 + step))
    assert m22.total_compiles == before


def test_save_sharded_load_single_roundtrip(tmp_path):
    """...and the reverse: saved from 2 × 2, restored with no mesh, answers
    bit-identical to the single-device index."""
    db, q = make_db(seed=41), make_queries(seed=42)
    sharded, single = build_pair(db)
    want = single.query(q)
    np.testing.assert_array_equal(sharded.query(q).ids, want.ids)
    sharded.save(str(tmp_path))
    back = KNNIndex.load(str(tmp_path), device="cpu")
    assert isinstance(back, KNNIndex) and not isinstance(back, ShardedKNNIndex)
    got = back.query(q)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)


# ---------------------------------------------------------------------------
# the overload server's partial rung over a 2 × 2 index
# ---------------------------------------------------------------------------

def test_sharded_partial_rung_flags_coverage():
    """Under pressure the partial rung serves a rotating half of the shards
    with coverage-flagged answers, hedging is toggled per flush and
    restored, full-rung responses equal the direct sharded query bit for
    bit, and a malformed shard subset is a ValueError."""
    r = np.random.default_rng(40)
    db = np.concatenate([(0.05 * r.normal(size=(300, 6))).astype(np.float32),
                         r.uniform(-3.0, 3.0, (140, 6)).astype(np.float32)])
    sharded = KNNIndex.build(db, CFG, mesh=mesh(2, replicas=2))
    assert sharded.n_shards == 2 and sharded.n_replicas == 2

    per_row = 1e-3
    ladder = (DegradationLevel("full"),
              DegradationLevel("partial", enter_pressure=0.3, hedging=False, shard_frac=0.5))
    srv = KNNServer(sharded,
                    ServerConfig(deadline=0.4, max_wait=0.0, max_batch=64,
                                 shed_on_admission=False, max_queue=10 ** 6, ladder=ladder,
                                 record_batches=True),
                    clock=VirtualClock(), service_model=lambda n: per_row * n)
    srv.prime_service_estimate(per_row)
    queries = r.normal(size=(200, 6)).astype(np.float32)
    tickets = [srv.submit(q) for q in queries]
    srv.pump()
    srv.drain()
    assert all(isinstance(t.outcome, Served) for t in tickets)

    partial = [t for t in tickets if t.outcome.level_name == "partial"]
    full = [t for t in tickets if t.outcome.level_name == "full"]
    assert partial and full, (len(partial), len(full))
    for t in partial:
        cov = t.outcome.coverage
        assert t.outcome.degraded
        assert cov is not None and cov.shape == (2,)
        assert cov.sum() == 1, cov
    for t in full:
        assert not t.outcome.degraded
        assert t.outcome.coverage is None or t.outcome.coverage.all()

    recs = [b for b in srv.batch_log if b.serve_shards is not None]
    assert recs and all(len(b.serve_shards) == 1 for b in recs)
    assert len(set(b.serve_shards for b in recs)) == 2, [b.serve_shards for b in recs]
    # each partial batch's responses flag exactly the skipped shard's column
    by_rid = {t.request_id: t for t in tickets}
    for b in recs:
        for rid in b.request_ids:
            cov = by_rid[rid].outcome.coverage
            assert cov[list(b.serve_shards)].all() and cov.sum() == len(b.serve_shards)
    assert sharded.supervisor.cfg.hedging

    for b in srv.batch_log:
        if srv.cfg.ladder[b.level].degraded:
            continue
        direct = sharded.query(b.rows, k=b.k)
        for j, rid in enumerate(b.request_ids):
            out = by_rid[rid].outcome
            np.testing.assert_array_equal(out.ids, direct.ids[j])
            np.testing.assert_array_equal(out.dists, direct.dists[j])

    with pytest.raises(ValueError, match="subset of shard ids"):
        sharded.query(queries[:4], _serve_shards=(9,))
