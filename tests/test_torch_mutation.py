"""The mutable ``KNNIndex`` of the PyTorch port (insert / delete / compact,
the delta buffer and the merge-time fold, the splitter's ``net_adjust``)
against the JAX package and the float64 mutation oracle on the same seeded
numpy inputs, following ``tests/test_mutable_index.py``'s plans (its
sharded case is in ``test_torch_sharded.py``).

Both packages build with ε pinned, so their grids are equal.  Tolerance:
distances within 1e-5 of the JAX package's and within 1e-4 of the
oracle's (the reference suite's bound); ids equal except where the
float64 distances of the two ids tie within 1e-5; integer routing,
global ids and remaps equal.  A compacted index must equal a fresh build
on ``net_points()`` bit for bit."""
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from oracle import mutated_oracle, oracle_knn
from test_mutable_index import _foreign, assert_mutated_exact, assert_mutated_self_exact
from test_torch_core import _state
from repro.core import grid as jax_grid
from repro.core import splitter as jax_split
from repro.runtime import KNNIndex as JaxIndex
from repro.runtime import mutation as jax_mut
from repro_torch.core import HybridConfig
from repro_torch.core import splitter as split_lib
from repro_torch.runtime import JoinSession, KNNIndex, clear_engine_cache
from repro_torch.runtime import mutation as mut_lib

EPS = 0.15
TOL = 1e-5


def _cfg(**kw):
    base = dict(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, online_rebalance=False)
    base.update(kw)
    return base


def _pair(base, backend="ref", jax_backend=None, eps=EPS, **kw):
    """The JAX index and the port's on the same points, config and ε."""
    j = JaxIndex.build(base, jax_hybrid.HybridConfig(backend=jax_backend or backend,
                                                      **_cfg(**kw)), eps)
    t = KNNIndex.build(base, HybridConfig(backend=backend, **_cfg(**kw)), eps, device="cpu")
    return j, t


def _match(tr, jr, full, queries):
    """The port's result against the JAX package's on the same state:
    ``full`` holds every global id's row, ``queries`` the query rows."""
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tr.source, jr.source)
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    r, c = np.nonzero(tr.ids != jr.ids)
    q = np.asarray(queries, np.float64)
    full = np.asarray(full, np.float64)
    dt = np.linalg.norm(q[r] - full[tr.ids[r, c]], axis=-1)
    dj = np.linalg.norm(q[r] - full[jr.ids[r, c]], axis=-1)
    np.testing.assert_allclose(dt, dj, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend,jax_backend", [("fused", "fused"), ("pallas", "interpret")])
def test_mutation_sequence_matches_jax(backend, jax_backend):
    """insert → query → delete (base + delta ids) → foreign query and
    self-join → compact, on both dense backends: the port equals the JAX
    index after every step and the oracle over the net corpus; the
    compacted index equals a fresh build on ``net_points()`` bit for bit."""
    clear_engine_cache()
    base = make_mixture(300, 140, dim=6, seed=3)
    q = _foreign(seed=11)
    j, t = _pair(base, backend, jax_backend)
    ins = (0.05 * np.random.default_rng(7).normal(size=(9, 6))).astype(np.float32)
    gids = t.insert(ins)
    np.testing.assert_array_equal(gids, j.insert(ins))
    np.testing.assert_array_equal(gids, np.arange(440, 449))
    full = np.concatenate([base, ins])
    _match(t.query(q), j.query(q), full, q)
    dels = [2, 50, 200, 443]                 # three base ids + one delta id
    t.delete(dels)
    j.delete(dels)
    assert (t.n_points, t.n_delta, t.n_tombstones) == (j.n_points, j.n_delta, j.n_tombstones)
    assert not t.is_clean and t.n_base == 440
    tr = assert_mutated_exact(t, base, ins, dels, q, k=4)
    _match(tr, j.query(q, k=4), full, q)
    assert tr.stats.t_delta > 0 and tr.stats.t_wall >= tr.stats.t_delta
    assert t.compile_counts.get("delta") and t.compile_counts.get("merge")
    net, live = mutated_oracle(base, ins, dels)
    ts = assert_mutated_self_exact(t, base, ins, dels, k=4)
    _match(ts, j.query(exclude_self=True), full, net)

    np.testing.assert_array_equal(t.net_points(), j.net_points())
    remap = t.compact()
    np.testing.assert_array_equal(remap, j.compact())
    assert t.is_clean and t.generation == 1
    fresh = KNNIndex.build(net, HybridConfig(backend=backend, **_cfg()), EPS, device="cpu")
    for got, want in ((t.query(q), fresh.query(q)),
                      (t.query(exclude_self=True), fresh.query(exclude_self=True))):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
    _match(t.query(q), j.query(q), net, q)


def test_second_generation_mutates_again():
    """Mutations after a compaction address the NEW id space."""
    base = make_mixture(200, 80, dim=5, seed=9)
    j, t = _pair(base, k=3)
    for idx in (j, t):
        idx.delete([0, 17])
    remap = t.compact()
    np.testing.assert_array_equal(remap, j.compact())
    n1 = t.n_points
    assert n1 == 278 and remap[17] == -1
    ins = np.random.default_rng(1).normal(0, 0.05, (5, 5)).astype(np.float32)
    np.testing.assert_array_equal(t.insert(ins), np.arange(n1, n1 + 5))
    j.insert(ins)
    for idx in (j, t):
        idx.delete([int(remap[33])])
    q = _foreign(seed=2, n=31, dim=5)
    tr = assert_mutated_exact(t, t.points, ins, [int(remap[33])], q, k=3)
    _match(tr, j.query(q, k=3), np.concatenate([t.points, ins]), q)


def test_delete_then_reinsert_same_point():
    """A deleted-then-reinserted point is served under its NEW global id;
    the old id never resurfaces, and after compaction under the remap."""
    base = make_mixture(250, 100, dim=6, seed=4)
    j, t = _pair(base, k=3)
    coords = base[5].copy()
    for idx in (j, t):
        idx.delete([5])
    (gid,) = t.insert(coords[None])
    assert gid == j.insert(coords[None])[0] == 350
    res = assert_mutated_exact(t, base, coords[None], [5], coords[None], k=3)
    assert res.ids[0, 0] == 350 and res.dists[0, 0] == 0.0 and 5 not in res.ids
    _match(res, j.query(coords[None], k=3), np.concatenate([base, coords[None]]), coords[None])
    remap = t.compact()
    assert remap[5] == -1
    np.testing.assert_array_equal(t.query(coords[None], k=1).ids, [[remap[gid]]])


def test_delete_entire_k_neighborhood():
    """Tombstoning all of a query's top-k, then two more rings (16
    tombstones, past a headroom bucket), stays exact and equal to JAX."""
    base = make_mixture(300, 120, dim=6, seed=6)
    k = 4
    j, t = _pair(base, k=k)
    q = base[10][None] + np.float32(1e-3)
    dels = []
    for _ in range(3):
        victims = t.query(q, k=k).ids[0]
        np.testing.assert_array_equal(victims, j.query(q, k=k).ids[0])
        assert len(set(victims.tolist())) == k
        for idx in (j, t):
            idx.delete(victims)
        dels += victims.tolist()
        res = assert_mutated_exact(t, base, (), dels, q, k=k)
        assert not np.isin(res.ids, dels).any()
        _match(res, j.query(q, k=k), base, q)
    assert mut_lib.headroom_bucket(len(dels), False) == 16


def test_delta_overflow_triggers_autocompact():
    """Crossing ``mutation_compact_frac``·|D| pending rows (or tombstones)
    compacts inside the call; the ids handed back are post-compaction."""
    base = make_mixture(280, 140, dim=5, seed=8)
    j, t = _pair(base, k=3, mutation_compact_frac=0.02)
    ins = np.random.default_rng(3).normal(0, 0.05, (20, 5)).astype(np.float32)
    gids = t.insert(ins)
    np.testing.assert_array_equal(gids, j.insert(ins))
    assert t.generation == 1 and t.is_clean and t.n_points == 440
    np.testing.assert_array_equal(gids, np.arange(420, 440))
    np.testing.assert_array_equal(t.points[gids], ins)
    for idx in (j, t):
        idx.delete(np.arange(10))
    assert t.generation == j.generation == 2 and t.is_clean and t.n_points == 430
    q = _foreign(seed=4, n=29, dim=5)
    net, _ = mutated_oracle(np.concatenate([base, ins]), (), np.arange(10))
    want_d, _ = oracle_knn(net, q, k=3)
    tr = t.query(q)
    np.testing.assert_allclose(np.sort(tr.dists, 1), want_d, atol=1e-4)
    _match(tr, j.query(q), net, q)


def test_generation_swap_compiles_nothing():
    """With a pinned ε and an unchanged corpus-size bucket, a same-bucket
    query after ``compact()`` adds no engine bucket."""
    clear_engine_cache()
    base = make_mixture(300, 120, dim=6, seed=12)
    t = KNNIndex.build(base, HybridConfig(**_cfg(k=3)), 0.15, device="cpu")
    q = _foreign(seed=13)
    t.query(q)
    t.delete([3, 7])
    t.insert(base[[3, 7]])                   # same coords ⇒ same net grid
    t.query(q)
    assert t.compile_counts.get("delta") and t.compile_counts.get("merge")
    t.compact()
    before = t.total_compiles
    assert t.query(q).stats.n_engine_compiles == 0
    assert t.total_compiles == before, t.compile_counts


def test_mutated_index_not_reused_by_session():
    base = make_mixture(200, 80, dim=5, seed=14)
    session = JoinSession(HybridConfig(**_cfg(k=3)), device="cpu")
    idx1 = session.index_for(base)
    assert session.index_for(base) is idx1    # clean: reused
    idx1.delete([0])
    idx2 = session.index_for(base)
    assert idx2 is not idx1 and idx2.is_clean and idx2.n_points == 280


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_mutated_metric_index_matches_jax(metric):
    """ip serves the widened main pipeline through the brute lane; cosine
    rides the l2 engines over unit rows."""
    from repro_torch.retrieval import normalize_rows
    base = normalize_rows(make_mixture(220, 90, dim=6, seed=15))
    ins = normalize_rows(np.random.default_rng(2).normal(size=(12, 6)))
    q = normalize_rows(_foreign(seed=16, n=40))
    j, t = _pair(base, k=4, metric=metric)
    for idx in (j, t):
        idx.insert(ins)
        idx.delete([1, 9, 301, 312])
    tr, jr = t.query(q), j.query(q)
    _match(tr, jr, np.concatenate([base, ins]), q)
    net, live = mutated_oracle(base, ins, [1, 9, 301, 312])
    od, _ = oracle_knn(net, q, k=4, metric=metric)
    np.testing.assert_allclose(tr.dists, od, atol=1e-4)
    assert np.isin(tr.ids, live).all()


def test_delete_validation_matches_jax():
    base = make_mixture(60, 20, dim=4, seed=1)
    j, t = _pair(base, k=2)
    for idx in (j, t):
        idx.insert(base[:3])
        idx.delete([4, 81])
    for bad, match in (([4], "already deleted"), ([81], "already deleted"),
                       ([7, 7], "duplicate"), ([83], "out of range"), ([-1], "out of range")):
        for idx in (j, t):
            with pytest.raises(ValueError, match=match):
                idx.delete(bad)
    with pytest.raises(ValueError, match="points have 3 dims"):
        t.insert(np.zeros((2, 3), np.float32))


# ---------------------------------------------------------------------------
# The mutation substrate's pieces against the JAX module
# ---------------------------------------------------------------------------

def _states(dim=5, n_base=50, seed=0):
    """The same mutation history in both packages' ``MutationState``."""
    rng = np.random.default_rng(seed)
    js, ts = jax_mut.MutationState.empty(dim), mut_lib.MutationState.empty(dim)
    for n_ins, dels in ((7, [3, 51, 10]), (40, [0, 90, 49]), (1, [])):
        pts = rng.normal(size=(n_ins, dim)).astype(np.float32)
        js, jg = js.with_insert(pts, n_base, dim)
        ts, tg = ts.with_insert(pts, n_base, dim)
        np.testing.assert_array_equal(tg, jg)
        if dels:
            js, ts = js.with_delete(dels, n_base), ts.with_delete(dels, n_base)
    return js, ts, rng


def test_mutation_state_views_match_jax():
    js, ts, rng = _states()
    base = rng.normal(size=(50, 5)).astype(np.float32)
    perm = np.array([3, 0, 4, 1, 2])
    for a, b in zip(ts.net_corpus(base), js.net_corpus(base)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ts.remap_after_compact(50), js.remap_after_compact(50))
    for dp in (None, perm):
        for a, b in zip(ts.padded_delta(dp, 50), js.padded_delta(dp, 50)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ts.delta_r(dp), js.delta_r(dp))
    np.testing.assert_array_equal(ts.tombstone_table(), js.tombstone_table())
    assert ts.n_live(50) == js.n_live(50) and ts.n_delta_rows == 48
    for n, need_self in ((0, False), (0, True), (3, False), (8, True), (16, False), (17, True)):
        assert mut_lib.headroom_bucket(n, need_self) == jax_mut.headroom_bucket(n, need_self)


def test_delta_and_fold_ops_match_jax():
    """``delta_topk`` and ``fold_topk`` on integer data (exact scores, so
    ties decide): ids and scores equal to the JAX engines'; equal scores
    keep the main block first and the lower position in a block."""
    js, ts, rng = _states(dim=4, seed=3)
    ts = mut_lib.MutationState(np.round(ts.delta_points * 2), ts.delta_live, ts.base_tombs)
    js = jax_mut.MutationState(np.round(js.delta_points * 2), js.delta_live, js.base_tombs)
    pts, gids = ts.padded_delta(None, 50)
    q = rng.integers(-3, 4, (130, 4)).astype(np.float32)
    excl = np.where(rng.random(130) < 0.4, gids[rng.integers(0, 48, 130)], -2).astype(np.int32)
    td, ti = mut_lib.delta_topk(*(torch.as_tensor(x) for x in (q, pts, excl, gids)), k=6)
    jd, ji = jax_mut.delta_topk(q, *js.padded_delta(None, 50)[:1], excl,
                                js.padded_delta(None, 50)[1], k=6, mode="ref")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    main_d = np.sort(rng.integers(0, 12, (130, 16)).astype(np.float32), 1)
    main_i = rng.integers(0, 50, (130, 16)).astype(np.int32)
    main_d[:, -2:], main_i[:, -2:] = np.inf, -1
    args = (main_d, main_i, td.numpy(), ti.numpy(), ts.tombstone_table(), excl)
    fd, fi = mut_lib.fold_topk(*(torch.as_tensor(x) for x in args), k=6)
    gd, gi = jax_mut.fold_topk(*args, k=6)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(gi))
    np.testing.assert_array_equal(fd.numpy(), np.asarray(gd))
    assert not np.isin(fi.numpy(), ts.base_tombs).any()


def test_net_cell_adjustment_matches_jax():
    pts_r, jg, _, tg = _state(m=4, eps=0.25)
    pts_r = np.asarray(pts_r)
    rng = np.random.default_rng(4)
    q_cells = np.asarray(jax_grid.linearize(jg.point_coords, jg.radices))
    delta = pts_r[rng.choice(len(pts_r), 30)] + rng.normal(0, 0.01, (30, pts_r.shape[1]))
    tombs = pts_r[rng.choice(len(pts_r), 25, replace=False)]
    want = jax_mut.net_cell_adjustment(jg, q_cells, delta.astype(np.float32), tombs)
    got = mut_lib.net_cell_adjustment(tg, q_cells, delta.astype(np.float32), tombs)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("counts,rho,adjust", [
    ([10, 3], 0.0, None), ([10, 3], 0.0, [-8, 5]), ([10, 3], 0.0, [-20, 0]),
    ([10, 10], 0.5, [0, -3]), ([10, 10], 0.5, None), ([9, 30, 4, 0, 12], 0.4, [3, -25, 1, 2, -12]),
])
def test_split_from_counts_net_adjust_matches_jax(counts, rho, adjust):
    """The splitter's net-density correction: the same routing and adjusted
    (clamped at zero) home counts as the JAX splitter, on the plan of
    ``test_mutable_index.py::test_split_from_counts_net_adjust``."""
    k, m, gamma = 1, 2, 0.25
    c = np.array(counts, np.int32)
    a = None if adjust is None else np.array(adjust, np.int32)
    want = jax_split.split_from_counts(c, k, m, gamma, rho=rho, net_adjust=a)
    got = split_lib.split_from_counts(torch.as_tensor(c), k, m, gamma, rho=rho,
                                      net_adjust=None if a is None else torch.as_tensor(a))
    np.testing.assert_array_equal(got.to_dense.numpy(), np.asarray(want.to_dense))
    np.testing.assert_array_equal(got.home_counts.numpy(), np.asarray(want.home_counts))
    assert int(got.n_dense) == int(want.n_dense)


def test_split_queries_net_adjust_matches_jax():
    pts_r, jg, tp, tg = _state(m=4, eps=0.25)
    adj = np.random.default_rng(5).integers(-6, 7, len(tp)).astype(np.int32)
    want = jax_split.split_queries(jg, jg.point_coords, 4, 0.3, 0.2, net_adjust=adj)
    got = split_lib.split_queries(tg, tg.point_coords, 4, 0.3, 0.2,
                                  net_adjust=torch.as_tensor(adj))
    np.testing.assert_array_equal(got.to_dense.numpy(), np.asarray(want.to_dense))
    np.testing.assert_array_equal(got.home_counts.numpy(), np.asarray(want.home_counts))
