"""Recall calibration and the approximate grid path of the PyTorch port
(``retrieval/calibrate.py``; ``KNNIndex``'s lean pass at a calibrated ε
scale, without failure reassignment or brute backstop) against the JAX
package on the same seeded numpy inputs, and the routing around it:
``recall_target=1.0`` stays bit-identical to the exact path, an
un-projected ip index and a mutated index serve exact with estimate 1.0,
and ``JoinSession`` / ``HybridKNNJoin`` carry both knobs through.

Both packages build with ε pinned, so their grids are equal, and must pick
the same ε scale with the same ``recall_estimate`` on the same sampled
rows.  Tolerance: distances within 1e-5 of the JAX package's; ids equal
except where the float64 distances of the two ids tie within 1e-5."""
import numpy as np
import pytest

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from test_torch_projection import EPS as PROJ_EPS
from test_torch_projection import PTS as PROJ_PTS
from test_torch_projection import _cfg as proj_cfg
from repro.retrieval import calibrate as jax_cal
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig, HybridKNNJoin
from repro_torch.retrieval import calibrate as cal_lib
from repro_torch.runtime import JoinSession, KNNIndex, knn_index

TOL = 1e-5
EPS = 0.1
DB = make_mixture(900, 100, dim=4, seed=17)
QUERIES = make_mixture(70, 26, dim=4, seed=18)


def _cfg(**kw):
    base = dict(k=8, m=3, online_rebalance=False, recall_target=0.9)
    base.update(kw)
    return base


def _hold(tr, jr, queries):
    np.testing.assert_allclose(tr.dists, np.asarray(jr.dists), rtol=TOL, atol=TOL)
    assert tr.recall_estimate == jr.recall_estimate
    np.testing.assert_array_equal(tr.source, np.asarray(jr.source))
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified", "batch_sizes",
              "n_sparse_rounds"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    jids = np.asarray(jr.ids)
    r, c = np.nonzero(tr.ids != jids)
    q = np.asarray(queries, np.float64)[r]
    db = DB.astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(q - db[tr.ids[r, c]], axis=-1),
                               np.linalg.norm(q - db[jids[r, c]], axis=-1), rtol=TOL, atol=TOL)


def _same(a, b):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(a.source, b.source)


def test_recall_at_k_and_sample_rows_match_jax():
    r = np.random.default_rng(3)
    approx = r.integers(-1, 50, (40, 8))
    exact = r.integers(-1, 50, (40, 8))
    excl = r.integers(0, 50, 40)
    for ex in (None, excl):
        assert cal_lib.recall_at_k(approx, exact, ex) == jax_cal.recall_at_k(approx, exact, ex)
    assert cal_lib.recall_at_k(exact, exact) == 1.0
    for n_base, calib, seed in ((1000, 128, 0), (90, 128, 5), (5000, 256, 7)):
        cfg = HybridConfig(k=3, calib_queries=calib, seed=seed)
        np.testing.assert_array_equal(cal_lib._sample_rows(n_base, cfg),
                                      jax_cal._sample_rows(n_base, cfg))
    assert cal_lib.GRID_EPS_TIERS == jax_cal.GRID_EPS_TIERS
    assert cal_lib.PROJ_CAND_TIERS == jax_cal.PROJ_CAND_TIERS


# (recall_target, the ε scale both must calibrate to; None = no lean tier
# met the target: the exact pipeline, estimate 1.0).
TARGETS = {0.85: 0.5, 0.9: 0.7, 0.95: None}


@pytest.mark.parametrize("target,backend,jax_backend",
                         [(0.9, "ref", "ref"), (0.9, "fused", "fused"),
                          (0.9, "pallas", "interpret"), (0.85, "fused", "fused"),
                          (0.95, "fused", "fused")])
def test_lean_grid_path_matches_jax(target, backend, jax_backend):
    j = JaxIndex.build(DB, jax_hybrid.HybridConfig(backend=jax_backend,
                                                   **_cfg(recall_target=target)), EPS)
    t = KNNIndex.build(DB, HybridConfig(backend=backend, **_cfg(recall_target=target)),
                       EPS, device="cpu")
    jr, tr = j.query(QUERIES), t.query(QUERIES)
    assert t._live[0].calib == j._live[0].calib
    scale, est = t._live[0].calib[("grid", 8, target)]
    assert scale == TARGETS[target] and (est >= target if scale else est == 1.0)
    _hold(tr, jr, QUERIES)
    js, ts = j.query(exclude_self=True), t.query(exclude_self=True)
    _hold(ts, js, DB)
    if scale is None:
        # The fallback is the exact pipeline, bit for bit.
        exact = KNNIndex.build(DB, HybridConfig(backend=backend, **_cfg(recall_target=1.0)),
                               EPS, device="cpu")
        _same(tr, exact.query(QUERIES))
        _same(ts, exact.query(exclude_self=True))
    else:
        # The lean pass: one dense call, no failure reassignment, no brute lane.
        assert tr.stats.n_batches <= 1 and (tr.source != 2).all()


@pytest.mark.parametrize("backend", ["ref", "fused", "pallas"])
def test_recall_target_one_is_bit_identical(backend):
    exact = KNNIndex.build(DB, HybridConfig(backend=backend, **_cfg(recall_target=1.0)),
                           EPS, device="cpu")
    plain = KNNIndex.build(DB, HybridConfig(backend=backend, k=8, m=3,
                                            online_rebalance=False), EPS, device="cpu")
    for args in ((QUERIES,), ()):
        kw = {} if args else dict(exclude_self=True)
        r1, r0 = exact.query(*args, **kw), plain.query(*args, **kw)
        _same(r1, r0)
        assert r1.recall_estimate == 1.0
    assert not exact._live[0].calib


def test_unprojected_ip_and_mutated_index_serve_exact():
    """An un-projected ip index serves through the exact brute lane
    whatever ``recall_target`` is; a mutated index serves exact through
    the delta buffer and the fold.  Both report 1.0 and calibrate nothing."""
    for metric in ("ip", "l2"):
        approx = KNNIndex.build(DB, HybridConfig(**_cfg(metric=metric)), EPS, device="cpu")
        exact = KNNIndex.build(DB, HybridConfig(**_cfg(metric=metric, recall_target=1.0)),
                               EPS, device="cpu")
        if metric == "l2":
            for idx in (approx, exact):
                idx.insert(QUERIES[:12] + 0.01)
                idx.delete([0, 3, 901])
        ra, re = approx.query(QUERIES), exact.query(QUERIES)
        _same(ra, re)
        assert ra.recall_estimate == 1.0 and not approx._live[0].calib
        if metric == "ip":
            assert (ra.source == 2).all()


def test_lean_repeat_adds_no_bucket():
    """The calibration runs once per generation and (path, k, target): a
    same-bucket repeat re-measures nothing and adds no engine bucket; the
    lean rung's scaled ε is a device operand, so the served pass reuses
    the exact path's dense bucket."""
    knn_index.clear_engine_cache()
    exact = KNNIndex.build(DB, HybridConfig(**_cfg(recall_target=1.0)), EPS, device="cpu")
    exact.query(QUERIES)
    t = KNNIndex.build(DB, HybridConfig(**_cfg()), EPS, device="cpu")
    first = t.query(QUERIES)
    assert t.compile_counts["dense"] == 0        # the sample and the batch: seen buckets
    again = t.query(QUERIES[:80])
    assert again.stats.n_engine_compiles == 0
    assert again.recall_estimate == first.recall_estimate
    np.testing.assert_array_equal(again.ids, first.ids[:80])
    assert list(t._live[0].calib) == [("grid", 8, 0.9)]
    t.query(QUERIES, k=5)
    assert sorted(t._live[0].calib) == [("grid", 5, 0.9), ("grid", 8, 0.9)]


def test_session_and_hybrid_join_carry_the_targets():
    """``JoinSession`` and ``HybridKNNJoin`` serve ``index.query(
    exclude_self=True)`` of an index built with their config: the lean
    grid pass and the projection front stage come through unchanged."""
    for points, cfg, eps, key in ((DB, HybridConfig(**_cfg()), EPS, ("grid", 8, 0.9)),
                                  (PROJ_PTS, HybridConfig(**proj_cfg()), PROJ_EPS,
                                   ("proj", 6, 0.9))):
        index = KNNIndex.build(points, cfg, eps, device="cpu")
        want = index.query(exclude_self=True)
        assert index._live[0].calib[key][0] is not None
        for join in (JoinSession(cfg, device="cpu"), HybridKNNJoin(cfg, device="cpu").session):
            res = join.join(points, eps)
            assert join.index_for(points, eps)._live[0].calib == index._live[0].calib
            assert res.recall_estimate == want.recall_estimate
            _same(res, want)
