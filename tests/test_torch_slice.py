"""The port's main path as a whole: ``KNNIndex.build`` + ``query`` (self-join
and an R≠S batch) against the JAX package's fused backend with ε pinned
and online rebalancing off, and against the float64 oracle; steady-state
engine buckets; the CUDA default of every entry point; a mesh, which the
port does not run yet, raising ``NotImplementedError``."""
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from oracle import oracle_knn
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig, HybridKNNJoin
from repro_torch.data import pointclouds
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import JoinSession, KNNIndex, ShardedKNNIndex

K = 5
EPS = 0.18


def _cfg(**kw):
    base = dict(k=K, m=4, gamma=0.3, rho=0.2, online_rebalance=False)
    base.update(kw)
    return base


def _assert_exact(res, pts, queries, exclude_self):
    od, oi = oracle_knn(pts, queries, k=res.dists.shape[1], exclude_self=exclude_self)
    np.testing.assert_allclose(res.dists, od, rtol=1e-5, atol=1e-5)
    q = pts if queries is None else queries
    got = np.linalg.norm(q.astype(np.float64)[:, None, :] - pts[res.ids], axis=-1)
    np.testing.assert_allclose(got, od, rtol=1e-5, atol=1e-5)
    assert ((res.ids == oi) | (np.abs(got - od) > 0) | np.isclose(got, od)).all()


@pytest.fixture(scope="module")
def both():
    pts = make_mixture(600, 200, dim=8, seed=0)
    q = make_mixture(200, 100, dim=8, seed=5)     # a foreign (R≠S) batch
    jidx = JaxIndex.build(pts, jax_hybrid.HybridConfig(**_cfg(backend="fused")), EPS)
    tidx = KNNIndex.build(pts, HybridConfig(**_cfg(backend="fused")), EPS, device="cpu")
    return pts, q, jidx, tidx


@pytest.mark.parametrize("foreign", [False, True])
def test_slice_matches_jax_fused_and_oracle(both, foreign):
    pts, q, jidx, tidx = both
    np.testing.assert_array_equal(tidx.dim_perm.numpy(), np.asarray(jidx.dim_perm))
    np.testing.assert_array_equal(tidx.home_counts, jidx.home_counts)
    if foreign:
        jr, tr = jidx.query(q), tidx.query(q)
    else:
        jr, tr = jidx.query(exclude_self=True), tidx.query(exclude_self=True)
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified", "n_batches",
              "batch_sizes", "n_sparse_rounds", "n_sparse_engine_total"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    assert tr.stats.n_dense > 0 and tr.stats.n_sparse > 0
    np.testing.assert_array_equal(tr.source, jr.source)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-6)
    _assert_exact(tr, pts, q if foreign else None, not foreign)


def test_slice_steady_state_zero_new_buckets(both):
    pts, q, _, tidx = both
    first = tidx.query(q)
    again = tidx.query(q.copy())
    assert again.stats.n_engine_compiles == 0
    np.testing.assert_array_equal(again.ids, first.ids)
    session = JoinSession(HybridConfig(**_cfg()), device="cpu")
    assert session.backend == "ref"
    cold = session.join(pts)
    assert cold.stats.t_build > 0
    warm = session.join(pts.copy())
    assert warm.stats.n_engine_compiles == 0
    reused = session.join(session.index_for(pts).points)
    assert reused.stats.t_build == 0.0
    np.testing.assert_allclose(warm.dists, cold.dists, atol=1e-6)


def test_slice_selects_epsilon_and_stays_exact():
    """No pinned ε: the port samples with its own generator, runs the
    histogram and stays exact through the hybrid wrapper."""
    pts = make_mixture(500, 150, dim=6, seed=3)
    res = HybridKNNJoin(HybridConfig(**_cfg(k=4, backend="fused")), device="cpu").join(pts)
    assert res.stats.epsilon > 0 and res.stats.t_select_eps > 0
    _assert_exact(res, pts, None, True)


def test_susy_routing_matches_jax():
    """Routing on the SuSy-shaped cloud that ``chip_smoke.py`` joins (all 18
    dims carry variance, so m = 6 cells are crowded): the port's fused path
    and the JAX package's ref backend send the same queries to the same
    engines at |D| = 50,000 with ``chip_smoke.py``'s config, ε pinned near
    the value the port selects there, and an R≠S batch of 1,024 perturbed
    SuSy rows (the sparse engine's cost grows with the queries, not |D|)."""
    pts = pointclouds.load("susy", n_override=50_000)
    noise = np.random.default_rng(1).normal(0, 0.01, (1024, pts.shape[1]))
    q = (pointclouds.load("susy", n_override=1024) + noise).astype(np.float32)
    kw = dict(k=25, m=6, gamma=0.4, rho=0.2, online_rebalance=False)
    jr = JaxIndex.build(pts, jax_hybrid.HybridConfig(backend="ref", **kw), 0.2343).query(q)
    tr = KNNIndex.build(pts, HybridConfig(backend="fused", **kw), 0.2343,
                        device="cpu").query(q)
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified", "batch_sizes",
              "n_sparse_rounds", "n_sparse_engine_total"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    assert tr.stats.n_dense > 0 and tr.stats.n_sparse > 0
    np.testing.assert_array_equal(tr.source, jr.source)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-6)
    s = tr.stats
    print(f"susy 50,000 x 18, 1,024 R≠S queries: n_dense={s.n_dense} "
          f"n_sparse={s.n_sparse} n_failed={s.n_failed} "
          f"n_uncertified={s.n_uncertified} sources={np.bincount(tr.source, minlength=3)}")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = make_mixture(100, 20, dim=4)
    cfg = HybridConfig(k=2, m=2)
    for make in (lambda: KNNIndex.build(pts, cfg), lambda: JoinSession(cfg),
                 lambda: HybridKNNJoin(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_interpret_backend_refuses_cuda(monkeypatch):
    """``backend="interpret"`` is an alias of the tiled route for CPU
    tensors: on a CUDA device it raises (naming ``"pallas"``) instead of
    skipping the kernel."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = HybridConfig(k=2, m=2, backend="interpret")
    with pytest.raises(ValueError, match="pallas"):
        JoinSession(cfg)
    from repro_torch.core import dense_join as dense_lib
    with pytest.raises(ValueError, match="pallas"):
        dense_lib.resolve_backend("interpret", "cuda")
    assert dense_lib.resolve_backend("interpret", "cpu") == "pallas"
    assert dense_lib.resolve_backend("pallas", "cuda") == "pallas"


def test_mutation_and_mesh_raise(both, tmp_path):
    """Mutation, persistence and the mesh are ported (``test_torch_mutation.py``,
    ``test_torch_persistence.py``, ``test_torch_sharded.py``): a real CPU mesh
    builds, loads and serves a ``ShardedKNNIndex`` answering like the
    single-device index; anything that is not a ``Mesh`` raises a
    ``TypeError`` naming its type."""
    pts, q, _, tidx = both
    mesh = make_serving_mesh(2, device="cpu")
    sharded = KNNIndex.build(pts, tidx.config, tidx.eps, mesh=mesh)
    assert isinstance(sharded, ShardedKNNIndex) and sharded.placement_shape == (1, 2)
    want = tidx.query(q)
    np.testing.assert_array_equal(sharded.query(q).ids, want.ids)
    tidx.save(str(tmp_path))
    loaded = KNNIndex.load(str(tmp_path), mesh=mesh)
    assert isinstance(loaded, ShardedKNNIndex)
    np.testing.assert_array_equal(loaded.query(q).ids, want.ids)
    session = JoinSession(tidx.config, mesh=mesh)
    assert isinstance(session.index_for(pts, tidx.eps), ShardedKNNIndex)
    for call in (lambda: KNNIndex.build(pts, tidx.config, device="cpu", mesh=object()),
                 lambda: KNNIndex.load(str(tmp_path), device="cpu", mesh=object()),
                 lambda: JoinSession(HybridConfig(k=2), device="cpu", mesh=object())):
        with pytest.raises(TypeError, match="got object"):
            call()
