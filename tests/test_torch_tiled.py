"""The port's cell-tiled ``pallas`` path against the JAX package's tiled
backend (``backend="interpret"``: the Pallas kernel body on the CPU) on the
same numpy inputs: the ``pairwise_l2`` kernel's plain version (l2, ip, and
static / runtime SHORTC across several d-chunks), the tiled dense engine
(self-join, R≠S, exclusion off, tile overflow, a partial tile), the sparse
engine's matmul branch and ``KNNIndex`` end to end.

Tolerances: the two sides sum in other orders, so distances agree to rtol
1e-5 with an atol scaled to the values (1e-4 on values up to ~2e3);
``found``/``failed`` agree except for pairs within 1e-4 of ε² in float64;
ids agree except where the float64 distances tie."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from oracle import oracle_knn
from test_tiled_backend import _assert_equal_mod_boundary, _ids_match_mod_ties
from test_torch_core import _fields, _pyramids, _state
from repro.core import dense_join as jax_dense
from repro.core import grid as jax_grid
from repro.core import sparse_knn as jax_sparse
from repro.kernels.pairwise_l2 import ops as jax_pairwise_ops
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.kernels.pairwise_l2 import kernel as pairwise_kernel
from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
from repro_torch.kernels.pairwise_l2 import ref as pairwise_ref
from repro_torch.runtime import KNNIndex

RTOL = 1e-5


def _t(a):
    return torch.as_tensor(np.array(a))


def _shortc_operands(dim=200, seed=0):
    """Queries near candidate rows 0..127 and far (+3 in every dim) from
    rows 128..255, so the far (block_q × block_c) tiles exceed ε² after the
    first d-chunk and stop accumulating while the near ones run to the end."""
    r = np.random.default_rng(seed)
    q = r.normal(0, 0.1, (100, dim)).astype(np.float32)
    c = r.normal(0, 0.1, (300, dim)).astype(np.float32)
    c[128:256] += 3.0
    return q, c


@pytest.mark.parametrize("metric,shortc", [("l2", None), ("ip", None),
                                           ("l2", "static"), ("l2", "tensor")])
def test_pairwise_plain_version_matches_jax_kernel(metric, shortc):
    """D = 200 in chunks of 64 (4 chunks, the last ragged) with 128 × 128
    tiles; under SHORTC the far tiles skip their later chunks on both sides
    and hold the same partial sums."""
    q, c = _shortc_operands()
    eps2 = 6.0
    kw = dict(block_q=128, block_c=128, block_d=64, metric=metric)
    want = jax_pairwise_ops.pairwise_sq_l2(
        jnp.asarray(q), jnp.asarray(c), mode="interpret",
        shortc_eps2={None: None, "static": eps2, "tensor": jnp.float32(eps2)}[shortc],
        **kw)
    got = pairwise_ops.pairwise_sq_l2(
        _t(q), _t(c), shortc_eps2={None: None, "static": eps2,
                                   "tensor": torch.tensor(eps2)}[shortc], **kw)
    assert got.shape == (100, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)
    full = pairwise_ref.pairwise_sq_l2_ref(_t(q), _t(c))
    if metric == "ip":
        np.testing.assert_allclose(got.numpy(), pairwise_ref.pairwise_neg_ip_ref(
            _t(q), _t(c)).numpy(), rtol=RTOL, atol=1e-4)
        return
    # Entries within ε² are exact distances on both paths; skipped tiles
    # hold partial sums that already exceed ε².
    near = full.numpy() <= eps2
    assert near.any()
    np.testing.assert_allclose(got.numpy()[near], full.numpy()[near], rtol=1e-4, atol=1e-4)
    chunks = torch.zeros((1, 1, 3), dtype=torch.int32)
    qp = torch.cat([_t(q), torch.zeros((28, 200))])
    cp = torch.cat([_t(c), torch.zeros((84, 200))])
    pairwise_ref.pairwise_sq_l2_matmul_ref(
        qp, cp, shortc_eps2=eps2 if shortc else None, chunks_out=chunks, **kw)
    if shortc:
        assert chunks.tolist() == [[[4, 1, 4]]]
        assert (got.numpy()[:, 128:256] < full.numpy()[:, 128:256]).all()
        assert (got.numpy()[:, 128:256] > eps2).all()
    else:
        assert chunks.tolist() == [[[4, 4, 4]]]
        np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4, atol=1e-3)


def test_pairwise_ip_with_shortc_raises_and_batched_entry():
    q, c = _shortc_operands(dim=16)
    with pytest.raises(ValueError, match="shortc_eps2"):
        pairwise_ops.pairwise_sq_l2(_t(q), _t(c), shortc_eps2=1.0, metric="ip")
    with pytest.raises(ValueError, match="shortc_eps2"):
        jax_pairwise_ops.pairwise_sq_l2(jnp.asarray(q), jnp.asarray(c), shortc_eps2=1.0,
                                        metric="ip", mode="interpret")
    # The batched entry scores each tile against its own candidates.
    qb = _t(q[:64]).reshape(2, 32, 16)
    cb = _t(c[:128]).reshape(2, 64, 16)
    out = pairwise_ops.pairwise_sq_l2_batched(qb, cb, block_q=32, block_c=64, block_d=8)
    for b in range(2):
        np.testing.assert_allclose(out[b].numpy(),
                                   pairwise_ref.pairwise_sq_l2_ref(qb[b], cb[b]).numpy(),
                                   rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_kernel.pairwise_sq_l2(qb, cb, block_q=32, block_c=64)
    assert not pairwise_kernel.launches


def _compare_dense(jres, tres, pts_r, eps):
    """The dense parity contract for a self-join (module docstring)."""
    np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                  np.asarray(jres.total_candidates))
    eps2 = float(eps) ** 2
    _assert_equal_mod_boundary(tres.found.numpy(), jres.found, pts_r, eps2)
    _assert_equal_mod_boundary(tres.failed.numpy(), jres.failed, pts_r, eps2)
    ok = ~np.asarray(jres.failed) & ~tres.failed.numpy()
    np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                               rtol=1e-4, atol=1e-5)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids), ok)
    return ok


@pytest.mark.parametrize("k,budget,block_c,m,exclude_self", [
    (1, 1024, 128, 4, True),
    (5, 1024, 64, 4, True),
    (3, 2048, 256, 6, True),
    (4, 1024, 128, 4, False),
])
def test_tiled_dense_matches_jax_tiled(k, budget, block_c, m, exclude_self):
    pts_r, jg, tr, tg = _state(m=m)
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    kw = dict(k=k, budget=budget, block_c=block_c, exclude_self=exclude_self)
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(0.25),
                                backend="interpret", **kw)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.25),
                                backend="pallas", **kw)
    ok = _compare_dense(jres, tres, pts_r, 0.25)
    assert ok.any(), "fixture must produce dense successes"
    if not exclude_self:
        assert (tres.ids.numpy()[ok, 0] == qids[ok]).all()


def test_tiled_dense_foreign_queries_and_ip():
    """R≠S queries through the tiled route, in l2 and in ip (no SHORTC,
    ε² a plain score threshold); the CPU ``interpret`` backend is the same
    route."""
    pts_r, jg, tr, tg = _state(m=4)
    q = np.random.default_rng(8).normal(0, 0.2, (150, pts_r.shape[1])).astype(np.float32)
    qids = np.arange(150, dtype=np.int32)
    for metric, eps in (("l2", 0.3), ("ip", 0.1)):
        kw = dict(k=4, budget=1024, exclude_self=False, metric=metric)
        jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(eps),
                                    jnp.asarray(q), backend="interpret", **kw)
        tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(eps), _t(q),
                                    backend="pallas", **kw)
        q64, p64 = q.astype(np.float64), np.asarray(pts_r, np.float64)
        scores = (-q64 @ p64.T if metric == "ip"
                  else ((q64[:, None] - p64[None]) ** 2).sum(-1))
        for got, want in ((tres.found, jres.found), (tres.failed, jres.failed)):
            rows = np.nonzero(got.numpy() != np.asarray(want))[0]
            assert (np.abs(scores[rows] - eps ** 2).min(axis=1) < 1e-4).all()
        ok = ~tres.failed.numpy() & ~np.asarray(jres.failed)
        np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                      np.asarray(jres.total_candidates))
        np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                                   rtol=1e-4, atol=1e-5)
        assert ok.any()
        again = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(eps), _t(q),
                                     backend="interpret", **kw)
        for a, b in zip(again, tres):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (tres.dists.numpy()[ok] < 0).any(), "ip scores must stay unclamped"


def test_tiled_dense_tile_overflow_fails_the_whole_tile():
    """A budget below a tile's union fails every query of that tile, on
    both sides, whatever each query found."""
    pts_r, jg, tr, tg = _state(m=4)
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    kw = dict(k=2, budget=128, block_c=64)
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(0.25),
                                backend="interpret", **kw)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.25),
                                backend="pallas", **kw)
    np.testing.assert_array_equal(tres.failed.numpy(), np.asarray(jres.failed))
    tiles, _ = grid_lib.group_queries_by_cell(tg, _t(np.concatenate(
        [qids, -np.ones(-len(qids) % 128, np.int32)])), 128)
    _, _, _, _, ovf = dense_lib.tiled_candidates(tg, tr, tiles, 128, 64)
    assert ovf.any() and not ovf.all()
    for t in np.nonzero(ovf.numpy())[0]:
        rows = tiles[t].numpy()
        assert tres.failed.numpy()[rows[rows >= 0]].all()
    assert (tres.found.numpy()[tres.failed.numpy()] >= 2).any(), \
        "an overflowed tile must fail queries that found k"


def test_tiled_dense_partial_tile_ignores_padding_neighborhoods():
    """Padding rows clip to point 0, whose dense neighborhood must not
    enter a partial tile's shared union (the JAX regression case)."""
    r = np.random.default_rng(0)
    pts = np.concatenate([r.normal(0, 0.01, (300, 4)),
                          r.normal(0, 0.05, (20, 4)) + 5.0]).astype(np.float32)
    jg = jax_grid.build_grid(jnp.asarray(pts), jnp.float32(0.5), 4)
    tg = grid_lib.grid_from_arrays(_fields(jg), m=4, n_points=len(pts), device="cpu")
    qids = np.arange(300, 320, dtype=np.int32)
    kw = dict(k=3, budget=128)
    jres = jax_dense.dense_join(jg, jnp.asarray(pts), jnp.asarray(qids), jnp.float32(0.5),
                                backend="interpret", **kw)
    tres = dense_lib.dense_join(tg, _t(pts), _t(qids), torch.tensor(0.5),
                                backend="pallas", **kw)
    assert not tres.failed.numpy().any()
    np.testing.assert_array_equal(tres.found.numpy(), np.asarray(jres.found))
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists),
                               rtol=1e-4, atol=1e-5)


def test_batched_tile_candidates_match_per_tile():
    """``tile_shared_candidates`` on a (T, TQ, R) batch equals T single-tile
    calls."""
    pts_r, jg, tr, tg = _state(m=4)
    qids = np.concatenate([np.arange(pts_r.shape[0]), -np.ones(112)]).astype(np.int32)
    tiles, _ = grid_lib.group_queries_by_cell(tg, _t(qids), 128)
    safe = torch.clamp(tiles, 0, pts_r.shape[0] - 1).long()
    starts, counts = grid_lib.neighbor_ranges(tg, tg.point_coords[safe].reshape(-1, 4))
    starts = starts.reshape(tiles.shape[0], 128, -1)
    counts = counts.reshape(starts.shape) * (tiles >= 0)[:, :, None]
    batched = grid_lib.tile_shared_candidates(tg, starts, counts, 512)
    for t in range(tiles.shape[0]):
        one = grid_lib.tile_shared_candidates(tg, starts[t], counts[t], 512)
        for a, b in zip(batched, one):
            np.testing.assert_array_equal(a[t].numpy(), b.numpy())


@pytest.mark.parametrize("k,budget", [(1, 512), (5, 512)])
def test_sparse_pallas_matches_jax(k, budget):
    pts_r, jp, tp = _pyramids()
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    jres = jax_sparse.sparse_knn(jp, pts_r, jnp.asarray(qids), k=k, budget=budget,
                                 backend="interpret")
    tres = sparse_lib.sparse_knn(tp, _t(pts_r), _t(qids), k=k, budget=budget,
                                 backend="pallas")
    agree = ((tres.level.numpy() == np.asarray(jres.level))
             & (tres.certified.numpy() == np.asarray(jres.certified)))
    if not agree.all():
        cert2 = np.asarray(jp.cert_radii, np.float64) ** 2
        kth = np.asarray(jres.dists)[~agree, k - 1].astype(np.float64)
        assert (np.abs(kth[:, None] - cert2[None, :]).min(axis=1) < 1e-4).all()
    assert agree.mean() > 0.95 and tres.certified.numpy().any()
    np.testing.assert_array_equal(tres.total_candidates.numpy()[agree],
                                  np.asarray(jres.total_candidates)[agree])
    np.testing.assert_allclose(tres.dists.numpy()[agree], np.asarray(jres.dists)[agree],
                               rtol=1e-4, atol=1e-5)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids),
                        np.asarray(jres.certified) & agree)


def test_index_pallas_matches_jax_tiled_and_oracle():
    """``KNNIndex(backend="pallas")``: self-join and an R≠S batch against
    the JAX index on its tiled backend (ε pinned, rebalancing off) and the
    float64 oracle; the steady-state repeat adds no engine bucket."""
    pts = make_mixture(600, 200, dim=8, seed=0)
    q = make_mixture(200, 100, dim=8, seed=5)
    base = dict(k=5, m=4, gamma=0.3, rho=0.2, online_rebalance=False)
    jidx = JaxIndex.build(pts, jax_hybrid.HybridConfig(backend="interpret", **base), 0.18)
    tidx = KNNIndex.build(pts, HybridConfig(backend="pallas", **base), 0.18, device="cpu")
    assert tidx.backend == "pallas"
    for jr, tr, queries in ((jidx.query(exclude_self=True), tidx.query(exclude_self=True),
                             None),
                            (jidx.query(q), tidx.query(q), q)):
        for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified", "batch_sizes"):
            assert getattr(tr.stats, f) == getattr(jr.stats, f), f
        assert tr.stats.n_dense > tr.stats.n_failed
        np.testing.assert_array_equal(tr.source, jr.source)
        np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)
        od, _ = oracle_knn(pts, queries, k=5, exclude_self=queries is None)
        np.testing.assert_allclose(tr.dists, od, rtol=1e-5, atol=1e-5)
    assert tidx.query(q.copy()).stats.n_engine_compiles == 0
