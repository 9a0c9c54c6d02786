"""Core modules of the PyTorch port against the JAX package on identical
numpy inputs: grid / REORDER / split / ε selection (integer outputs bit
for bit), and the engines — dense (``ref``, ``fused``), sparse (``ref``,
``fused``) and brute — run on identical built state via
``grid_from_arrays`` / ``pyramid_from_arrays``.  The work-queue scheduler
is driven with the JAX suite's numpy stub engines."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_mixture
from oracle import oracle_knn
from test_tiled_backend import _assert_equal_mod_boundary, _ids_match_mod_ties
from repro.core import brute as jax_brute
from repro.core import dense_join as jax_dense
from repro.core import epsilon as jax_eps
from repro.core import grid as jax_grid
from repro.core import sparse_knn as jax_sparse
from repro.core import splitter as jax_split
from repro_torch.core import brute as brute_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import epsilon as eps_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import queue as queue_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.core import splitter as split_lib

RTOL, ATOL = 1e-5, 1e-6
INT_FIELDS = ("unique_cells", "cell_starts", "cell_counts", "n_cells", "order",
              "point_cell_pos", "point_coords", "cells_per_dim", "radices")
FLOAT_FIELDS = ("epsilon", "mins", "cell_edge", "points_sorted")


def _t(a):
    return torch.as_tensor(np.array(a))


def _fields(g):
    return {f: np.asarray(getattr(g, f)) for f in INT_FIELDS + FLOAT_FIELDS
            if getattr(g, f) is not None}


def _state(m=4, eps=0.25, n_dense=300, n_sparse=100, dim=6, seed=1):
    """JAX-built reordered points + grid, and the port's copy of both."""
    pts = make_mixture(n_dense, n_sparse, dim=dim, seed=seed)
    pts_r = jax_grid.reorder_by_variance(jnp.asarray(pts))[0]
    jg = jax_grid.build_grid(pts_r, jnp.float32(eps), m)
    tg = grid_lib.grid_from_arrays(_fields(jg), m=m, n_points=len(pts), device="cpu")
    return pts_r, jg, _t(pts_r), tg


@pytest.mark.parametrize("m,eps", [(4, 0.25), (2, 0.1), (6, 0.6)])
def test_grid_metadata_bit_identical(m, eps):
    pts = make_mixture(600, 200, dim=8, seed=m)
    jr, jperm = jax_grid.reorder_by_variance(jnp.asarray(pts))
    tr, tperm = grid_lib.reorder_by_variance(_t(pts))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    jg = jax_grid.build_grid(jr, jnp.float32(eps), m)
    tg = grid_lib.build_grid(tr, torch.tensor(eps, dtype=torch.float32), m)
    for f in INT_FIELDS + FLOAT_FIELDS:
        got = getattr(tg, f).numpy()
        assert got.dtype == np.asarray(getattr(jg, f)).dtype, f
        np.testing.assert_array_equal(got, np.asarray(getattr(jg, f)), err_msg=f)
    # searches: neighbor ranges, candidate gather, query grouping
    coords = np.asarray(jg.point_coords)
    js, jc = jax.jit(jax_grid.neighbor_ranges)(jg, jnp.asarray(coords))
    ts, tc = grid_lib.neighbor_ranges(tg, _t(coords))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jout = jax.jit(jax_grid.gather_candidates, static_argnums=3)(jg, js, jc, 256)
    tout = grid_lib.gather_candidates(tg, ts, tc, 256)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qids = np.concatenate([np.arange(len(pts)), -np.ones(224)]).astype(np.int32)
    jt, jp = jax.jit(jax_grid.group_queries_by_cell, static_argnums=2)(
        jg, jnp.asarray(qids), 128)
    tt, tp = grid_lib.group_queries_by_cell(tg, _t(qids), 128)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jsh = jax.jit(jax_grid.tile_shared_candidates, static_argnums=3)(
        jg, js[:128], jc[:128], 512)
    tsh = grid_lib.tile_shared_candidates(tg, ts[:128], tc[:128], 512)
    for a, b in zip(tsh, jsh):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("gamma,rho", [(0.0, 0.0), (0.3, 0.2), (1.0, 0.9)])
def test_split_bit_identical(gamma, rho):
    pts_r, jg, tr, tg = _state(m=4, eps=0.2)
    js = jax_split.split_work(jg, 3, gamma, rho)
    ts = split_lib.split_work(tg, 3, gamma, rho)
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    q = np.random.default_rng(4).normal(0, 0.3, (90, pts_r.shape[1])).astype(np.float32)
    jq = jax_split.split_queries(jg, jax_grid.compute_cell_coords(jg, jnp.asarray(q)[:, :4]),
                                 3, gamma, rho)
    tq = split_lib.split_queries(tg, grid_lib.compute_cell_coords(tg, _t(q)[:, :4]),
                                 3, gamma, rho)
    for f in jq._fields:
        np.testing.assert_array_equal(getattr(tq, f).numpy(), np.asarray(getattr(jq, f)), err_msg=f)


@pytest.mark.parametrize("k,beta", [(3, 0.0), (8, 0.2)])
def test_epsilon_from_jax_drawn_indices(k, beta):
    """Fed the indices ``jax.random`` draws for ``PRNGKey(seed)``, the
    port's selection reproduces the JAX one."""
    pts = make_mixture(600, 200, dim=8, seed=3)
    pts_r = jax_grid.reorder_by_variance(jnp.asarray(pts))[0]
    key = jax.random.PRNGKey(7)
    n, npair, nq = len(pts), 512, 64
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    ia = jax.random.randint(ka, (npair,), 0, n)
    ib = jax.random.randint(kb, (npair,), 0, n)
    qidx = jax.random.randint(k2, (nq,), 0, n)
    want = jax_eps.select_epsilon(pts_r, key, k, beta, n_query_sample=nq,
                                  n_bins=128, n_pair_sample=npair)
    got = eps_lib.select_epsilon_from_indices(
        _t(pts_r), _t(ia).long(), _t(ib).long(), _t(qidx).long(), k, beta, n_bins=128)
    np.testing.assert_allclose(got.epsilon_mean.item(), float(want.epsilon_mean), rtol=1e-6)
    np.testing.assert_allclose(got.cumulative.numpy(), np.asarray(want.cumulative),
                               rtol=RTOL, atol=1e-3)
    for f in ("epsilon", "epsilon_beta", "epsilon_default"):
        np.testing.assert_allclose(getattr(got, f).item(), float(getattr(want, f)),
                                   rtol=1e-6, err_msg=f)
    # the port's own sampler: deterministic per seed, same on every call
    a = eps_lib.select_epsilon(_t(pts_r), 7, k, beta, n_query_sample=nq, n_bins=128,
                               n_pair_sample=npair)
    b = eps_lib.select_epsilon(_t(pts_r), 7, k, beta, n_query_sample=nq, n_bins=128,
                               n_pair_sample=npair)
    assert a.epsilon.item() == b.epsilon.item() > 0


def _compare_dense(jres, tres, pts_r, eps, k):
    np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                  np.asarray(jres.total_candidates))
    eps2 = float(eps) ** 2
    _assert_equal_mod_boundary(tres.found.numpy(), jres.found, pts_r, eps2)
    _assert_equal_mod_boundary(tres.failed.numpy(), jres.failed, pts_r, eps2)
    ok = ~np.asarray(jres.failed) & ~tres.failed.numpy()
    np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                               rtol=RTOL, atol=ATOL)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids), ok)
    assert tres.ids.dtype == torch.int32 and tres.found.dtype == torch.int32


@pytest.mark.parametrize("backend,k,budget,block_c,m", [
    ("ref", 3, 1024, 128, 4),
    ("fused", 1, 1024, 128, 4),
    ("fused", 5, 1024, 64, 4),
    ("fused", 3, 2048, 256, 6),
])
def test_dense_engine_on_identical_state(backend, k, budget, block_c, m):
    pts_r, jg, tr, tg = _state(m=m)
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    eps = 0.25
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(eps), k=k,
                                budget=budget, block_c=block_c, backend=backend)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(eps), k=k,
                                budget=budget, block_c=block_c, backend=backend)
    _compare_dense(jres, tres, pts_r, eps, k)
    assert (~tres.failed.numpy()).any(), "fixture must produce dense successes"


def test_fused_block_tables_bit_identical():
    """The block table and the membership rows the kernel consumes are
    bit-identical to the JAX metadata pass (including a tile-overflowing
    budget and padding rows)."""
    pts_r, jg, tr, tg = _state(m=4)
    qids = np.concatenate([np.arange(pts_r.shape[0]), -np.ones(112)]).astype(np.int32)
    jt, _ = jax_grid.group_queries_by_cell(jg, jnp.asarray(qids), 128)
    tt, _ = grid_lib.group_queries_by_cell(tg, _t(qids), 128)
    n_cb = -(-pts_r.shape[0] // 64)
    for budget, nblk in ((1024, n_cb), (256, 3)):
        jout = jax.jit(jax_dense._tile_block_tables, static_argnums=(4, 5, 6, 7))(
            jg, jg.point_coords, pts_r, jt, nblk, n_cb, budget, 64)
        tout = dense_lib._tile_block_tables(tg, tg.point_coords, tr, tt, nblk, n_cb,
                                            budget, 64)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dense_fused_foreign_queries_and_oversized_k():
    """R≠S queries through the fused engine, and k > MAX_UNROLLED_K (the
    gathered route, whose stream op uses the plain version)."""
    pts_r, jg, tr, tg = _state(m=4)
    q = np.random.default_rng(8).normal(0, 0.2, (150, pts_r.shape[1])).astype(np.float32)
    qids = np.arange(150, dtype=np.int32)
    for k in (4, 33):
        jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(0.3),
                                    jnp.asarray(q), k=k, budget=1024,
                                    backend="fused", exclude_self=False)
        tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.3), _t(q), k=k,
                                    budget=1024, backend="fused", exclude_self=False)
        np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                      np.asarray(jres.total_candidates))
        np.testing.assert_array_equal(tres.failed.numpy(), np.asarray(jres.failed))
        ok = ~tres.failed.numpy()
        np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                                   rtol=RTOL, atol=ATOL)


def _pyramids(m=4, eps=0.2):
    pts = make_mixture(200, 150, dim=8, seed=2)
    pts_r = jax_grid.reorder_by_variance(jnp.asarray(pts))[0]
    jp = jax_sparse.build_pyramid(pts_r, jnp.float32(eps), m)
    tp = sparse_lib.pyramid_from_arrays([_fields(g) for g in jp.levels], jp.cert_radii,
                                        m=m, n_points=len(pts), device="cpu")
    built = sparse_lib.build_pyramid(_t(pts_r), torch.tensor(eps), m)
    for a, b in zip(built.levels, jp.levels):
        for f in INT_FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))
    np.testing.assert_array_equal(built.cert_radii.numpy(), np.asarray(jp.cert_radii))
    return pts_r, jp, tp


@pytest.mark.parametrize("backend,k,budget", [("ref", 3, 512), ("fused", 5, 512),
                                              ("fused", 1, 1024)])
def test_sparse_engine_on_identical_state(backend, k, budget):
    pts_r, jp, tp = _pyramids()
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    jres = jax_sparse.sparse_knn(jp, pts_r, jnp.asarray(qids), k=k, budget=budget,
                                 backend=backend)
    tres = sparse_lib.sparse_knn(tp, _t(pts_r), _t(qids), k=k, budget=budget,
                                 backend=backend)
    agree = ((tres.level.numpy() == np.asarray(jres.level))
             & (tres.certified.numpy() == np.asarray(jres.certified)))
    if not agree.all():
        cert2 = np.asarray(jp.cert_radii, np.float64) ** 2
        kth = np.asarray(jres.dists)[~agree, k - 1].astype(np.float64)
        assert (np.abs(kth[:, None] - cert2[None, :]).min(axis=1) < 1e-4).all()
    assert agree.mean() > 0.95
    np.testing.assert_array_equal(tres.total_candidates.numpy()[agree],
                                  np.asarray(jres.total_candidates)[agree])
    np.testing.assert_allclose(tres.dists.numpy()[agree], np.asarray(jres.dists)[agree],
                               rtol=RTOL, atol=ATOL)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids),
                        np.asarray(jres.certified) & agree)
    assert tres.certified.numpy().any()


def test_sparse_engine_foreign_queries():
    pts_r, jp, tp = _pyramids()
    q = np.random.default_rng(9).normal(0, 0.3, (70, pts_r.shape[1])).astype(np.float32)
    qids = np.arange(70, dtype=np.int32)
    jres = jax_sparse.sparse_knn(jp, pts_r, jnp.asarray(qids), jnp.asarray(q), k=4,
                                 backend="fused", exclude_self=False)
    tres = sparse_lib.sparse_knn(tp, _t(pts_r), _t(qids), _t(q), k=4,
                                 backend="fused", exclude_self=False)
    np.testing.assert_array_equal(tres.level.numpy(), np.asarray(jres.level))
    np.testing.assert_array_equal(tres.certified.numpy(), np.asarray(jres.certified))
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,chunk", [(3, 4096), (6, 96)])
def test_brute_matches_jax_and_oracle(k, chunk):
    pts = make_mixture(300, 100, dim=6, seed=5)
    ids = np.arange(len(pts), dtype=np.int32)
    jd, ji = jax_brute.brute_knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(ids),
                                 k=k, corpus_chunk=chunk, kernel_mode="interpret")
    td, ti = brute_lib.brute_knn(_t(pts), _t(pts), _t(ids), k=k, corpus_chunk=chunk)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    _ids_match_mod_ties(pts, ti.numpy(), np.asarray(ji), np.ones(len(pts), bool))
    od, _ = oracle_knn(pts, k=k, exclude_self=True, squared=True)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-4, atol=1e-5)
    sd, si = brute_lib.self_join_brute(_t(pts), k=k, corpus_chunk=chunk)
    np.testing.assert_array_equal(si.numpy(), ti.numpy())


@pytest.mark.parametrize("device,n_corpus,k,corpus_chunk,want", [
    ("cuda", 5_000_000, 25, 4096, None),     # k within the kernel: one call
    ("cuda", 5_000_000, 32, 4096, None),
    ("cuda", 5_000_000, 33, 4096, 4096),     # past the kernel: streamed chunks
    ("cuda", 107_000, 40, 4096, 4096),
    ("cuda", 100, 64, 4096, 104),            # chunk cut to the corpus, rounded up to 8
    ("cpu", 5_000_000, 25, 4096, 4096),      # the CPU always streams
    ("cpu", 300, 3, 4096, 304),
])
def test_brute_corpus_chunk_plan(device, n_corpus, k, corpus_chunk, want):
    """One ``knn_topk`` call over the whole corpus only for a CUDA device
    with k ≤ MAX_UNROLLED_K; otherwise the reference's chunked stream."""
    assert brute_lib.corpus_chunk_plan(torch.device(device), n_corpus, k,
                                       corpus_chunk) == want
    assert brute_lib.corpus_chunk_plan(device, n_corpus, k, corpus_chunk) == want


@pytest.mark.parametrize("k", [33, 40])
def test_brute_past_kernel_k_matches_jax_and_oracle(k):
    """k > MAX_UNROLLED_K (the route the card now streams in chunks) on
    integer-valued rows, where many distances tie: fp32 distances, ids
    equal except where the realized distances tie, and the exact oracle's
    distances."""
    r = np.random.default_rng(k)
    pts = r.integers(-3, 4, size=(400, 5)).astype(np.float32)
    ids = np.arange(len(pts), dtype=np.int32)
    jd, ji = jax_brute.brute_knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(ids),
                                 k=k, corpus_chunk=96, kernel_mode="interpret")
    td, ti = brute_lib.brute_knn(_t(pts), _t(pts), _t(ids), k=k, corpus_chunk=96)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    _ids_match_mod_ties(pts, ti.numpy(), np.asarray(ji), np.ones(len(pts), bool))
    od, oi = oracle_knn(pts, k=k, exclude_self=True, squared=True)
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-4, atol=1e-5)
    # The stable oracle breaks ties toward the lower id, as both chunked
    # merges must (within and across chunks).
    np.testing.assert_array_equal(ti.numpy(), oi)


# ---------------------------------------------------------------------------
# the scheduler, with the JAX suite's numpy stub engines
# ---------------------------------------------------------------------------

def _stub_engines(npts, k, t_dense=1.0, t_sparse_handle=None, fail_ids=(),
                  uncertify_ids=()):
    fail_ids, uncertify_ids = set(fail_ids), set(uncertify_ids)

    def answer(ids):
        ids = np.asarray(ids)
        nids = (ids[:, None] + np.arange(1, k + 1)[None, :]) % npts
        return np.full((len(ids), k), 0.25, np.float32), nids.astype(np.int32)

    def dense_fn(ids):
        d, i = answer(ids)
        return d, i, np.array([q in fail_ids for q in ids], bool), t_dense

    def sparse_fn(ids):
        d, i = answer(ids)
        handle = queue_lib.AsyncEngineCall(
            (d, i, np.array([q not in uncertify_ids for q in ids], bool)))
        if t_sparse_handle is not None:
            handle.elapsed = t_sparse_handle
        return handle

    return dense_fn, sparse_fn, answer


def test_scheduler_routes_failures_and_uncertified():
    npts, k = 64, 2
    dense_fn, sparse_fn, brute_fn = _stub_engines(npts, k, fail_ids={3, 7},
                                                  uncertify_ids={3, 50})
    fd, fi, src, rep = queue_lib.run_work_queue(
        npts=npts, k=k, dense_ids=np.arange(0, 40, dtype=np.int32),
        sparse_ids=np.arange(40, npts, dtype=np.int32), home_counts=np.arange(npts),
        dense_fn=dense_fn, sparse_fn=sparse_fn, brute_fn=brute_fn, n_batches=4,
        online_rebalance=False)
    assert rep.n_failed == 2 and rep.n_uncertified == 2
    assert src[3] == 2 and src[50] == 2 and src[7] == 1 and src[5] == 0
    assert rep.n_sparse_engine_total == 24 + 2 and (fi >= 0).all()


def test_scheduler_online_demotion_and_floor():
    npts, k = 128, 2
    home = np.arange(npts)
    dense_fn, sparse_fn, brute_fn = _stub_engines(npts, k, t_dense=10.0,
                                                  t_sparse_handle=1e-6)
    fd, fi, src, rep = queue_lib.run_work_queue(
        npts=npts, k=k, dense_ids=np.arange(0, 96, dtype=np.int32),
        sparse_ids=np.arange(96, npts, dtype=np.int32), home_counts=home,
        dense_fn=dense_fn, sparse_fn=sparse_fn, brute_fn=brute_fn, n_batches=8,
        online_rebalance=True, sync_t1_after=1, demote_quantum=1)
    assert rep.n_rebalanced > 0 and rep.rho_online > 0.9
    demoted = np.nonzero(src[:96] == 1)[0]
    kept = np.nonzero(src[:96] == 0)[0]
    assert len(demoted) == rep.n_rebalanced
    assert home[demoted].max() < home[kept].min()
    with pytest.raises(ValueError, match="floor"):
        queue_lib.run_work_queue(
            npts=10, k=1, dense_ids=np.arange(8, dtype=np.int32),
            sparse_ids=np.arange(8, 10, dtype=np.int32), home_counts=np.ones(10),
            dense_fn=None, sparse_fn=None, brute_fn=None, min_sparse=5)


def test_workqueue_head_densest_tail_least_populated():
    home_counts = np.array([5, 50, 7, 90, 2, 30, 60, 11], np.int64)
    q = queue_lib.WorkQueue(np.arange(8, dtype=np.int32), home_counts, n_batches=4)
    assert list(home_counts[q.next_batch()]) == [90, 60]
    assert list(q.peek_tail_counts(3)) == [2, 5, 7]
    assert list(home_counts[q.demote(3)]) == [2, 5, 7]
    assert queue_lib.AsyncEngineCall((1, 2)).ready()
