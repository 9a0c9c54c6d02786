"""The dense engine's gathered route (k + over-fetch > MAX_UNROLLED_K) in the
PyTorch port: chunks of cell-sorted tiles, each tile's gathered candidate
union, one streaming top-k call per chunk through a per-tile identity
block table.  Held against the JAX package's fused route on the same numpy
inputs (bf16 at K = 25, fp32 at K = 33), against the route as it ran one
tile per call, and its chunk plan and identity table on their own.

Tolerances (those of ``test_torch_metrics.py``): distances rtol 1e-5 /
atol 1e-6, both sides scoring fp32 operands in fp32; found counts and ids
equal, except a found count beside a pair within 1e-4 of ε² in float64 and
an id beside another whose float64 distance ties with it.  Against the
one-tile-per-call route, which runs the same plain arithmetic on the same
candidates, everything is equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import _state
from test_torch_kernels import _assert_ints_mod_boundary
from repro.core import dense_join as jax_dense
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import grid as grid_lib
from repro_torch.kernels.knn_stream import kernel as stream_kernel
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.kernels.knn_stream import ref as stream_ref
from repro_torch.utils import round_up

RTOL, ATOL = 1e-5, 1e-6
EPS = 0.25


def _t(a):
    return torch.as_tensor(np.array(a))


def _per_tile_route(index, points_r, qids, eps2, k, budget, query_block, block_c,
                    queries_r=None, qcoords=None, exclude_self=True):
    """The gathered route as it ran before its tiles were batched: one tile
    at a time, each tile's candidate union through ``knn_stream_topk``."""
    queries = points_r if queries_r is None else queries_r
    coords_all = index.point_coords if qcoords is None else qcoords
    tiles, perm = grid_lib.group_queries_by_cell(index, qids, query_block, qcoords)
    outs = []
    for t in tiles:
        safe = torch.clamp(t, 0, queries.shape[0] - 1).long()
        starts, counts = grid_lib.neighbor_ranges(index, coords_all[safe])
        counts = counts * (t >= 0)[:, None]
        pos, valid, _, ovf = grid_lib.tile_shared_candidates(
            index, starts, counts, round_up(budget, block_c))
        pos = pos.long()
        cid = torch.where(valid, index.order[pos], torch.full_like(pos, -1, dtype=torch.int32))
        excl = t if exclude_self else torch.full_like(t, -2)
        kd, ki, found = stream_ops.knn_stream_topk(
            queries[safe], index.points_sorted[pos], excl, cid, eps2, k=k,
            block_q=query_block, block_c=block_c)
        outs.append((kd, ki, found, (found < k) | ovf, counts.sum(1, dtype=torch.int32)))
    return dense_lib._unpermute(perm, (torch.cat(x) for x in zip(*outs)))


def _ids_match_mod_ties(queries, pts_r, got_ids, want_ids, mask):
    """ids equal, except where the float64 distances of the two ids tie."""
    p64, q64 = np.asarray(pts_r, np.float64), np.asarray(queries, np.float64)
    rows = np.nonzero(mask)[0][:, None]
    got, want = got_ids[mask], want_ids[mask]
    gd = ((q64[rows] - p64[np.clip(got, 0, len(p64) - 1)]) ** 2).sum(-1)
    wd = ((q64[rows] - p64[np.clip(want, 0, len(p64) - 1)]) ** 2).sum(-1)
    same = (got == want) | ((got < 0) & (want < 0))
    np.testing.assert_allclose(np.where(same, 0.0, gd), np.where(same, 0.0, wd),
                               rtol=1e-5, atol=1e-7)


def _hold_against_jax(tres, jres, pts_r, queries, eps2):
    np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                  np.asarray(jres.total_candidates))
    p64, q64 = np.asarray(pts_r, np.float64), np.asarray(queries, np.float64)
    _assert_ints_mod_boundary(tres.found.numpy(), np.asarray(jres.found),
                              lambda r: ((p64 - q64[r]) ** 2).sum(-1), eps2)
    same = tres.found.numpy() == np.asarray(jres.found)
    np.testing.assert_array_equal(tres.failed.numpy()[same], np.asarray(jres.failed)[same])
    ok = ~tres.failed.numpy() & ~np.asarray(jres.failed)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                               rtol=RTOL, atol=ATOL)
    _ids_match_mod_ties(queries, pts_r, tres.ids.numpy(), np.asarray(jres.ids), ok)


@pytest.mark.parametrize("k,distance_dtype,budget,block_c", [
    (25, "bf16", 2048, 128),      # k + 8 > 32: the gathered route, at fp32
    (33, "fp32", 1024, 128),      # k > 32: the route hands k to the plain version
    (25, "bf16", 1024, 64),
])
def test_gathered_route_matches_jax_fused(k, distance_dtype, budget, block_c):
    pts_r, jg, tr, tg = _state(m=4)
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    kw = dict(k=k, budget=budget, block_c=block_c, backend="fused",
              distance_dtype=distance_dtype)
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(EPS), **kw)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(EPS), **kw)
    _hold_against_jax(tres, jres, pts_r, pts_r, EPS ** 2)


def test_gathered_route_foreign_queries_match_jax():
    """R≠S queries (no self exclusion) at K = 33."""
    pts_r, jg, tr, tg = _state(m=4)
    q = np.random.default_rng(8).normal(0, 0.2, (150, pts_r.shape[1])).astype(np.float32)
    qids = np.arange(150, dtype=np.int32)
    kw = dict(k=33, budget=1024, backend="fused", exclude_self=False)
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(0.6),
                                jnp.asarray(q), **kw)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.6), _t(q), **kw)
    _hold_against_jax(tres, jres, pts_r, q, 0.36)


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_gathered_route_equals_the_one_tile_route(monkeypatch, chunk_bytes):
    """Batched into chunks of tiles — as planned, or one tile a chunk — the
    route returns exactly what it returned one tile per call."""
    if chunk_bytes is not None:
        monkeypatch.setattr(dense_lib, "_CHUNK_BYTES", chunk_bytes)
    pts_r, _, tr, tg = _state(m=4)
    qids = torch.arange(pts_r.shape[0], dtype=torch.int32)
    qp = torch.cat([qids, torch.full((128 - len(qids) % 128,), -1, dtype=torch.int32)])
    eps2 = torch.tensor(EPS) ** 2
    got = dense_lib._gathered_join(tg, tr, qp, eps2, 33, 1024, 128, 128)
    want = _per_tile_route(tg, tr, qp, eps2, 33, 1024, 128, 128)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_gathered_chunk_plan_and_identity_table():
    """The chunk plan keeps a chunk's gathers near the byte budget (at
    least one tile), and the identity table names tile t's own blocks
    t·nblk + j of the stacked candidates."""
    pts_r, _, tr, tg = _state(m=4)
    for budget, block_c in ((1024, 128), (2048, 64), (300, 128)):
        chunk = dense_lib.tiles_per_chunk(tg, tr.shape[1], 128, budget, block_c)
        assert chunk >= 1
        cand = round_up(budget, block_c)
        per_tile = 128 * 3 ** tg.m * (tg.m * 4 + 96) + cand * (tr.shape[1] * 8 + 32) \
            + 128 * cand * 32
        assert chunk == max(1, dense_lib._CHUNK_BYTES // per_tile)
    table = stream_kernel.identity_block_table(5, 3, "cpu")
    assert table.dtype == torch.int32 and table.shape == (5, 3)
    np.testing.assert_array_equal(table.numpy(), np.arange(15).reshape(5, 3))


def test_tiles_op_matches_per_tile_plain_calls():
    """``knn_stream_topk_tiles`` on a chunk of tiles with different
    candidate blocks — one all −1, one with −1 rows — equals the plain
    streaming top-k run on each tile alone."""
    rng = np.random.default_rng(3)
    n_tiles, tq, tc, dim, k = 4, 128, 256, 7, 33
    q = torch.as_tensor(rng.normal(size=(n_tiles, tq, dim)).astype(np.float32))
    c = torch.as_tensor(rng.normal(size=(n_tiles, tc, dim)).astype(np.float32))
    qid = torch.as_tensor(rng.integers(0, 500, size=(n_tiles, tq)).astype(np.int32))
    cid = torch.as_tensor(rng.integers(0, 500, size=(n_tiles, tc)).astype(np.int32))
    cid[1] = -1
    cid[2, ::3] = -1
    eps2 = torch.tensor(4.0)
    kd, ki, found = stream_ops.knn_stream_topk_tiles(q, c, qid, cid, eps2, k=k, block_c=128)
    assert kd.shape == (n_tiles * tq, k) and found.shape == (n_tiles * tq,)
    for t in range(n_tiles):
        rd, ri, rf = stream_ref.knn_stream_topk_ref(q[t], c[t], qid[t], cid[t], eps2, k=k)
        rows = slice(t * tq, (t + 1) * tq)
        assert torch.equal(kd[rows], rd) and torch.equal(ki[rows], ri)
        assert torch.equal(found[rows], rf)
    assert (found[tq:2 * tq] == 0).all() and (ki[tq:2 * tq] == -1).all()
