"""The port's metric and precision knobs against the JAX package on the same
numpy inputs: ip through the ``knn_stream`` / ``knn_topk`` plain versions
and the brute lane, bf16 operands through the streaming kernel's plain
version, the fused dense and sparse engines in bf16 (exact after the fp32
rescore), and ``KNNIndex`` in ip, cosine and bf16 against the JAX index and
``tests/oracle.py`` (float64).

Tolerances: distances rtol 1e-5 / atol 1e-6 where both sides score fp32
operands in fp32, 1e-4 against float64 after the finalization; integer
outputs equal except for pairs within 1e-4 of the ε² threshold in
float64; ids equal except where the float64 scores tie."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from oracle import oracle_knn
from test_tiled_backend import _ids_match_mod_ties
from test_torch_core import _pyramids, _state
from test_torch_kernels import _assert_ids_mod_ties, _assert_ints_mod_boundary
from repro.core import brute as jax_brute
from repro.core import dense_join as jax_dense
from repro.core import sparse_knn as jax_sparse
from repro.kernels.knn_stream import ops as jax_stream_ops
from repro.kernels.knn_topk import ops as jax_topk_ops
from repro.retrieval import metrics as jax_metrics
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig
from repro_torch.core import brute as brute_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.retrieval import metrics as met_lib
from repro_torch.runtime import KNNIndex

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _ip_tie_free(q64, c64):
    """float64 −q·c of query row and candidate id, for the tie checks."""
    return lambda row, j: -(q64[row] @ c64[j])


def test_ip_stream_and_topk_plain_versions_match_jax_kernels():
    """−q·c, unclamped, through the contiguous streaming top-k (ε² a score
    threshold), the block-table one, and the exact top-k."""
    r = np.random.default_rng(21)
    q = r.normal(size=(200, 6)).astype(np.float32)
    c = r.normal(size=(700, 6)).astype(np.float32)
    qid, cid = np.arange(200, dtype=np.int32), np.arange(700, dtype=np.int32)
    cid[3] = -1
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    thr = -0.5
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid), jnp.asarray(cid),
        jnp.float32(thr), k=5, block_q=64, block_c=128, mode="interpret", metric="ip")
    kd1, ki1, f1 = stream_ops.knn_stream_topk(
        _t(q), _t(c), _t(qid), _t(cid), torch.tensor(thr), k=5, metric="ip")
    _assert_ints_mod_boundary(f1, f0, lambda row: -(c64[cid >= 0] @ q64[row]), thr)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    _assert_ids_mod_ties(ki1.numpy(), ki0, _ip_tie_free(q64, c64))
    assert (kd1.numpy() < 0).all()

    # block table: two tiles of 64 queries over a 6-block corpus
    corpus, queries = c[:768 - 68], q[:128]
    corpus = np.concatenate([corpus, r.normal(size=(68, 6)).astype(np.float32)])
    blk = np.array([[0, 2, 5], [1, 1, 4]], np.int32)
    cand = (blk[:, :, None] * 128 + np.arange(128)).reshape(2, -1).astype(np.int32)
    cand[:, ::7] = -1
    qids = np.arange(128, dtype=np.int32)
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk_prefetch(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(blk), jnp.asarray(qids),
        jnp.asarray(cand), jnp.float32(np.inf), k=4, block_q=64, block_c=128,
        mode="interpret", metric="ip")
    kd1, ki1, f1 = stream_ops.knn_stream_topk_prefetch(
        _t(queries), _t(corpus), _t(blk), _t(qids), _t(cand), torch.tensor(np.inf),
        k=4, block_q=64, block_c=128, metric="ip")
    np.testing.assert_array_equal(f1.numpy(), np.asarray(f0))
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    _assert_ids_mod_ties(ki1.numpy(), ki0, _ip_tie_free(
        queries.astype(np.float64), corpus.astype(np.float64)))

    kd0, ki0 = jax_topk_ops.knn_topk(jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid),
                                     jnp.asarray(cid), k=6, mode="interpret", metric="ip")
    kd1, ki1 = topk_ops.knn_topk(_t(q), _t(c), _t(qid), _t(cid), k=6, metric="ip")
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    _assert_ids_mod_ties(ki1.numpy(), ki0, _ip_tie_free(q64, c64))


def test_bf16_stream_plain_version_matches_jax_kernel():
    """bf16 queries and corpus through the block-table streaming top-k:
    the distances are fp32 functions of the bf16-cast values on both
    sides."""
    r = np.random.default_rng(23)
    corpus = r.normal(size=(512, 6)).astype(np.float32)
    queries = r.normal(size=(128, 6)).astype(np.float32)
    blk = np.array([[0, 3], [2, 1]], np.int32)
    cand = (blk[:, :, None] * 128 + np.arange(128)).reshape(2, -1).astype(np.int32)
    qids = np.arange(128, dtype=np.int32)
    eps2 = 3.0
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk_prefetch(
        jnp.asarray(queries, jnp.bfloat16), jnp.asarray(corpus, jnp.bfloat16),
        jnp.asarray(blk), jnp.asarray(qids), jnp.asarray(cand), jnp.float32(eps2),
        k=5, block_q=64, block_c=128, mode="interpret")
    qb, cb = _t(queries).to(torch.bfloat16), _t(corpus).to(torch.bfloat16)
    kd1, ki1, f1 = stream_ops.knn_stream_topk_prefetch(
        qb, cb, _t(blk), _t(qids), _t(cand), torch.tensor(eps2), k=5, block_q=64,
        block_c=128)
    q64, c64 = qb.double().numpy(), cb.double().numpy()
    _assert_ints_mod_boundary(
        f1, f0, lambda row: ((c64[cand[row // 64]] - q64[row]) ** 2).sum(-1), eps2)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=1e-5)
    _assert_ids_mod_ties(ki1.numpy(), ki0,
                         lambda row, j: ((c64[j] - q64[row]) ** 2).sum())


@pytest.mark.parametrize("k,budget,block_c,m", [(1, 1024, 128, 4), (5, 1024, 64, 4),
                                                (25, 2048, 128, 4)])
def test_dense_fused_bf16_matches_jax_and_is_exact(k, budget, block_c, m):
    """bf16 fused dense engine against the JAX one (interpret) — k = 25 takes
    the gathered fp32 route (k + 8 > 32) on both — and, after the rescore,
    against the fp32 engine: non-failed rows hold the same ids and exact
    fp32 distances."""
    pts_r, jg, tr, tg = _state(m=m)
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    kw = dict(k=k, budget=budget, block_c=block_c, backend="fused")
    jres = jax_dense.dense_join(jg, pts_r, jnp.asarray(qids), jnp.float32(0.25),
                                distance_dtype="bf16", **kw)
    tres = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.25),
                                distance_dtype="bf16", **kw)
    fp = dense_lib.dense_join(tg, tr, _t(qids), torch.tensor(0.25), **kw)
    np.testing.assert_array_equal(tres.total_candidates.numpy(),
                                  np.asarray(jres.total_candidates))
    # A failed flip needs a pair near the exact ε² (the rescore's cutoff) or,
    # in the bf16-cast values, near the inflated keep threshold.
    rows = np.nonzero(tres.failed.numpy() != np.asarray(jres.failed))[0]
    p64 = np.asarray(pts_r, np.float64)
    b64 = tr.to(torch.bfloat16).double().numpy()
    d2 = ((p64[rows, None] - p64[None]) ** 2).sum(-1)
    b2 = ((b64[rows, None] - b64[None]) ** 2).sum(-1)
    keep2 = 0.0625 * (1 + dense_lib.BF16_EPS_SLACK)
    assert ((np.abs(d2 - 0.0625) < 1e-4) | (np.abs(b2 - keep2) < 1e-4)).any(1).all()
    ok = ~tres.failed.numpy() & ~np.asarray(jres.failed) & ~fp.failed.numpy()
    assert ok.mean() > 0.5
    np.testing.assert_allclose(tres.dists.numpy()[ok], np.asarray(jres.dists)[ok],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tres.dists.numpy()[ok], fp.dists.numpy()[ok],
                               rtol=1e-4, atol=1e-5)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), fp.ids.numpy(), ok)
    _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids), ok)


def test_sparse_bf16_and_ip_match_jax():
    """Sparse engine: bf16 certifies on exact rescored distances, as JAX;
    under ip nothing is certified on either side."""
    pts_r, jp, tp = _pyramids()
    qids = np.arange(pts_r.shape[0], dtype=np.int32)
    for backend in ("fused", "pallas"):
        jres = jax_sparse.sparse_knn(jp, pts_r, jnp.asarray(qids), k=4, budget=512,
                                     backend="interpret" if backend == "pallas" else backend,
                                     distance_dtype="bf16")
        tres = sparse_lib.sparse_knn(tp, _t(pts_r), _t(qids), k=4, budget=512,
                                     backend=backend, distance_dtype="bf16")
        agree = tres.certified.numpy() == np.asarray(jres.certified)
        assert agree.mean() > 0.95 and tres.certified.numpy().any()
        np.testing.assert_allclose(tres.dists.numpy()[agree], np.asarray(jres.dists)[agree],
                                   rtol=RTOL, atol=ATOL)
        _ids_match_mod_ties(pts_r, tres.ids.numpy(), np.asarray(jres.ids),
                            np.asarray(jres.certified) & agree)
    jres = jax_sparse.sparse_knn(jp, pts_r, jnp.asarray(qids), k=4, backend="fused",
                                 metric="ip")
    tres = sparse_lib.sparse_knn(tp, _t(pts_r), _t(qids), k=4, backend="fused",
                                 metric="ip")
    assert not tres.certified.numpy().any() and not np.asarray(jres.certified).any()
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists),
                               rtol=RTOL, atol=ATOL)


def test_brute_ip_matches_jax_and_oracle():
    pts = make_mixture(300, 100, dim=6, seed=5)
    ids = np.arange(len(pts), dtype=np.int32)
    jd, ji = jax_brute.brute_knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(ids),
                                 k=4, corpus_chunk=96, kernel_mode="interpret",
                                 metric="ip")
    td, ti = brute_lib.brute_knn(_t(pts), _t(pts), _t(ids), k=4, corpus_chunk=96,
                                 metric="ip")
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    od, _ = oracle_knn(pts, k=4, exclude_self=True, metric="ip")
    np.testing.assert_allclose(td.numpy(), od, rtol=1e-5, atol=1e-5)
    p64 = pts.astype(np.float64)
    _assert_ids_mod_ties(ti.numpy(), np.asarray(ji), _ip_tie_free(p64, p64))


def test_metric_helpers_match_jax():
    r = np.random.default_rng(2)
    raw = r.normal(size=(50, 7)).astype(np.float32)
    raw[3] = 0.0
    np.testing.assert_array_equal(met_lib.normalize_rows(raw),
                                  jax_metrics.normalize_rows(raw))
    unit = met_lib.normalize_rows(raw[np.arange(50) != 3])
    assert met_lib.unit_rows_ok(unit) and not met_lib.unit_rows_ok(raw)
    scores = np.array([[-2.0, 0.5, np.inf]], np.float32)
    for metric in met_lib.METRICS:
        assert met_lib.kernel_metric(metric) == jax_metrics.kernel_metric(metric)
        np.testing.assert_array_equal(met_lib.finalize(scores, metric),
                                      jax_metrics.finalize(scores, metric))
    with pytest.raises(ValueError, match="normalize_rows"):
        met_lib.prepare_rows(raw, "cosine", "queries")
    with pytest.raises(ValueError, match="unknown metric"):
        HybridConfig(k=3, metric="hamming")
    np.testing.assert_array_equal(met_lib.prepare_rows(raw, "ip", "queries"), raw)


def _db():
    return make_mixture(420, 180, dim=6, seed=31)


def _foreign(n=135, dim=6, seed=41):
    r = np.random.default_rng(seed)
    near = (0.05 * r.normal(size=(n - n // 3, dim))).astype(np.float32)
    far = r.uniform(3.0, 6.0, (n // 3, dim)).astype(np.float32)
    return np.concatenate([near, far]).astype(np.float32)


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_index_metric_matches_jax_and_oracle(metric):
    """ip and cosine ``KNNIndex`` (R≠S and self-join) against the JAX index
    on its fused backend and the float64 oracle in that metric; every ip
    query serves through the brute lane (source 2)."""
    db, q = _db(), _foreign()
    if metric == "cosine":
        db, q = met_lib.normalize_rows(db), met_lib.normalize_rows(q)
    base = dict(k=5, m=4, gamma=0.3, rho=0.15, metric=metric, online_rebalance=False)
    jidx = JaxIndex.build(db, jax_hybrid.HybridConfig(backend="fused", **base), 0.3)
    tidx = KNNIndex.build(db, HybridConfig(backend="fused", **base), 0.3, device="cpu")
    for queries in (q, None):
        jr = jidx.query(queries, exclude_self=queries is None)
        tr = tidx.query(queries, exclude_self=queries is None)
        np.testing.assert_array_equal(tr.source, jr.source)
        np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)
        want, _ = oracle_knn(db, queries, k=5, exclude_self=queries is None,
                             metric=metric)
        np.testing.assert_allclose(tr.dists, want, rtol=1e-4, atol=1e-4)
        if metric == "ip":
            assert (tr.source == 2).all() and (tr.dists < 0).any()
        else:
            assert (tr.source < 2).any()
    with pytest.raises(ValueError, match="normalize_rows"):
        KNNIndex.build(_db(), HybridConfig(k=5, metric="cosine"), 0.3, device="cpu")


def test_index_bf16_matches_jax_and_oracle():
    """A bf16 fused index answers R≠S queries exactly after the rescore,
    as the JAX bf16 index does, and keeps its own engine bucket."""
    db, q = _db(), _foreign()
    base = dict(k=5, m=4, gamma=0.3, rho=0.15, n_batches=2, online_rebalance=False,
                backend="fused")
    jr = JaxIndex.build(db, jax_hybrid.HybridConfig(distance_dtype="bf16", **base),
                        0.3).query(q)
    fp_idx = KNNIndex.build(db, HybridConfig(**base), 0.3, device="cpu")
    fp_idx.query(q)
    idx = KNNIndex.build(db, dataclasses.replace(HybridConfig(**base),
                                                 distance_dtype="bf16"), 0.3, device="cpu")
    tr = idx.query(q)
    assert idx.compile_counts["dense"] >= 1, "bf16 must not share the fp32 bucket"
    np.testing.assert_array_equal(tr.source, jr.source)
    np.testing.assert_allclose(tr.dists, jr.dists, rtol=1e-5, atol=1e-5)
    want, _ = oracle_knn(db, q, k=5)
    np.testing.assert_allclose(tr.dists, want, atol=1e-4)
    got = np.linalg.norm(q[:, None, :].astype(np.float64) - db[tr.ids], axis=-1)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (tr.source == 0).any()
