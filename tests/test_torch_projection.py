"""The projection front stage of the PyTorch port (``retrieval/projection.py``
and ``KNNIndex``'s projected path: the exact pipeline in projected space at
the calibrated candidate-pool size, then the full-dimension ``"rescore"``
engine) against the JAX package on the same seeded numpy inputs, following
``tests/test_projection_front.py``'s plans.

The fit and ``apply`` are numpy in both packages, so they must agree bit
for bit.  Both indexes are built with ε pinned, so their projected grids
are equal, and each must pick the same rung with the same
``recall_estimate``.  Tolerance: distances within 1e-5 (relative, and
absolute for values below 1) of the JAX package's; ids equal except where
the float64 true-metric scores of the two ids tie within 1e-5; each
returned distance is its id's float64 true-metric score within 1e-4."""
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from oracle import oracle_knn
from test_projection_front import _lowrank
from repro.retrieval import projection as jax_proj
from repro.runtime import KNNIndex as JaxIndex
from repro.runtime import knn_index as jax_ki
from repro_torch.core import HybridConfig
from repro_torch.retrieval import Projection
from repro_torch.retrieval import projection as proj_lib
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import KNNIndex, knn_index

TOL = 1e-5
EPS = 4.0               # the projected grid's ε, pinned in both packages
PTS = _lowrank(n=800, seed=4)
QUERIES = _lowrank(n=90, seed=5)


def _cfg(**kw):
    base = dict(k=6, m=3, gamma=0.0, rho=0.2, online_rebalance=False,
                projection_dim=5, recall_target=0.9)
    base.update(kw)
    return base


def _pair(backend="fused", jax_backend=None, **kw):
    j = JaxIndex.build(PTS, jax_hybrid.HybridConfig(backend=jax_backend or backend,
                                                     **_cfg(**kw)), EPS)
    t = KNNIndex.build(PTS, HybridConfig(backend=backend, **_cfg(**kw)), EPS, device="cpu")
    return j, t


def _realized(queries, ids, metric):
    q = np.asarray(queries, np.float64)
    c = PTS.astype(np.float64)[ids]
    if metric == "ip":
        return -(q[:, None, :] * c).sum(-1)
    return np.sqrt(((q[:, None, :] - c) ** 2).sum(-1))


def _hold(tr, jr, queries, metric):
    np.testing.assert_allclose(tr.dists, np.asarray(jr.dists), rtol=TOL, atol=TOL)
    assert tr.recall_estimate == jr.recall_estimate
    np.testing.assert_array_equal(tr.source, np.asarray(jr.source))
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    jids = np.asarray(jr.ids)
    rt, rj = _realized(queries, tr.ids, metric), _realized(queries, jids, metric)
    differ = tr.ids != jids
    np.testing.assert_allclose(rt[differ], rj[differ], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.dists, rt, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mips", [False, True])
@pytest.mark.parametrize("kind", ["pca", "random"])
def test_fit_and_apply_bit_identical_to_jax(kind, mips):
    pts = _lowrank(n=5000, d=16, seed=1)      # past the PCA fit-sample cap
    p = proj_lib.fit_projection(pts, 6, kind=kind, seed=3, mips=mips)
    want = jax_proj.fit_projection(pts, 6, kind=kind, seed=3, mips=mips)
    assert isinstance(p, Projection) and p.kind == want.kind
    np.testing.assert_array_equal(p.matrix, want.matrix)
    np.testing.assert_array_equal(p.mean, want.mean)
    assert p.mips_m == want.mips_m and (p.mips_m > 0) == mips
    assert (p.in_dim, p.out_dim) == (want.in_dim, want.out_dim) == (16, 6)
    q = _lowrank(n=40, d=16, seed=2)
    for rows, corpus in ((pts, True), (q, False)):
        np.testing.assert_array_equal(p.apply(rows, corpus=corpus),
                                      want.apply(rows, corpus=corpus))


def test_fit_rejects_bad_dims_and_kind():
    pts = _lowrank(n=50, d=8)
    for m in (8, 0):
        with pytest.raises(ValueError, match="1 <= m < corpus dim"):
            proj_lib.fit_projection(pts, m)
    with pytest.raises(ValueError, match="unknown projection kind"):
        proj_lib.fit_projection(pts, 4, kind="umap")
    with pytest.raises(ValueError, match="projection expects"):
        proj_lib.fit_projection(pts, 4).apply(pts[:, :5])


# ---------------------------------------------------------------------------
# the projected index against the JAX package
# ---------------------------------------------------------------------------

# (metric, projection_dim, recall_target, the rung both must calibrate to;
# None = no rung met the target: exact full-dimension brute, estimate 1.0).
CASES = {
    "l2-rung1": ("l2", 5, 0.9, 1),       # dense, sparse, failures, brute backstop
    "l2-rung4": ("l2", 4, 0.97, 4),      # k_cand = 24
    "ip-rung1": ("ip", 6, 0.9, 1),       # the MIPS fit
    "ip-fallback": ("ip", 4, 0.9, None),
}
BACKENDS = [("ref", "ref"), ("fused", "fused"), ("pallas", "interpret")]


@pytest.mark.parametrize("case,backend,jax_backend",
                         [("l2-rung1",) + b for b in BACKENDS] + [("ip-rung1", "fused", "fused")])
def test_projected_index_matches_jax(case, backend, jax_backend):
    metric, pdim, target, rung = CASES[case]
    j, t = _pair(backend, jax_backend, metric=metric, projection_dim=pdim,
                 recall_target=target)
    np.testing.assert_array_equal(t.points_r.numpy(), np.asarray(j.points_r))
    np.testing.assert_array_equal(t.home_counts, j.home_counts)
    assert t.n_dims == 32 and t.projection.out_dim == pdim
    jr, tr = j.query(QUERIES), t.query(QUERIES)
    assert t._live[0].calib == j._live[0].calib
    assert t._live[0].calib[("proj", 6, target)][0] == rung
    _hold(tr, jr, QUERIES, metric)
    js, ts = j.query(exclude_self=True), t.query(exclude_self=True)
    _hold(ts, js, PTS, metric)
    assert not (ts.ids == np.arange(len(PTS))[:, None]).any()
    if case == "l2-rung1":
        s = ts.stats
        assert s.n_dense > 0 and s.n_sparse > 0 and s.n_failed > 0 and s.n_uncertified > 0
        assert ts.stats.t_merge > 0


@pytest.mark.parametrize("case", ["l2-rung4", "ip-fallback"])
def test_projected_rungs_and_fallback_match_jax(case):
    metric, pdim, target, rung = CASES[case]
    j, t = _pair(metric=metric, projection_dim=pdim, recall_target=target)
    jr, tr = j.query(QUERIES), t.query(QUERIES)
    assert t._live[0].calib == j._live[0].calib
    assert t._live[0].calib[("proj", 6, target)][0] == rung
    _hold(tr, jr, QUERIES, metric)
    if rung is None:
        # Exact full-dimension brute: the float64 oracle's answer.
        assert tr.recall_estimate == 1.0 and (tr.source == 2).all()
        want_d, _ = oracle_knn(PTS, QUERIES, k=6, metric=metric)
        np.testing.assert_allclose(tr.dists, want_d, rtol=1e-4, atol=1e-4)


def test_projected_repeat_adds_no_bucket():
    """Calibration is cached on the generation: a same-bucket repeat
    re-measures nothing and adds no bucket, ``"rescore"`` and the
    full-width ``"brute"`` included."""
    knn_index.clear_engine_cache()
    t = KNNIndex.build(PTS, HybridConfig(backend="fused", **_cfg()), EPS, device="cpu")
    first = t.query(QUERIES)
    assert first.stats.n_engine_compiles > 0
    # The calibration sample's 128 rows and the 90-row batch share one
    # pow2 bucket.
    assert t.compile_counts["rescore"] == 1
    assert t.compile_counts["brute"] >= 2       # full-width reference, projected lane
    counts = dict(t.compile_counts)
    again = t.query(QUERIES[:70])
    assert again.stats.n_engine_compiles == 0 and t.compile_counts == counts
    assert again.recall_estimate == first.recall_estimate
    np.testing.assert_array_equal(again.ids, first.ids[:70])


def test_projected_save_load_bit_identical(tmp_path):
    t = KNNIndex.build(PTS, HybridConfig(backend="fused", **_cfg(metric="ip",
                                                                  projection_dim=6)),
                       EPS, device="cpu")
    want = t.query(QUERIES)
    t.save(str(tmp_path))
    loaded = KNNIndex.load(str(tmp_path), device="cpu")
    assert loaded.projection.mips_m == t.projection.mips_m > 0
    np.testing.assert_array_equal(loaded.projection.matrix, t.projection.matrix)
    got = loaded.query(QUERIES)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    assert got.recall_estimate == want.recall_estimate


# ---------------------------------------------------------------------------
# the rescore engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_rescore_matches_jax_engine_and_ignores_chunking(metric):
    """The rescore against the reference's ``_rescore_engine`` on pools with
    −1 padding, the excluded id and duplicate corpus rows (exact score ties,
    kept in pool order): ids equal, scores within 1e-5; two chunk sizes
    give bit-identical answers."""
    r = np.random.default_rng(0)
    corpus = r.normal(size=(200, 40)).astype(np.float32)
    corpus[100:110] = corpus[0:10]                 # duplicate rows tie exactly
    q = r.normal(size=(33, 40)).astype(np.float32)
    cand = r.choice(200, size=(33, 24)).astype(np.int32)
    cand[:, 3] = np.arange(33) % 10
    cand[:, 4] = cand[:, 3] + 100
    cand[::4, 7:12] = -1
    excl = np.arange(33, dtype=np.int32)
    excl[1::2] = -2
    want_d, want_i = jax_ki._rescore_engine(corpus, q, cand, excl, k=8, metric=metric)
    t = [torch.as_tensor(a) for a in (corpus, q, cand, excl)]
    d1, i1 = knn_index.rescore_topk(*t, k=8, metric=metric)
    d2, i2 = knn_index.rescore_topk(*t, k=8, metric=metric, chunk_bytes=24 * 40 * 4 * 5)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(d1.numpy(), np.asarray(want_d), rtol=TOL, atol=TOL)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    assert not (i1.numpy() == np.where(excl >= 0, excl, -5)[:, None]).any()


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_projected_index_rejects_mutation_mesh_and_wrong_width():
    t = KNNIndex.build(PTS[:200], HybridConfig(k=3, projection_dim=4), device="cpu")
    with pytest.raises(ValueError, match="projection-fronted"):
        t.insert(PTS[:5])
    with pytest.raises(ValueError, match="projection-fronted"):
        t.delete([0, 1])
    with pytest.raises(ValueError, match="projection"):
        KNNIndex.build(PTS[:200], HybridConfig(k=3, projection_dim=4), device="cpu",
                       mesh=object())
    with pytest.raises(ValueError, match="projection"):
        KNNIndex.build(PTS[:200], HybridConfig(k=3, projection_dim=4),
                       mesh=make_serving_mesh(2, device="cpu"))
    with pytest.raises(TypeError, match="got object"):
        KNNIndex.build(PTS[:200], HybridConfig(k=3), device="cpu", mesh=object())
    with pytest.raises(ValueError, match="32"):
        t.query(PTS[:5, :4])
    assert t.query(PTS[:5]).ids.shape == (5, 3)
    with pytest.raises(ValueError, match="projection_dim"):
        HybridConfig(k=3, projection_dim=9)
