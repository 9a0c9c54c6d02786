"""Wide rows through the port: the kernel ops at 518 dims (the paper's
FMA width) and at 1,100 dims against the JAX kernels in interpret mode, the
host-side plans of the d-chunked kernels, and a small FMA-shaped index
through ``KNNIndex`` in both packages.

Parity contract (as in ``test_torch_kernels.py``): integer outputs equal
except ε²/bin-edge flips (checked in float64), ids equal except where
distances tie, distances to fp32 tolerance.  At these widths that tolerance
is the fp32 error bound of the expansion form |q|² + |c|² − 2q·c that the
JAX kernels compute, 2·(D+4)·u·(|q|+|c|)² per pair (u = 2⁻²⁴; the port's
plain versions use the difference form): it is what a flip or a tie is
measured against too.  The index test compares the two packages' plain
port's plain path (the difference form) with the float64 oracle within
rtol 1e-5 / atol 1e-5, and the JAX package's within that bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from repro.kernels.bin_hist import ops as jax_hist_ops
from repro.kernels.knn_stream import ops as jax_stream_ops
from repro.kernels.knn_topk import ops as jax_topk_ops
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig
from repro_torch.data import pointclouds
from repro_torch.kernels import _build
from repro_torch.kernels.bin_hist import kernel as hist_kernel
from repro_torch.kernels.bin_hist import ops as hist_ops
from repro_torch.kernels.knn_stream import kernel as stream_kernel
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.kernels.knn_topk import kernel as topk_kernel
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.runtime import KNNIndex

RTOL, ATOL = 1e-5, 1e-5
WIDTHS = [518, 1100]
U = 2.0 ** -24


def _t(a):
    return torch.as_tensor(np.array(a))


def _d2(q, c):
    """(Q, C) squared distances in float64 (the expansion, exact far below
    the fp32 bounds used here; no (Q, C, D) temporary)."""
    q, c = q.astype(np.float64), c.astype(np.float64)
    return np.maximum((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :] - 2.0 * q @ c.T, 0.0)


def _bound(q, c):
    """(Q, C) fp32 bound of the expansion form for rows q against rows c."""
    qn = np.linalg.norm(q.astype(np.float64), axis=1)[:, None]
    cn = np.linalg.norm(c.astype(np.float64), axis=1)[None, :]
    return 2.0 * (q.shape[1] + 4) * U * (qn + cn) ** 2


def _assert_topk_parity(kd1, ki1, kd0, ki0, d2, bound):
    """Port (kd1, ki1) against JAX (kd0, ki0): the inf pattern equal, each
    squared distance within the bound of the pair JAX reports, and every id
    mismatch a float64 tie within the bound."""
    kd1, ki1 = np.asarray(kd1), np.asarray(ki1)
    kd0, ki0 = np.asarray(kd0), np.asarray(ki0)
    fin = np.isfinite(kd0)
    np.testing.assert_array_equal(np.isfinite(kd1), fin)
    rows = np.arange(kd0.shape[0])[:, None]
    allow = bound[rows, np.maximum(ki0, 0)]
    gap = np.abs(np.where(fin, kd1, 0.0) - np.where(fin, kd0, 0.0))
    assert (gap <= allow).all(), gap.max()
    for r, c in zip(*np.nonzero(ki1 != ki0)):
        assert abs(d2[r, ki1[r, c]] - d2[r, ki0[r, c]]) <= bound[r, ki0[r, c]], (r, c)


def _cloud(r, n, dim):
    """Clustered rows in [0, 1] with low-variance tail dims, like FMA."""
    centers = r.uniform(0.2, 0.8, size=(4, dim))
    x = centers[r.integers(0, 4, size=n)] + r.normal(0, 0.05, size=(n, dim))
    x[:, dim // 8:] *= 0.02
    return x.astype(np.float32)


@pytest.mark.parametrize("dim", WIDTHS)
def test_knn_topk_wide_matches_jax_kernel(dim):
    r = np.random.default_rng(dim)
    q = _cloud(r, 130, dim)
    c = np.concatenate([q[:20], _cloud(r, 380, dim)])
    qid = np.arange(130, dtype=np.int32)
    cid = np.arange(400, dtype=np.int32)
    cid[7] = -1
    kd0, ki0 = jax_topk_ops.knn_topk(jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid),
                                     jnp.asarray(cid), k=25, mode="interpret")
    kd1, ki1 = topk_ops.knn_topk(_t(q), _t(c), _t(qid), _t(cid), k=25)
    _assert_topk_parity(kd1, ki1, kd0, ki0, _d2(q, c), _bound(q, c))
    assert not (ki1.numpy()[:20] == np.arange(20)[:, None]).any()
    assert not (ki1.numpy() == 7).any()


@pytest.mark.parametrize("dim", WIDTHS)
def test_knn_stream_prefetch_wide_matches_jax_kernel(dim):
    """The block-table kernel at FMA width and above, 30 % masked rows."""
    r = np.random.default_rng(dim + 1)
    block_q, block_c, n_tiles, nblk, n_cb, k = 64, 128, 2, 3, 5, 25
    corpus = _cloud(r, n_cb * block_c, dim)
    queries = np.concatenate([corpus[:block_q], _cloud(r, block_q, dim)])
    blk = r.integers(0, n_cb, size=(n_tiles, nblk)).astype(np.int32)
    rows = blk[:, :, None] * block_c + np.arange(block_c)
    cand = rows.reshape(n_tiles, -1).astype(np.int32)
    cand[r.random(cand.shape) < 0.3] = -1
    qid = np.arange(n_tiles * block_q, dtype=np.int32)
    d2, bound = _d2(queries, corpus), _bound(queries, corpus)
    eps2 = float(np.median(d2))
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk_prefetch(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(blk), jnp.asarray(qid),
        jnp.asarray(cand), jnp.float32(eps2), k=k, block_q=block_q, block_c=block_c,
        mode="interpret")
    kd1, ki1, f1 = stream_ops.knn_stream_topk_prefetch(
        _t(queries), _t(corpus), _t(blk), _t(qid), _t(cand), torch.tensor(eps2),
        k=k, block_q=block_q, block_c=block_c)
    f0, f1 = np.asarray(f0), f1.numpy()
    for row in np.nonzero(f1 != f0)[0]:
        ids = cand[row // block_q]
        ids = ids[ids >= 0]
        assert (np.abs(d2[row, ids] - eps2) <= bound[row, ids]).any(), row
    same = f1 == f0
    assert same.mean() > 0.9 and (f1 > 0).any()
    _assert_topk_parity(kd1.numpy()[same], ki1.numpy()[same], np.asarray(kd0)[same],
                        np.asarray(ki0)[same], d2[same], bound[same])


@pytest.mark.parametrize("dim", WIDTHS)
def test_knn_stream_padded_wide_matches_jax_kernel(dim):
    """The contiguous (identity-table) kernel at FMA width and above."""
    r = np.random.default_rng(dim + 2)
    q = _cloud(r, 90, dim)
    c = np.concatenate([q[:30], _cloud(r, 170, dim)])
    qid = np.arange(90, dtype=np.int32)
    cid = np.arange(200, dtype=np.int32)
    cid[11] = -1
    d2, bound = _d2(q, c), _bound(q, c)
    eps2 = float(np.quantile(d2, 0.3))
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid), jnp.asarray(cid),
        jnp.float32(eps2), k=16, block_q=64, block_c=128, mode="interpret")
    kd1, ki1, f1 = stream_ops.knn_stream_topk(
        _t(q), _t(c), _t(qid), _t(cid), torch.tensor(eps2), k=16)
    f0, f1 = np.asarray(f0), f1.numpy()
    for row in np.nonzero(f1 != f0)[0]:
        assert (np.abs(d2[row, cid >= 0] - eps2) <= bound[row, cid >= 0]).any(), row
    same = f1 == f0
    assert same.mean() > 0.9 and (f1 > 0).any()
    _assert_topk_parity(kd1.numpy()[same], ki1.numpy()[same], np.asarray(kd0)[same],
                        np.asarray(ki0)[same], d2[same], bound[same])


@pytest.mark.parametrize("dim", WIDTHS)
def test_bin_hist_wide_matches_jax_kernel(dim):
    """Counts equal except pairs within a few ulp of a bin edge."""
    r = np.random.default_rng(dim + 3)
    pts = _cloud(r, 600, dim)
    qidx = r.integers(0, 600, size=40).astype(np.int32)
    d = np.sqrt(_d2(pts[qidx], pts))
    bw, n_bins = np.float32(np.median(d) / 64), 64
    c0 = jax_hist_ops.distance_bin_histogram(
        jnp.asarray(pts[qidx]), jnp.asarray(pts), jnp.float32(bw), n_bins,
        self_indices=jnp.asarray(qidx), mode="interpret")
    c1 = hist_ops.distance_bin_histogram(_t(pts[qidx]), _t(pts), torch.tensor(bw), n_bins,
                                         self_indices=_t(qidx))
    diff = np.abs(c1.numpy() - np.asarray(c0))
    # A pair can change bins only within the fp32 error of d of a bin edge:
    # the expansion's bound e2 on d², so min(e2 / d, √e2) on d, plus a few
    # ulp of d for the root and the divide.
    e2 = _bound(pts[qidx], pts)
    window = np.minimum(e2 / np.maximum(d, 1e-30), np.sqrt(e2)) + (dim + 8) * U * d
    edge = np.round(d / float(bw)) * float(bw)
    near_edge = int((np.abs(d - edge) < window).sum())
    assert diff.sum() <= 2 * near_edge, (diff.sum(), near_edge)
    assert c1.sum() > 1000


# -- host-side plans of the d-chunked kernels -----------------------------------

def _covers_once(chunks, dim):
    seen = np.zeros(dim, dtype=int)
    for d0, n in chunks:
        assert n >= 1
        seen[d0:d0 + n] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("width", [topk_kernel.CHUNK_D, stream_kernel.CHUNK_D,
                                   hist_kernel.CHUNK_D])
def test_d_chunk_plan_covers_every_dim_once(width):
    for dim in range(1, 1025):
        chunks = _build.d_chunks(dim, width)
        assert _covers_once(chunks, dim), dim
        assert [d0 for d0, _ in chunks] == list(range(0, dim, width))
        assert all(n == width for _, n in chunks[:-1])


def test_smem_plans_fit_at_every_width():
    """No width is refused on shared-memory grounds: the top-k and
    histogram plans have no width term and fit one H100 block at every k
    and at the main path's 256 bins (two blocks share an SM)."""
    lim = _build.SMEM_LIMIT
    for k in range(1, topk_kernel.MAX_UNROLLED_K + 1):
        assert topk_kernel.smem_bytes(k) <= lim      # no width term at all
        assert stream_kernel.smem_bytes(k) <= lim
    # two blocks of the widest top-k plans share one SM (228 KB)
    assert 2 * (topk_kernel.smem_bytes(32) + 1024) <= 228 * 1024
    assert 2 * (stream_kernel.smem_bytes(32) + 1024) <= 228 * 1024
    for n_bins in range(1, 1025):
        assert hist_kernel.smem_bytes(n_bins) <= lim, n_bins
    assert 2 * (hist_kernel.smem_bytes(256) + 1024) <= 228 * 1024
    # the histogram plan: two double-buffered 8-dim chunks of 128 rows
    # (stride 132) for queries and points, 3 × 128 norms and ids, and one
    # int sub-histogram per warp
    assert hist_kernel.smem_bytes(256) == 4 * (4 * 8 * 132 + 3 * 128 + 8 * 256)


@pytest.mark.parametrize("n_q,n_c", [(4096, 5_000_000), (65_536, 5_000_000),
                                     (107_000, 107_000), (1, 300), (700, 129),
                                     (20_000, 107_000)])
def test_split_plan_tiles_every_candidate_once(n_q, n_c):
    """Splits × 128-candidate tiles cover every candidate column exactly
    once, in order, and give every SM a block when the candidates allow."""
    n_splits, per_split = topk_kernel.split_plan(n_q, n_c, topk_kernel.TILE_Q, 256, 132)
    assert per_split % topk_kernel.TILE_C == 0
    seen = np.zeros(n_c, dtype=np.int8)
    last = -1
    for s in range(n_splits):
        c_begin, c_end = s * per_split, min(n_c, (s + 1) * per_split)
        assert c_begin < c_end
        for c0 in range(c_begin, c_end, topk_kernel.TILE_C):
            c1 = min(c0 + topk_kernel.TILE_C, c_end)
            assert c0 > last
            seen[c0:c1] += 1
            last = c1 - 1
    assert (seen == 1).all()
    tiles = -(-n_q // topk_kernel.TILE_Q)
    assert n_splits * tiles >= min(132, -(-n_c // 256) * tiles)


# -- an FMA-shaped index through both packages -----------------------------------

def test_fma_width_slice_matches_jax_and_oracle():
    """2,048 × 518 FMA-shaped rows, K = 25, ε pinned: routing, found /
    failed, ids and distances of the port's fused path against the JAX
    package's and against float64 (every engine runs: dense, failed dense,
    sparse, uncertified sparse)."""
    pts = pointclouds.load("fma", n_override=2048)
    kw = dict(k=25, m=6, gamma=0.4, rho=0.2, online_rebalance=False)
    eps = 0.95
    jidx = JaxIndex.build(pts, jax_hybrid.HybridConfig(backend="fused", **kw), eps)
    tidx = KNNIndex.build(pts, HybridConfig(backend="fused", **kw), eps, device="cpu")
    np.testing.assert_array_equal(tidx.dim_perm.numpy(), np.asarray(jidx.dim_perm))
    np.testing.assert_array_equal(tidx.home_counts, jidx.home_counts)
    jr, tr = jidx.query(exclude_self=True), tidx.query(exclude_self=True)
    for f in ("n_dense", "n_sparse", "n_failed", "n_uncertified", "batch_sizes",
              "n_sparse_rounds", "n_sparse_engine_total"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    np.testing.assert_array_equal(tr.source, jr.source)
    # The port's plain path scores in the difference form: float64-exact to
    # fp32 rounding.  The JAX path's expansion form is held to its bound.
    d2 = _d2(pts, pts)
    np.fill_diagonal(d2, np.inf)
    od = np.sqrt(np.sort(d2, axis=1)[:, :25])
    np.testing.assert_allclose(tr.dists, od, rtol=RTOL, atol=ATOL)
    got = np.sqrt(np.take_along_axis(d2, tr.ids.astype(np.int64), axis=1))
    np.testing.assert_allclose(got, od, rtol=RTOL, atol=ATOL)
    _assert_topk_parity(tr.dists.astype(np.float64) ** 2, tr.ids,
                        jr.dists.astype(np.float64) ** 2, jr.ids, d2, _bound(pts, pts))
    assert tr.stats.n_dense > 0 and tr.stats.n_sparse > 0 and tr.stats.n_failed > 0
