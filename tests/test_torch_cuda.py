"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and nvcc (the kernels are built on first
use) and is marked ``cuda``; without a card the ``card`` fixture skips it.
Run them on the card with

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Inputs come from numpy with a seed.  Tolerance: the kernels score squared
L2 in the expansion form |q|² + |c|² − 2q·c, the plain versions in the
difference form, so a score may differ by the expansion's fp32 bound
(D + 4)·u·(|q| + |c|)² (u = 2⁻²⁴); two ids may differ only where their
float64 scores lie within that bound of each other, and a found count only
where a pair lies within it of ε².  On small-integer data every score is
exact in both forms, and there ids must agree exactly: that checks the tie
rule (equal scores, lowest candidate column first)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.bin_hist import kernel as hist_kernel
from repro_torch.kernels.bin_hist import ref as hist_ref
from repro_torch.kernels.knn_stream import kernel as stream_kernel
from repro_torch.kernels.knn_stream import ref as stream_ref
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.kernels.knn_topk import ref as topk_ref

pytestmark = pytest.mark.cuda

U = 2.0 ** -24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _allow(q, c):
    """Per-pair fp32 bound of the expansion form, (Q, C) in float64."""
    dim = q.shape[1]
    qn = q.double().norm(dim=1)[:, None]
    cn = c.double().norm(dim=1)[None, :]
    return 2.0 * (dim + 4) * U * (qn + cn) ** 2


def _score64(q, c, metric):
    q, c = q.double(), c.double()
    if metric == "ip":
        return -(q @ c.T)
    return ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def _hold(kd, ki, rd, ri, q, cands_of_id, metric, exact=False):
    """Kernel (kd, ki) against plain (rd, ri) for queries ``q``;
    ``cands_of_id`` maps ids to candidate rows."""
    assert torch.equal(torch.isfinite(kd), torch.isfinite(rd)), "inf pattern"
    fin = torch.isfinite(rd)
    if exact:
        assert torch.equal(ki, ri), "ids differ on exact data"
        assert torch.equal(kd[fin], rd[fin])
        return
    rows = torch.arange(q.shape[0], device=q.device)[:, None].expand_as(ki)
    got = ki.clamp(min=0).long()
    want = ri.clamp(min=0).long()
    c_got = cands_of_id(got.reshape(-1)).reshape(*got.shape, -1)
    c_want = cands_of_id(want.reshape(-1)).reshape(*want.shape, -1)
    qq = q.double()[rows]
    if metric == "ip":
        s_got = -(qq * c_got.double()).sum(-1)
        s_want = -(qq * c_want.double()).sum(-1)
    else:
        s_got = ((qq - c_got.double()) ** 2).sum(-1)
        s_want = ((qq - c_want.double()) ** 2).sum(-1)
    dim = q.shape[1]
    allow = 2.0 * (dim + 4) * U * (q.double().norm(dim=1)[:, None]
                                   + c_want.double().norm(dim=-1)) ** 2
    assert ((kd.double() - rd.double()).abs() <= allow)[fin].all(), "scores"
    assert ((s_got - s_want).abs() <= 2 * allow)[fin].all(), "an id mismatch is not a tie"


def _topk_case(rng, n_q, n_c, dim, integer):
    if integer:
        q = rng.integers(-3, 4, size=(n_q, dim)).astype(np.float32)
        c = rng.integers(-3, 4, size=(n_c, dim)).astype(np.float32)
    else:
        q = rng.normal(size=(n_q, dim)).astype(np.float32)
        c = rng.normal(size=(n_c, dim)).astype(np.float32)
    m = min(n_q, n_c) // 2
    c[:m] = q[:m]                               # self pairs at d = 0
    dup = min(40, n_c - 2 * m)
    c[2 * m: 2 * m + dup] = c[:dup]             # exact duplicate candidates
    cid = np.arange(n_c, dtype=np.int32)
    cid[rng.random(n_c) < 0.05] = -1
    cid[n_c // 2: n_c // 2 + 5] = -1
    qid = np.arange(n_q, dtype=np.int32)
    qid[-3:] = -1
    return q, c, qid, cid


@pytest.mark.parametrize("n_q,n_c,dim,k,metric,integer", [
    (300, 5000, 18, 25, "l2", False),
    (130, 7000, 518, 25, "l2", False),
    (200, 3000, 1100, 8, "ip", False),
    (5, 90_000, 18, 16, "l2", False),        # many splits, merged in order
    (129, 2000, 40, 32, "l2", True),
    (260, 4000, 7, 3, "ip", True),
    (64, 30, 18, 25, "l2", False),           # fewer valid candidates than k
    (300, 20_000, 6, 10, "l2", False),       # the projected brute backstop's width
    (129, 3000, 6, 20, "l2", True),
    # the kNN-LM's lookups: olmo_1b's 2,048-wide hidden states, k = 8, over
    # a datastore that ends in a ragged tile
    (5, 65_573, 2048, 8, "l2", False),
    (5, 65_573, 2048, 8, "ip", False),
])
def test_knn_tile_topk_matches_plain(card, n_q, n_c, dim, k, metric, integer):
    rng = np.random.default_rng(n_q + n_c + dim + k)
    q, c, qid, cid = (torch.as_tensor(x, device=card)
                      for x in _topk_case(rng, n_q, n_c, dim, integer))
    kd, ki = topk_ops.knn_topk(q, c, qid, cid, k=k, metric=metric)
    rd, ri = topk_ref.knn_topk_ref(q, c, qid, cid, k=k, metric=metric)
    torch.cuda.synchronize()
    _hold(kd, ki, rd, ri, q, lambda i: c[i], metric, exact=integer)
    assert not ((ki == qid[:, None]) & (ki >= 0)).any(), "self pair returned"


def _stream_case(rng, dim, n_tiles, nblk, n_cb, block_q=128, block_c=128, integer=False):
    def draw(shape):
        if integer:
            return rng.integers(-2, 3, size=shape).astype(np.float32)
        return (rng.normal(size=shape) * 0.3).astype(np.float32)
    corpus = draw((n_cb * block_c, dim))
    queries = draw((n_tiles * block_q, dim))
    corpus[:block_q] = queries[:block_q]
    blk = rng.integers(0, n_cb, size=(n_tiles, nblk)).astype(np.int32)
    rows = blk[:, :, None] * block_c + np.arange(block_c)
    cand = rows.reshape(n_tiles, -1).astype(np.int32)
    cand[rng.random(cand.shape) < 0.3] = -1
    cand[:, block_c: 2 * block_c] = -1          # one empty slot per tile
    qid = np.arange(n_tiles * block_q, dtype=np.int32)
    return queries, corpus, blk, qid, cand


@pytest.mark.parametrize("dim,k,metric,dtype,integer", [
    (18, 25, "l2", torch.float32, False),
    (518, 25, "l2", torch.float32, False),
    (518, 16, "ip", torch.float32, False),
    (1100, 8, "l2", torch.bfloat16, False),
    (70, 32, "l2", torch.float32, True),
])
def test_knn_stream_prefetch_matches_plain(card, dim, k, metric, dtype, integer):
    rng = np.random.default_rng(dim + k)
    queries, corpus, blk, qid, cand = (
        torch.as_tensor(x, device=card)
        for x in _stream_case(rng, dim, 3, 4, 6, integer=integer))
    queries, corpus = queries.to(dtype), corpus.to(dtype)
    # ε² at the median score, so that about half the pairs are in range.
    e2 = _score64(queries[:64].float(), corpus[:512].float(), metric).median().float()
    kw = dict(k=k, block_q=128, block_c=128, metric=metric)
    kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(queries, corpus, blk, qid, cand, e2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_prefetch_ref(queries, corpus, blk, qid, cand, e2, **kw)
    torch.cuda.synchronize()
    q32, c32 = queries.float(), corpus.float()
    flips = (kf != rf).nonzero()[:, 0]
    for r in flips.tolist():
        t = r // 128
        rows = (blk[t].long()[:, None] * 128 + torch.arange(128, device=card)).reshape(-1)
        cs = c32[rows][cand[t] >= 0]
        gap = (_score64(q32[r:r + 1], cs, metric) - e2.double()).abs().min()
        assert gap <= _allow(q32[r:r + 1], cs).max(), f"row {r}: found flip off ε²"
    ok = torch.ones(kf.shape[0], dtype=torch.bool, device=card)
    ok[flips] = False
    _hold(kd[ok], ki[ok], rd[ok], ri[ok], q32[ok], lambda i: c32[i], metric,
          exact=integer)
    assert (kf > 0).any() and (kf[ok] == rf[ok]).all()


@pytest.mark.parametrize("dim,k,integer", [(1, 10, False), (4, 20, False), (6, 10, False),
                                           (6, 32, True), (8, 20, False)])
def test_knn_stream_prefetch_at_projected_widths(card, dim, k, integer):
    """The block-table kernel at the projection front stage's widths
    (``projection_dim`` 1–8, one partial 8-dim chunk) and its candidate-pool
    sizes k_cand ≤ 32."""
    rng = np.random.default_rng(100 + dim + k)
    queries, corpus, blk, qid, cand = (
        torch.as_tensor(x, device=card)
        for x in _stream_case(rng, dim, 3, 4, 6, integer=integer))
    e2 = _score64(queries[:64], corpus[:512], "l2").median().float()
    kw = dict(k=k, block_q=128, block_c=128, metric="l2")
    kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(queries, corpus, blk, qid, cand, e2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_prefetch_ref(queries, corpus, blk, qid, cand, e2, **kw)
    torch.cuda.synchronize()
    flips = (kf != rf).nonzero()[:, 0]
    for r in flips.tolist():
        t = r // 128
        rows = (blk[t].long()[:, None] * 128 + torch.arange(128, device=card)).reshape(-1)
        cs = corpus[rows][cand[t] >= 0]
        gap = (_score64(queries[r:r + 1], cs, "l2") - e2.double()).abs().min()
        assert gap <= _allow(queries[r:r + 1], cs).max(), f"row {r}: found flip off ε²"
    ok = torch.ones(kf.shape[0], dtype=torch.bool, device=card)
    ok[flips] = False
    _hold(kd[ok], ki[ok], rd[ok], ri[ok], queries[ok], lambda i: corpus[i], "l2",
          exact=integer)
    assert (kf > 0).any() and (kf[ok] == rf[ok]).all()


def _lowrank(n, seed, d=32, rank=5, noise=0.05):
    """Low-rank cloud (``tests/test_projection_front.py``'s, mixing matrix
    seeded 42), on which a linear projection keeps the neighbourhoods."""
    mix = np.random.default_rng(42).standard_normal((rank, d)).astype(np.float32)
    r = np.random.default_rng(seed)
    lat = r.standard_normal((n, rank)).astype(np.float32)
    return (lat @ mix + noise * r.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("metric,pdim,target", [("l2", 5, 0.9), ("ip", 6, 0.9),
                                                ("l2", 3, 0.9)])
def test_projected_index_on_card_matches_cpu(card, metric, pdim, target):
    """A projected index end to end on the card against the port on the
    CPU, ε pinned: the same calibrated rung (l2 at 3 dims calibrates to
    k_cand = 48, past the kernels' k: the counted reroute) and estimates
    within 0.01.  The front stage is approximate, and the kernels' expansion
    form may break a projected-space tie the other way and change a pool's
    last member, so the two answers must overlap in at least 99 % of their
    ids (not all); every returned distance is its id's float64 true-metric
    score within 1e-4."""
    from repro_torch.core import HybridConfig
    from repro_torch.kernels.knn_stream import ops as stream_ops
    from repro_torch.retrieval.calibrate import recall_at_k
    from repro_torch.runtime import KNNIndex
    pts, q = _lowrank(800, 4), _lowrank(90, 5)
    cfg = HybridConfig(k=6, m=3, online_rebalance=False, metric=metric, projection_dim=pdim,
                       recall_target=target)
    reroutes = stream_ops.oversized_k_reroutes + topk_ops.oversized_k_reroutes
    on_card = KNNIndex.build(pts, cfg, 4.0, device="cuda")
    on_cpu = KNNIndex.build(pts, cfg, 4.0, device="cpu")
    assert on_card.backend == "fused"
    key = ("proj", 6, target)
    for args, kw, rows in (((q,), {}, q), ((), dict(exclude_self=True), pts)):
        got, want = on_card.query(*args, **kw), on_cpu.query(*args, **kw)
        assert on_card._live[0].calib[key][0] == on_cpu._live[0].calib[key][0]
        assert abs(got.recall_estimate - want.recall_estimate) <= 0.01
        assert recall_at_k(got.ids, want.ids) >= 0.99
        q64, c64 = rows.astype(np.float64)[:, None, :], pts.astype(np.float64)[got.ids]
        real = -(q64 * c64).sum(-1) if metric == "ip" else np.sqrt(((q64 - c64) ** 2).sum(-1))
        np.testing.assert_allclose(got.dists, real, rtol=1e-4, atol=1e-4)
    if pdim == 3:
        assert on_card._live[0].calib[key][0] * 6 > 32
        assert stream_ops.oversized_k_reroutes + topk_ops.oversized_k_reroutes > reroutes


@pytest.mark.parametrize("dim,n_q", [
    (18, 70), (518, 45), (1100, 33), (2048, 40),
    # widths around the 8-dim chunk, and one, two or a ragged second
    # 128-query row tile; 3,000 points end in a ragged 128-point tile
    (1, 1), (8, 128), (9, 129), (33, 1), (33, 128), (33, 129),
])
def test_bin_hist_matches_plain(card, dim, n_q):
    rng = np.random.default_rng(dim)
    pts = torch.as_tensor(rng.integers(-3, 4, size=(3000, dim)).astype(np.float32), device=card)
    qidx = torch.as_tensor(rng.integers(0, 3000, size=n_q).astype(np.int32), device=card)
    if n_q > 2:
        qidx[-2:] = -1
    q = pts[qidx.clamp(min=0).long()].contiguous()
    bw, n_bins = torch.tensor(4.0, device=card), 64
    got = hist_kernel.distance_bin_histogram(q, pts, qidx, bw, n_bins=n_bins)
    pid = torch.arange(3000, dtype=torch.int32, device=card)
    want = hist_ref.distance_bin_histogram_ref(q, pts, qidx, pid, bw, n_bins=n_bins)
    # Integer data: every squared distance is exact in both forms, and a
    # distance on a bin edge is an exact square root in both.
    assert torch.equal(got, want)
    assert got.sum() > 0


@pytest.mark.parametrize("k", [33, 64])
def test_brute_past_kernel_k_streams_corpus_chunks(card, k):
    """brute_knn at k > MAX_UNROLLED_K streams the corpus in corpus_chunk
    pieces (each call rerouted to the plain version, counted), against the
    plain version over the whole corpus: equal on integer data (ties keep
    the lower corpus row across chunks too).  Its peak memory above its
    inputs stays under three (Q, chunk, D) f32 difference tensors; the
    whole-corpus plain version needs two of (rows, 200,000, D) at once."""
    from repro_torch.core import brute as brute_lib
    n, dim, n_q, chunk = 200_000, 18, 256, 4096
    rng = np.random.default_rng(k)
    pts = torch.as_tensor(rng.integers(-3, 4, size=(n, dim)).astype(np.float32), device=card)
    qid = torch.as_tensor(rng.choice(n, n_q, replace=False).astype(np.int32), device=card)
    q = pts[qid.long()].contiguous()
    ids = torch.arange(n, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reroutes = topk_ops.oversized_k_reroutes
    kd, ki = brute_lib.brute_knn(pts, q, qid, k=k, corpus_chunk=chunk)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert topk_ops.oversized_k_reroutes - reroutes == -(-n // chunk)
    assert peak <= 3 * n_q * chunk * dim * 4, peak
    rd, ri = topk_ref.knn_topk_ref(q, pts, qid, ids, k=k)
    _hold(kd, ki, rd, ri, q, lambda i: pts[i], "l2", exact=True)
    assert not (ki == qid[:, None]).any(), "self pair returned"


def _ties_rows(rng, shape, lo=-2, hi=3):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


@pytest.mark.parametrize("nblk,block_c,integer", [
    (40, 128, True),       # 5,120 stream positions: two compaction windows
    (9, 64, False),
    (3, 200, True),        # blocks that straddle the kernel's 128-candidate tiles
])
def test_knn_stream_windows_and_block_sizes(card, nblk, block_c, integer):
    """The block-table kernel at other block sizes and over more than one
    compaction window, against its plain version."""
    rng = np.random.default_rng(nblk * block_c)
    queries, corpus, blk, qid, cand = (
        torch.as_tensor(x, device=card)
        for x in _stream_case(rng, 24, 2, nblk, nblk + 3, block_c=block_c, integer=integer))
    e2 = _score64(queries[:64], corpus[:512], "l2").median().float()
    kw = dict(k=20, block_q=128, block_c=block_c, metric="l2")
    kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(queries, corpus, blk, qid, cand, e2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_prefetch_ref(queries, corpus, blk, qid, cand, e2, **kw)
    torch.cuda.synchronize()
    if integer:
        assert torch.equal(kf, rf)
    ok = kf == rf
    assert ok.float().mean() > 0.95 and (kf > 0).any()
    _hold(kd[ok], ki[ok], rd[ok], ri[ok], queries[ok], lambda i: corpus[i], "l2",
          exact=integer)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_knn_stream_ties_keep_stream_order(card, metric):
    """Duplicate candidate rows in two slots of a tile, under other ids and
    a table not sorted by id: equal scores keep the first position of the
    tile's stream (slot j · block_c + row), as the plain version's stable
    sort does, whatever the ids."""
    rng = np.random.default_rng(5)
    dim, bc = 9, 128
    corpus = _ties_rows(rng, (4 * bc, dim))
    corpus[3 * bc:] = corpus[:bc]                 # block 3 repeats block 0
    queries = _ties_rows(rng, (2 * 128, dim))
    blk = np.array([[3, 1, 0], [0, 2, 3]], np.int32)
    cand = (blk[:, :, None] * bc + np.arange(bc)).reshape(2, -1).astype(np.int32)
    cand[:, ::11] = -1
    qid = np.full(256, -2, np.int32)
    queries, corpus, blk, qid, cand = (torch.as_tensor(x, device=card)
                                       for x in (queries, corpus, blk, qid, cand))
    e2 = torch.tensor(1e9, device=card)
    kw = dict(k=32, block_q=128, block_c=bc, metric=metric)
    kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(queries, corpus, blk, qid, cand, e2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_prefetch_ref(queries, corpus, blk, qid, cand, e2, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kf, rf) and torch.equal(kd, rd) and torch.equal(ki, ri)
    # the tile reading block 3 first reports its ids where block 0 ties
    assert (ki[:128] >= 3 * bc).any()


@pytest.mark.parametrize("tc,block_c,k", [(2048, 128, 25), (384, 64, 8)])
def test_gathered_batched_launch_matches_per_tile_plain(card, tc, block_c, k):
    """The gathered route's batched launch — several tiles, each against
    its own candidates, one of them all −1 — against the plain version
    run on each tile alone; integer data, so ids agree exactly."""
    rng = np.random.default_rng(tc + k)
    n_tiles, dim = 5, 18
    q = torch.as_tensor(_ties_rows(rng, (n_tiles * 128, dim)), device=card)
    c = torch.as_tensor(_ties_rows(rng, (n_tiles, tc, dim)), device=card)
    c[:, :128] = q.reshape(n_tiles, 128, dim)     # self pairs at d = 0
    cid = torch.as_tensor(rng.integers(0, 10_000, size=(n_tiles, tc)).astype(np.int32),
                          device=card)
    cid[:, :128] = torch.arange(128, dtype=torch.int32, device=card)
    cid[1] = -1
    cid[3, ::5] = -1
    qid = torch.arange(128, dtype=torch.int32, device=card).repeat(n_tiles)
    e2 = torch.tensor(40.0, device=card)
    kd, ki, kf = stream_kernel.knn_stream_topk_padded(q, c, qid, cid, e2, k=k,
                                                      block_c=block_c)
    torch.cuda.synchronize()
    assert stream_kernel.launches["knn_stream_topk_padded"] >= 1
    for t in range(n_tiles):
        rows = slice(t * 128, (t + 1) * 128)
        rd, ri, rf = stream_ref.knn_stream_topk_ref(q[rows], c[t], qid[rows], cid[t], e2, k=k)
        assert torch.equal(kf[rows], rf), t
        assert torch.equal(kd[rows], rd) and torch.equal(ki[rows], ri), t
    assert (kf[128:256] == 0).all() and (kf > 0).any()


def _pairwise_case(rng, batch, n_q, n_c, dim, far_tile):
    q = _ties_rows(rng, (batch, n_q, dim), -3, 4)
    c = _ties_rows(rng, (batch, n_c, dim), -3, 4)
    if far_tile:
        c[:, :128] += 10.0        # a far candidate block: SHORTC skips its tiles
    return q, c


@pytest.mark.parametrize("n_q,n_c,dim,block_d,metric,shortc", [
    (130, 300, 1, 128, "l2", False),
    (200, 129, 3, 128, "l2", True),
    (128, 2048, 18, 128, "l2", True),
    (257, 500, 33, 8, "l2", True),
    (257, 500, 33, 10, "ip", False),
    (140, 260, 518, 128, "l2", True),
    (140, 260, 518, 128, "l2", False),
    (100, 200, 518, 128, "ip", False),
])
def test_pairwise_sq_l2_matches_plain(card, n_q, n_c, dim, block_d, metric, shortc):
    """The pairwise kernel against its plain version on integer data, where
    the expansion form is exact in both: ragged rows through the padding
    entry point, and batched tiles with their SHORTC chunk counts (equal)."""
    from repro_torch.kernels.pairwise_l2 import kernel as pair_kernel
    from repro_torch.kernels.pairwise_l2 import ops as pair_ops
    from repro_torch.kernels.pairwise_l2 import ref as pair_ref
    rng = np.random.default_rng(n_q + n_c + dim)
    q, c = _pairwise_case(rng, 2, n_q, n_c, dim, shortc)
    n_chunks = -(-dim // block_d)
    # ε² between the near and the far blocks' first-chunk sums
    e2 = float(np.median(((q[0, :, None, :block_d] - c[0, None, 128:, :block_d]) ** 2)
                         .sum(-1))) * n_chunks if shortc else None
    kw = dict(block_d=block_d, metric=metric, shortc_eps2=e2)
    got = pair_ops.pairwise_sq_l2(torch.as_tensor(q[0], device=card),
                                  torch.as_tensor(c[0], device=card), **kw)
    want = pair_ops.pairwise_sq_l2(torch.as_tensor(q[0]), torch.as_tensor(c[0]), **kw)
    torch.cuda.synchronize()
    assert got.shape == (n_q, n_c) and torch.equal(got.cpu(), want)

    qp = np.zeros((2, -(-n_q // 128) * 128, dim), np.float32)
    cp = np.zeros((2, -(-n_c // 128) * 128, dim), np.float32)
    qp[:, :n_q], cp[:, :n_c] = q, c
    qt, ct = torch.as_tensor(qp, device=card), torch.as_tensor(cp, device=card)
    shape = (2, qp.shape[1] // 128, cp.shape[1] // 128)
    ck = torch.zeros(shape, dtype=torch.int32, device=card)
    cr = torch.zeros_like(ck)
    got = pair_kernel.pairwise_sq_l2(qt, ct, e2, block_d=block_d, metric=metric,
                                     chunks_out=ck)
    want = pair_ref.pairwise_sq_l2_matmul_ref(qt, ct, shortc_eps2=e2, block_d=block_d,
                                              metric=metric, chunks_out=cr)
    torch.cuda.synchronize()
    assert torch.equal(ck, cr) and torch.equal(got, want)
    if shortc and n_chunks > 1:
        assert (ck < n_chunks).any(), "SHORTC skipped no tile"


def _delta_case(rng, n_delta, n_q, dim, integer, n_base=1000):
    """A delta buffer of ``n_delta`` inserted rows (every fifth tombstoned)
    as ``padded_delta`` lays it out, and queries whose exclusion ids are −2
    (nothing), or the global id of a live delta row they duplicate."""
    from repro_torch.runtime import mutation as mut_lib
    draw = ((lambda s: rng.integers(-3, 4, size=s)) if integer
            else (lambda s: rng.normal(size=s)))
    state = mut_lib.MutationState.empty(dim)
    state, gids = state.with_insert(draw((n_delta, dim)).astype(np.float32), n_base, dim)
    if n_delta > 1:
        state = state.with_delete(gids[::5], n_base)
    pts, dgids = state.padded_delta(None, n_base)
    q = draw((n_q, dim)).astype(np.float32)
    excl = np.full((n_q,), -2, np.int32)
    live = np.flatnonzero(dgids >= 0)
    if len(live):
        own = live[rng.integers(0, len(live), n_q // 3)]
        q[: n_q // 3] = pts[own]
        excl[: n_q // 3] = dgids[own]
    return q, pts, excl, dgids


@pytest.mark.parametrize("n_delta,integer", [(1, False), (32, False), (33, True),
                                             (4096, False), (4096, True)])
def test_delta_topk_matches_plain(card, n_delta, integer):
    """The delta buffer's top-K (``mutation.delta_topk``, the knn_tile_topk
    kernel on the card) against its plain version on the CPU, on ragged
    buffers padded to DELTA_BLOCK buckets: tombstoned and padding rows
    never return, an excluded id (a query's own) never returns, −2
    excludes nothing; on integer data ids agree exactly (ties keep the
    lower buffer position)."""
    from repro_torch.runtime import mutation as mut_lib
    n_base, k = 1000, 16
    rng = np.random.default_rng(n_delta + integer)
    q, pts, excl, dgids = _delta_case(rng, n_delta, 300, 18, integer, n_base)
    k = min(k, len(pts))
    kd, ki = mut_lib.delta_topk(*(torch.as_tensor(x, device=card)
                                  for x in (q, pts, excl, dgids)), k=k)
    rd, ri = mut_lib.delta_topk(*(torch.as_tensor(x) for x in (q, pts, excl, dgids)), k=k)
    torch.cuda.synchronize()
    pts_d = torch.as_tensor(pts, device=card)
    _hold(kd, ki, rd.to(card), ri.to(card), torch.as_tensor(q, device=card),
          lambda i: pts_d[(i - n_base).clamp(min=0)], "l2", exact=integer)
    got = ki.cpu().numpy()
    assert np.isin(got[got >= 0], dgids[dgids >= 0]).all(), "a tombstoned row returned"
    assert not (got == excl[:, None]).any(), "an excluded id returned"


def test_fold_topk_on_card_equals_cpu(card):
    """The merge-time fold on the card equals its CPU result bit for bit:
    tombstones and the excluded id masked, equal scores keep the main block
    first and the lower position within a block."""
    from repro_torch.runtime import mutation as mut_lib
    rng = np.random.default_rng(5)
    n_q, k_main, k_delta, k = 257, 32, 16, 16
    main_d = np.sort(rng.integers(0, 40, (n_q, k_main)).astype(np.float32), 1)
    main_i = rng.integers(0, 500, (n_q, k_main)).astype(np.int32)
    main_d[:, -3:], main_i[:, -3:] = np.inf, -1
    delta_d = np.sort(rng.integers(0, 40, (n_q, k_delta)).astype(np.float32), 1)
    delta_i = rng.integers(500, 600, (n_q, k_delta)).astype(np.int32)
    state = mut_lib.MutationState.empty(2).with_delete(rng.choice(500, 37, replace=False), 500)
    tombs = state.tombstone_table()
    excl = np.where(rng.random(n_q) < 0.5, main_i[:, 0], -2).astype(np.int32)
    args = (main_d, main_i, delta_d, delta_i, tombs, excl)
    gd, gi = mut_lib.fold_topk(*(torch.as_tensor(x, device=card) for x in args), k=k)
    wd, wi = mut_lib.fold_topk(*(torch.as_tensor(x) for x in args), k=k)
    assert torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi)


# -- the serving front end and the crash drill over a card index -------------

SERVE_PER_ROW = 1e-3       # the linear service model of tests/test_torch_server.py


def _serving_index(device, backend=None):
    from conftest import make_mixture
    from repro_torch.core import HybridConfig
    from repro_torch.runtime import KNNIndex
    db = make_mixture(300, 120, dim=6, seed=0)
    cfg = HybridConfig(k=3, m=4, n_batches=1, online_rebalance=False)
    return KNNIndex.build(db, cfg, 0.3, device=device, backend=backend)


def _serve(index, n, load, seed):
    from repro_torch.runtime import KNNServer, ServerConfig, VirtualClock, open_loop_trace
    rows = np.random.default_rng(seed + 100).normal(size=(n, 6)).astype(np.float32)
    srv = KNNServer(index, ServerConfig(deadline=0.2, max_wait=0.02, record_batches=True),
                    clock=VirtualClock(), service_model=lambda b: SERVE_PER_ROW * b)
    srv.prime_service_estimate(SERVE_PER_ROW)
    return srv, srv.run_trace(open_loop_trace(rows, qps=load / SERVE_PER_ROW, seed=seed))


def test_server_full_level_rows_equal_direct_card_query(card):
    """Every request served at a non-degraded rung over a card index is
    bit-identical to a direct card ``index.query`` of its batch."""
    from repro_torch.runtime import Served
    idx = _serving_index(card)
    srv, tickets = _serve(idx, 300, 1.0, 3)
    by_rid = {t.request_id: t.outcome for t in tickets}
    audited = 0
    for rec in srv.batch_log:
        if srv.cfg.ladder[rec.level].degraded:
            continue
        direct = idx.query(rec.rows, k=rec.k)
        for j, rid in enumerate(rec.request_ids):
            assert isinstance(by_rid[rid], Served)
            np.testing.assert_array_equal(by_rid[rid].dists, direct.dists[j])
            np.testing.assert_array_equal(by_rid[rid].ids, direct.ids[j])
            audited += 1
    assert audited == srv.n_served > 0


def test_server_trace_on_card_matches_cpu_port(card):
    """The same 2x trace through a card index and the CPU port (both
    ``fused``, ε pinned): equal outcome kinds, reasons, levels, batches and
    counters, times within 1e-9 s, distances within 1e-5 and ids equal
    except where float64 distances tie within 1e-5."""
    from repro_torch.runtime import Rejected, clear_engine_cache
    runs = []
    for device in (card, torch.device("cpu")):
        clear_engine_cache()
        idx = _serving_index(device, backend="fused")
        runs.append((idx,) + _serve(idx, 500, 2.0, 7))
    (idx, srv_c, t_card), (_, srv_h, t_cpu) = runs
    pts = np.asarray(idx._live[0].points_ref, np.float64)
    rows = np.random.default_rng(107).normal(size=(500, 6)).astype(np.float32).astype(np.float64)
    for a, b in zip((t.outcome for t in t_card), (t.outcome for t in t_cpu)):
        assert type(a) is type(b)
        if isinstance(a, Rejected):
            assert a.reason == b.reason
            assert abs(a.retry_after - b.retry_after) <= 1e-9
            continue
        assert (a.level, a.batch_seq, a.degraded) == (b.level, b.batch_seq, b.degraded)
        assert abs(a.t_response - b.t_response) <= 1e-9
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-5, atol=1e-5)
        diff = np.nonzero(a.ids != b.ids)[0]
        q = rows[a.request_id]
        np.testing.assert_allclose(np.linalg.norm(pts[a.ids[diff]] - q, axis=-1),
                                   np.linalg.norm(pts[b.ids[diff]] - q, axis=-1),
                                   rtol=1e-5, atol=1e-5)
    mc, mh = srv_c.metrics(), srv_h.metrics()
    for key in ("n_served", "n_shed", "n_batches", "level_occupancy", "n_deadline_misses"):
        assert mc[key] == mh[key], key
    assert mc["n_shed_total"] > 0


def test_crash_drill_three_phases_on_card(card, tmp_path):
    """Save once, then for each crash phase: delete base ids, crash the
    save, load on the card (the last acknowledged generation's answers,
    bit for bit; after ``pre-latest`` the complete step dir exists while
    ``LATEST`` names the acknowledged one), retry (lands, loads as the
    live index)."""
    import os

    from repro_torch.runtime import (CheckpointCrash, CrashingCheckpointManager, KNNIndex,
                                     ScriptedFaults)
    idx = _serving_index(card)
    q = np.random.default_rng(9).normal(size=(40, 6)).astype(np.float32)
    faults = ScriptedFaults()
    mgr = CrashingCheckpointManager(str(tmp_path), faults)
    acked = idx.save(str(tmp_path), manager=mgr)
    want = idx.query(q)
    for i, phase in enumerate(("pre-arrays", "pre-manifest", "pre-latest")):
        idx.delete(np.arange(10 * i, 10 * i + 10))
        faults.crash_checkpoint(phase)
        with pytest.raises(CheckpointCrash):
            idx.save(str(tmp_path), manager=mgr)
        got = KNNIndex.load(str(tmp_path), device=card).query(q)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
        if phase == "pre-latest":
            assert os.path.isdir(os.path.join(tmp_path, f"step-{acked + 1:09d}"))
        with open(os.path.join(tmp_path, "LATEST")) as fh:
            assert fh.read().strip() == f"step-{acked:09d}"
        acked = idx.save(str(tmp_path), manager=mgr)
        want = idx.query(q)
        got = KNNIndex.load(str(tmp_path), device=card).query(q)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
    assert acked == 3 and faults.count("ckpt-crash") == 3


# -- the mesh on one card: the collective merge, the ring join, a 2 x 2 index --

def _merge_case(rng, p, q=300, k_in=9):
    """(P, Q, k_in) blocks with distance ties, in-block duplicate ids, (inf,
    −1) padding and exclusion ids that hit candidates."""
    d = np.round(rng.uniform(0, 2, (p, q, k_in)), 1).astype(np.float32)
    i = rng.integers(0, 500, (p, q, k_in)).astype(np.int32)
    i[:, ::4, 3] = i[:, ::4, 1]
    pad = rng.random((p, q, k_in)) < 0.1
    d[pad] = np.inf
    i[pad] = -1
    order = np.argsort(d, -1, kind="stable")
    d, i = np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)
    excl = np.where(rng.random(q) < 0.5, i[0, :, 0], -2).astype(np.int32)
    return d, i, excl


@pytest.mark.parametrize("p", [2, 3, 4, 5, 6, 7, 8])
def test_collective_merge_on_card_equals_cpu(card, p):
    """The merge on cuda:0 equals the same merge on the CPU bit for bit,
    every strategy the shard count allows, with and without dedup."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    rng = np.random.default_rng(p)
    d, i, excl = _merge_case(rng, p)
    strategies = ["allgather"] + (["tree"] if p & (p - 1) == 0 else [])
    for strategy in strategies:
        for dedup in (False, True):
            outs = []
            for dev in ("cuda", "cpu"):
                fn = dist.collective_topk_merge(make_serving_mesh(p, device=dev), ("shard",),
                                                k=5, strategy=strategy, dedup=dedup)
                md, mi = fn(torch.as_tensor(d, device=dev), torch.as_tensor(i, device=dev),
                            torch.as_tensor(excl, device=dev))
                assert md.device.type == dev
                outs.append((md.cpu(), mi.cpu()))
            assert torch.equal(outs[0][0], outs[1][0]), (strategy, dedup)
            assert torch.equal(outs[0][1], outs[1][1]), (strategy, dedup)


def test_ring_join_on_card_ragged_rows_and_chunk(card):
    """A ring join of 1,000 rows over 4 slots of the card (padded to 4 ×
    256) with a 100-row corpus chunk, snapped to 64: against the CPU ring
    and float64 — ids equal except ties within the expansion bound."""
    from repro_torch.core import distributed as dist
    from repro_torch.launch.mesh import make_serving_mesh
    pts = np.random.default_rng(3).normal(size=(1000, 18)).astype(np.float32)
    assert dist._even_chunk(100, 256) == 64
    got = dist.ring_self_join(make_serving_mesh(4, device="cuda"), ("shard",), k=10,
                              corpus_chunk=100)(pts)
    want = dist.ring_self_join(make_serving_mesh(4, device="cpu"), ("shard",), k=10,
                               corpus_chunk=100)(pts)
    assert got[0].device.type == "cuda" and got[0].shape == (1000, 10)
    q = torch.as_tensor(pts, device=card)
    _hold(got[0], got[1], want[0].to(card), want[1].to(card), q, lambda ids: q[ids], "l2")
    gi = got[1].cpu().numpy()
    assert gi.min() >= 0 and not (gi == np.arange(1000)[:, None]).any()
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert np.abs(got[0].cpu().numpy() - np.sort(d2, 1)[:, :10]).max() < 1e-4


def test_replicated_mesh_on_one_card_matches_single_device(card):
    """A 2 × 2 mesh of four cuda:0 slots against the single-device card
    index (ε pinned): distances within 1e-5, ids equal except where float64
    distances tie within 1e-5, full coverage; a repeat adds no bucket."""
    from conftest import make_mixture
    from repro_torch.core import HybridConfig
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.runtime import KNNIndex, ShardedKNNIndex
    db = make_mixture(600, 200, dim=8, seed=0)
    q = make_mixture(200, 100, dim=8, seed=5)
    cfg = HybridConfig(k=8, m=4, n_batches=2, online_rebalance=False)
    mesh = make_serving_mesh(2, replicas=2)
    assert {str(d) for d in mesh.devices.reshape(-1)} == {"cuda:0"}
    sharded = KNNIndex.build(db, cfg, 0.3, mesh=mesh)
    assert isinstance(sharded, ShardedKNNIndex) and sharded.backend == "fused"
    single = KNNIndex.build(db, cfg, 0.3, device=card)
    for queries, kw in ((q, {}), (None, dict(exclude_self=True))):
        got, want = sharded.query(queries, **kw), single.query(queries, **kw)
        assert got.coverage.all()
        np.testing.assert_allclose(got.dists, want.dists, rtol=1e-5, atol=1e-5)
        qq = np.asarray(db if queries is None else queries, np.float64)
        r, c = np.nonzero(got.ids != want.ids)
        full = np.asarray(db, np.float64)
        np.testing.assert_allclose(np.linalg.norm(qq[r] - full[got.ids[r, c]], axis=-1),
                                   np.linalg.norm(qq[r] - full[want.ids[r, c]], axis=-1),
                                   atol=1e-5)
    assert sharded.query(q.copy()).stats.n_engine_compiles == 0


def test_params_from_jax_full_olmo_layout_on_card(card):
    """The full olmo_1b weights in the JAX package's scanned layout (every
    leaf of ``blocks[0]`` stacked over 16 groups, group g filled with g)
    carried onto the card: layer i holds group i, at the full shapes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("olmo_1b")
    d, h, hd, f, n = cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.n_layers
    shapes = {"attn": {"wq": (d, h, hd), "wk": (d, h, hd), "wv": (d, h, hd), "wo": (h, hd, d)},
              "mlp": {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}}
    block = {"norm1": {}, "norm2": {}}
    for sub, leaves in shapes.items():
        block[sub] = {}
        for name, shape in leaves.items():
            leaf = torch.empty((n,) + shape, device=card)
            for g in range(n):
                leaf[g].fill_(g)
            block[sub][name] = leaf
    tree = {"embed": {"tok": torch.zeros((cfg.vocab_size, d), device=card)},
            "final_norm": {}, "blocks": [block], "rem": []}
    model = transformer.params_from_jax(tree, cfg, device="cuda")
    del tree, block
    assert len(model.layers) == n
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    for i, layer in enumerate(model.layers):
        for sub, leaves in shapes.items():
            for name, shape in leaves.items():
                w = getattr(layer, sub)[name]
                assert tuple(w.shape) == shape and w.is_cuda
                assert bool((w == i).all()), f"layer {i} {sub}.{name} is not group {i}"



RECORD_FIELDS = {"temp_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
                 "generated_code_size_in_bytes"}


def _record_index(card):
    """A clean fused l2 index on the card (ε pinned) and foreign queries in
    the dense cluster and the sparse background."""
    from conftest import make_mixture
    from repro_torch.core import HybridConfig
    from repro_torch.runtime import KNNIndex, clear_engine_cache
    clear_engine_cache()
    db = make_mixture(30_000, 10_000, dim=8, seed=0)
    q = make_mixture(600, 400, dim=8, seed=5)
    index = KNNIndex.build(db, HybridConfig(k=8, m=4, n_batches=2, online_rebalance=False),
                           0.3, device=card)
    return index, q


def test_first_bucket_query_leaves_peak_counter(card):
    """The records never reset the caller's peak counter: with the peak
    raised above what a first-bucket query needs, the query leaves
    ``max_memory_allocated()`` exactly as it was."""
    index, q = _record_index(card)
    spike = torch.empty(1 << 30, dtype=torch.uint8, device=card)
    del spike
    peak = torch.cuda.max_memory_allocated()
    res = index.query(q)
    assert res.stats.n_engine_compiles > 0
    assert torch.cuda.max_memory_allocated() == peak
    assert index.query(q.copy()).stats.n_engine_compiles == 0
    assert torch.cuda.max_memory_allocated() == peak


def test_brute_record_matches_allocator_peak(card):
    """The brute record's temp + output against the allocator's own peak of
    requested bytes above entry, read by the test around the same isolated
    engine call (the test owns the counter and resets it): within 1 %.  Its
    code bytes are the ``knn_topk`` library's."""
    from repro_torch.core import brute as brute_lib
    from repro_torch.kernels import _build
    from repro_torch.runtime import knn_index
    knn_index.clear_engine_cache()
    g = torch.Generator(device=card).manual_seed(3)
    corpus = torch.randn(400_000, 16, device=card, generator=g)
    queries = torch.randn(4096, 16, device=card, generator=g)
    qids = torch.full((4096,), -1, dtype=torch.int32, device=card)
    owner = type("Owner", (), {})()
    owner.compile_counts, owner.executables, owner.t_record = {}, {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    entry = torch.cuda.memory_stats()["requested_bytes.all.current"]
    d, i = knn_index.run_engine(owner, "brute", brute_lib.brute_knn, (corpus, queries, qids),
                                dict(k=16, corpus_chunk=4096, metric="l2"))
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - entry
    rec = knn_index.executable_memory_analysis(owner.executables)["brute"]
    assert set(rec) == RECORD_FIELDS and owner.compile_counts == {"brute": 1}
    assert rec["output_size_in_bytes"] == d.numel() * 4 + i.numel() * 4
    assert rec["temp_size_in_bytes"] > 0
    got = rec["temp_size_in_bytes"] + rec["output_size_in_bytes"]
    assert abs(got - peak) <= 0.01 * peak, (got, peak)
    assert rec["generated_code_size_in_bytes"] == _build._lib_path("knn_topk").stat().st_size


def test_every_kind_that_ran_has_four_fields(card):
    """Dense, sparse, brute, delta and merge on the card: each kind that
    ran holds all four fields and code bytes that are a sum of the built
    libraries'; the three grid-side engines allocate beyond their outputs
    (temp > 0), where the delta engine's one kernel may write only its
    output."""
    from repro_torch.kernels import _build
    index, q = _record_index(card)
    res = index.query(q)
    index.insert(q[:40])
    index.delete([0, 1, 2])
    index.query(q)
    ip_index = type(index).build(index.points, dataclasses.replace(index.config, metric="ip"),
                                 0.3, device=card)
    ip_index.query(q[:64])
    mem = {**index.memory_analysis(), **ip_index.memory_analysis()}
    ran = {"delta", "merge", "brute"} | {k for k, n in (("dense", res.stats.n_dense),
                                                         ("sparse", res.stats.n_sparse)) if n}
    assert ran <= set(mem), (ran, set(mem))
    libs = [_build._lib_path(n).stat().st_size for n in _build.SOURCES]
    sums = {sum(s for j, s in enumerate(libs) if mask >> j & 1) for mask in range(1 << len(libs))}
    for kind in ran:
        rec = mem[kind]
        assert set(rec) == RECORD_FIELDS, (kind, rec)
        assert rec["temp_size_in_bytes"] >= 0 and rec["argument_size_in_bytes"] > 0, (kind, rec)
        assert kind not in ("dense", "sparse", "brute") or rec["temp_size_in_bytes"] > 0, kind
        assert rec["generated_code_size_in_bytes"] in sums, (kind, rec)
