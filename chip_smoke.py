#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--n POINTS]

Phases (any failure raises and exits non-zero; nothing is caught):

  build  compile every CUDA kernel of ``src/repro_torch/csrc`` with nvcc
         (sm_90a) into ``build/repro_torch/``;
  (b)    ``KNNIndex.build`` + self-join of the paper's SuSy-sized cloud
         (5,000,000 × 18 by default, ``pointclouds.load("susy")``) with
         ``HybridConfig(k=25, m=6, gamma=0.4, rho=0.2,
         online_rebalance=False)``; ε is not pinned, so ε selection runs
         the ``bin_hist`` kernel.  2048 sampled rows are held against a
         float64 oracle computed on the card;
  (c)    R≠S serving: a 65,536-query foreign batch against the same
         index, twice; a sample is held against float64 and the second
         call must add no engine bucket;
  (d)    the brute baseline (GPU-JOINLINEAR) on 4096 sampled queries over
         the full corpus, through the ``knn_topk`` kernel;
  (a)    each kernel against its plain PyTorch version on the card, on the
         inputs the main path gave it: max |Δd|, id / found / bin
         mismatches (each explained by an ε²- or bin-edge flip or a
         distance tie, recomputed in float64), kernel / plain / library
         times from CUDA events, and the bound from bytes and FLOPs.

Kernel launch counters are set to 0 just before (b) and read just after
(d).  The last lines are the card's name and power limit, one JSON line
with every kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32 FLOP/s
# outside the tensor cores.  The kernels run fp32 FMA, so that is their peak.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP32_U = 2.0 ** -24                 # unit roundoff of float32

K = 25
ORACLE_ROWS = 2048
FOREIGN_QUERIES = 65_536
BRUTE_QUERIES = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(fn(), milliseconds of that one call from CUDA events)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, flops: float):
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / FP32_FLOP_PER_S * 1e3
    return (max(b_ms, f_ms), "bytes" if b_ms >= f_ms else "operations")


def oracle64(points, queries, query_ids, k: int, chunk: int = 262_144):
    """Exact float64 k nearest (squared distances, ids) of ``queries``
    over ``points`` on the card; ``query_ids`` (or None) are excluded."""
    import torch
    q = queries.double()
    qq = (q * q).sum(1, keepdim=True)
    best_d = best_i = None
    for c0 in range(0, points.shape[0], chunk):
        c = points[c0:c0 + chunk].double()
        d2 = torch.clamp(qq + (c * c).sum(1)[None, :] - 2.0 * q @ c.T, min=0.0)
        if query_ids is not None:
            local = query_ids.long() - c0
            hit = (local >= 0) & (local < c.shape[0])
            d2[hit.nonzero()[:, 0], local[hit]] = float("inf")
        vd, vi = torch.topk(d2, k, dim=1, largest=False)
        vi = vi + c0
        if best_d is None:
            best_d, best_i = vd, vi
        else:
            best_d, sel = torch.topk(torch.cat([best_d, vd], 1), k, dim=1, largest=False)
            best_i = torch.cat([best_i, vi], 1).gather(1, sel)
    return best_d, best_i


def check_exact(points, queries, query_ids, got_d, got_i, what: str):
    """Reported Euclidean distances and ids against the float64 oracle:
    the returned set's float64 distances equal the true k smallest (up to
    fp32 rounding of near-ties) and each reported distance is its id's."""
    import torch
    k = got_i.shape[1]
    od2, _ = oracle64(points, queries, query_ids, k)
    gi = torch.as_tensor(got_i, device=points.device).long()
    assert (gi >= 0).all(), f"{what}: missing neighbors"
    if query_ids is not None:
        assert not (gi == query_ids.long()[:, None]).any(), f"{what}: self pair returned"
    diff = points[gi].double() - queries.double()[:, None, :]
    rd2 = torch.sort((diff * diff).sum(-1), dim=1).values
    set_err = (rd2 - od2).abs().max().item()
    gd = torch.as_tensor(got_d, device=points.device).double()
    dist_err = (gd - torch.sqrt(od2)).abs().max().item()
    log(f"  {what}: {len(gi)} rows vs float64: max |d²(ids) − d²_oracle| "
        f"{set_err:.3e}, max |d − d_oracle| {dist_err:.3e}")
    assert set_err <= 1e-5, f"{what}: returned ids are not the exact k nearest"
    assert dist_err <= 1e-4, f"{what}: reported distances disagree with float64"


def bin_edge_pairs(queries, points, bw, n_bins: int, chunk: int = 262_144):
    """(n_bins + 1,) counts, in float64, of the pairs whose distance d lies
    within the fp32 error of either histogram version of a bin edge e·bw
    (1 ≤ e ≤ n_bins): only such a pair can land in different bins of the
    kernel and the plain version.  The kernel's expansion |q|²+|p|²−2q·p
    errs by at most (D+4)·u·(|q|+|p|)² in d², so by the smaller of that
    over d and its root in d; the plain difference form, the root and the
    divide by bw err by a few u·d.  The window is twice their sum."""
    import torch
    dim = queries.shape[1]
    q = queries.double()
    qq, qn = (q * q).sum(1)[:, None], q.norm(dim=1)[:, None]
    bw64 = bw.double()
    near = torch.zeros(n_bins + 1, dtype=torch.int64, device=q.device)
    for c0 in range(0, points.shape[0], chunk):
        p = points[c0:c0 + chunk].double()
        d = torch.sqrt(torch.clamp(qq + (p * p).sum(1)[None, :] - 2.0 * q @ p.T, min=0.0))
        e2 = (dim + 4) * FP32_U * (qn + p.norm(dim=1)[None, :]) ** 2
        window = 2.0 * (torch.minimum(e2 / d, torch.sqrt(e2)) + (dim + 8) * FP32_U * d)
        edge = torch.round(d / bw64)
        hit = ((d - edge * bw64).abs() < window) & (edge >= 1) & (edge <= n_bins)
        near += torch.bincount(edge[hit].long(), minlength=n_bins + 1)
    return near


def stats_line(res, n_q: int) -> str:
    s = res.stats
    return (f"n_dense={s.n_dense} n_sparse={s.n_sparse} n_failed={s.n_failed} "
            f"n_uncertified={s.n_uncertified} t_wall={s.t_wall:.3f}s t_dense={s.t_dense:.3f}s "
            f"t_sparse={s.t_sparse:.3f}s t_brute={s.t_brute:.3f}s "
            f"queries/s={n_q / s.t_wall:.1f} n_engine_compiles={s.n_engine_compiles}")


def hold_topk(what, pr, qpts, kd, ki, rd, ri, kf=None, rf=None, scored=None, eps2=None):
    """Hold a kernel's top-k against its plain version on the same inputs.
    ``found`` flips must have a scored pair within 1e-4 of ε² in float64;
    on the other rows the inf pattern must agree and every id mismatch
    must be a distance tie in float64 (``pr[id]`` is candidate ``id``).
    Returns (max |Δd|, id mismatches, found mismatches)."""
    import torch
    flips = ((kf != rf).nonzero()[:, 0] if kf is not None
             else torch.zeros((0,), dtype=torch.long, device=kd.device))
    flip_gap = tie_gap = 0.0
    for r in flips.tolist():
        d2 = ((scored(r).double() - qpts[r].double()) ** 2).sum(1)
        gap = (d2 - eps2.double()).abs().min().item()
        assert gap < 1e-4, f"{what}: row {r} found flip is {gap:.2e} off ε²"
        flip_gap = max(flip_gap, gap)
    ok = torch.ones(kd.shape[0], dtype=torch.bool, device=kd.device)
    ok[flips] = False
    assert (torch.isfinite(kd) == torch.isfinite(rd))[ok].all(), f"{what}: inf pattern"
    fin = torch.isfinite(rd) & ok[:, None]
    err = (kd - rd).abs()[fin].max().item() if fin.any() else 0.0
    bad = ((ki != ri) & ok[:, None]).nonzero()
    if len(bad):
        r, c = bad[:, 0], bad[:, 1]
        q = qpts[r].double()
        dk = ((pr[ki[r, c].long()].double() - q) ** 2).sum(1)
        dr = ((pr[ri[r, c].long()].double() - q) ** 2).sum(1)
        tie_gap = (dk - dr).abs().max().item()
        assert tie_gap < 1e-5, f"{what}: an id mismatch is not a distance tie ({tie_gap:.2e})"
    log(f"[a] {what}: max|Δd|={err:.3e} id mismatches={len(bad)} (float64 "
        f"|Δd²| ≤ {tie_gap:.2e}) found mismatches={len(flips)} (float64 "
        f"|d² − ε²| ≤ {flip_gap:.2e})")
    assert err <= 1e-4, f"{what}: distances disagree with the plain version"
    return err, len(bad), len(flips)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=5_000_000,
                    help="corpus size |D| (18 dims are never cut)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 1

    from repro_torch.core import HybridConfig
    from repro_torch.core import brute as brute_lib
    from repro_torch.core import dense_join as dense_lib
    from repro_torch.core import epsilon as eps_lib
    from repro_torch.core import splitter as split_lib
    from repro_torch.core.hybrid import _pad_ids
    from repro_torch.core.queue import WorkQueue
    from repro_torch.data import pointclouds
    from repro_torch.kernels import _build
    from repro_torch.kernels.bin_hist import kernel as hist_kernel
    from repro_torch.kernels.bin_hist import ops as hist_ops
    from repro_torch.kernels.bin_hist import ref as hist_ref
    from repro_torch.kernels.knn_stream import kernel as stream_kernel
    from repro_torch.kernels.knn_stream import ops as stream_ops
    from repro_torch.kernels.knn_stream import ref as stream_ref
    from repro_torch.kernels.knn_topk import kernel as topk_kernel
    from repro_torch.kernels.knn_topk import ops as topk_ops
    from repro_torch.kernels.knn_topk import ref as topk_ref
    from repro_torch.runtime import KNNIndex

    torch.backends.cuda.matmul.allow_tf32 = False   # float64 oracle / yardsticks
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    log(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] nvcc sm_90a, {len(logs)} sources in parallel: "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in sorted(logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- data -------------------------------------------------------------
    t0 = time.perf_counter()
    pts = pointclouds.load("susy", n_override=args.n)
    log(f"[data] susy {pts.shape} in {time.perf_counter() - t0:.1f}s")
    cfg = HybridConfig(k=K, m=6, gamma=0.4, rho=0.2, online_rebalance=False)
    rng = np.random.default_rng(1)

    # -- main path: (b) build + self-join, (c) R≠S, (d) brute ---------------
    stream_kernel.prefetch_launches = stream_kernel.padded_launches = 0
    topk_kernel.launches = hist_kernel.launches = 0
    stream_ops.oversized_k_reroutes = topk_ops.oversized_k_reroutes = 0
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    index = KNNIndex.build(pts, cfg, device="cuda")
    log(f"[b] build {time.perf_counter() - t0:.2f}s: eps={index.eps:.6g} "
        f"t_select_eps={index.t_select_eps:.3f}s t_build={index.t_build:.3f}s "
        f"backend={index.backend}")
    res = index.query(exclude_self=True)
    log(f"[b] self-join: {stats_line(res, len(pts))} sources={np.bincount(res.source, minlength=3).tolist()}")
    pts_d = torch.as_tensor(pts, device=dev)
    rows = torch.as_tensor(rng.choice(len(pts), ORACLE_ROWS, replace=False), device=dev)
    check_exact(pts_d, pts_d[rows], rows, res.dists[rows.cpu().numpy()],
                res.ids[rows.cpu().numpy()], "self-join")

    foreign = pointclouds.load("susy", n_override=FOREIGN_QUERIES)
    foreign = (foreign + rng.normal(0, 0.01, foreign.shape)).astype(np.float32)
    r1 = index.query(foreign)
    log(f"[c] R≠S #1: {stats_line(r1, FOREIGN_QUERIES)}")
    r2 = index.query(foreign)
    log(f"[c] R≠S #2: {stats_line(r2, FOREIGN_QUERIES)}")
    assert r2.stats.n_engine_compiles == 0, "steady-state R≠S query added engine buckets"
    fq = torch.as_tensor(foreign, device=dev)
    sub = rng.choice(FOREIGN_QUERIES, ORACLE_ROWS, replace=False)
    check_exact(pts_d, fq[sub], None, r2.dists[sub], r2.ids[sub], "R≠S")

    brute_rows = torch.cat([rows, torch.as_tensor(
        rng.choice(len(pts), BRUTE_QUERIES - ORACLE_ROWS), device=dev)])
    pr = index.points_r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bd, bi = brute_lib.brute_knn(pr, pr[brute_rows], brute_rows.to(torch.int32), k=K)
    torch.cuda.synchronize()
    t_brute = time.perf_counter() - t0
    log(f"[d] brute baseline: {BRUTE_QUERIES} queries × {len(pts)} in {t_brute:.2f}s "
        f"({BRUTE_QUERIES / t_brute:.1f} queries/s)")
    check_exact(pts_d, pts_d[rows], rows, torch.sqrt(bd[:ORACLE_ROWS]).cpu().numpy(),
                bi[:ORACLE_ROWS].cpu().numpy(), "brute")

    launches = {
        "knn_stream_topk_prefetch": stream_kernel.prefetch_launches,
        "knn_stream_topk_padded": stream_kernel.padded_launches,
        "knn_tile_topk": topk_kernel.launches,
        "distance_bin_histogram": hist_kernel.launches,
    }
    reroutes = {"knn_stream": stream_ops.oversized_k_reroutes,
                "knn_topk": topk_ops.oversized_k_reroutes}
    log(json.dumps({"launch_counters": launches, "oversized_k_reroutes": reroutes}))
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("knn_stream_topk_prefetch", "knn_tile_topk", "distance_bin_histogram"):
        assert launches[name] > 0, f"main path never launched {name}"
    assert not any(reroutes.values()), f"oversized-k reroutes on the main path: {reroutes}"

    # -- (a) every kernel against its plain version, on main-path inputs ---
    kernels = []

    # #1 knn_stream_topk_prefetch: the first dense batch's operands.
    split = split_lib.split_from_counts(torch.as_tensor(index.home_counts), K,
                                        index.grid.m, cfg.gamma, cfg.rho)
    dense_ids = np.nonzero(split.to_dense.numpy())[0]
    batch = WorkQueue(dense_ids, index.home_counts, cfg.n_batches).next_batch()
    qp = _pad_ids(batch, cfg.query_block, dev)
    ops_in, _, _, _ = dense_lib.fused_prefetch_operands(
        index.grid, pr, qp, cfg.dense_budget, cfg.query_block, cfg.block_c)
    qpts, corpus, blk, excl, cand = ops_in
    eps2 = torch.tensor(index.eps, dtype=torch.float32, device=dev) ** 2
    kw = dict(k=K, block_q=cfg.query_block, block_c=cfg.block_c)
    kd, ki, kf = stream_kernel.knn_stream_topk_prefetch(*ops_in, eps2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_prefetch_ref(*ops_in, eps2, **kw)
    torch.cuda.synchronize()
    n_tiles, nblk = blk.shape
    lanes = torch.arange(cfg.block_c, device=dev)

    def scored(r):
        t = r // cfg.query_block
        rows = (blk[t].long()[:, None] * cfg.block_c + lanes).reshape(-1)
        return corpus[rows][cand[t] >= 0]

    log(f"[a] knn_stream_topk_prefetch inputs: tiles={n_tiles} nblk={nblk}")
    err, _, _ = hold_topk("knn_stream_topk_prefetch", pr, qpts, kd, ki, rd, ri,
                          kf, rf, scored, eps2)
    ms = cuda_ms(lambda: stream_kernel.knn_stream_topk_prefetch(*ops_in, eps2, **kw))
    plain_ms = cuda_ms(lambda: stream_ref.knn_stream_topk_prefetch_ref(*ops_in, eps2, **kw),
                       reps=1, warmup=0)
    n_valid = int((cand >= 0).sum())
    dim = qpts.shape[1]
    touched = torch.unique(blk[(cand.reshape(n_tiles, nblk, -1) >= 0).any(-1)]).numel()
    nbytes = (qpts.numel() * 4 + touched * cfg.block_c * dim * 4 + blk.numel() * 4
              + excl.numel() * 4 + cand.numel() * 4 + kd.numel() * 8 + kf.numel() * 4)
    b_ms, b_by = bound(nbytes, n_valid * cfg.query_block * (2 * dim + 3))
    kernels.append(dict(name="knn_stream_topk_prefetch", route="cuda",
                        source="src/repro_torch/csrc/knn_stream.cu",
                        replaces="src/repro/kernels/knn_stream/kernel.py:220",
                        launches=launches["knn_stream_topk_prefetch"], max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))

    # #2 knn_stream_topk_padded (identity table): the batch's first 64 tiles
    # against one tile-budget-wide contiguous slice of the corpus.
    q2, qid2 = qpts[: 64 * cfg.query_block], excl[: 64 * cfg.query_block]
    c2 = corpus[: nblk * cfg.block_c]
    cid2 = index.grid.order[: c2.shape[0]].contiguous()
    kd, ki, kf = stream_ops.knn_stream_topk(q2, c2, qid2, cid2, eps2, **kw)
    rd, ri, rf = stream_ref.knn_stream_topk_ref(q2, c2, qid2, cid2, eps2, k=K)
    err, _, _ = hold_topk(f"knn_stream_topk_padded {tuple(q2.shape)} x {tuple(c2.shape)}",
                          pr, q2, kd, ki, rd, ri, kf, rf, lambda r: c2, eps2)
    ms = cuda_ms(lambda: stream_ops.knn_stream_topk(q2, c2, qid2, cid2, eps2, **kw))
    plain_ms = cuda_ms(lambda: stream_ref.knn_stream_topk_ref(q2, c2, qid2, cid2, eps2, k=K),
                       reps=1, warmup=0)
    nbytes = (q2.numel() + c2.numel()) * 4 + (qid2.numel() + cid2.numel()) * 4 + kd.numel() * 8
    b_ms, b_by = bound(nbytes, q2.shape[0] * c2.shape[0] * (2 * dim + 3))
    kernels.append(dict(name="knn_stream_topk_padded", route="cuda",
                        source="src/repro_torch/csrc/knn_stream.cu",
                        replaces="src/repro/kernels/knn_stream/kernel.py:275",
                        launches=launches["knn_stream_topk_padded"], max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))

    # #3 knn_tile_topk: the brute baseline's own call, its queries against
    # the whole corpus in one launch.  The plain version takes the corpus in
    # chunks merged with merge_running_topk, as the CPU brute lane does; the
    # library yardstick too, since the full (Q, |D|) matrix would not fit.
    q3 = pr[brute_rows].contiguous()
    qid3 = brute_rows.to(torch.int32)
    cid3 = torch.arange(len(pts), dtype=torch.int32, device=dev)
    kd, ki = topk_ops.knn_topk(q3, pr, qid3, cid3, k=K)

    def chunked(topk_of_chunk, chunk):
        run_d = torch.full((q3.shape[0], K), float("inf"), device=dev)
        run_i = torch.full((q3.shape[0], K), -1, dtype=torch.int32, device=dev)
        for c0 in range(0, len(pts), chunk):
            nd, ni = topk_of_chunk(pr[c0:c0 + chunk], cid3[c0:c0 + chunk])
            run_d, run_i = topk_ops.merge_running_topk(run_d, run_i, nd, ni, k=K)
        return run_d, run_i

    def library_topk(c, cid):
        vd, vi = torch.topk(torch.cdist(q3, c), K, dim=1, largest=False)
        return vd, cid[vi]

    (rd, ri), plain_ms = timed(lambda: chunked(
        lambda c, cid: topk_ref.knn_topk_ref(q3, c, qid3, cid, k=K), 8192))
    err, _, _ = hold_topk(f"knn_tile_topk {tuple(q3.shape)} x {tuple(pr.shape)}",
                          pr, q3, kd, ki, rd, ri)
    ms = cuda_ms(lambda: topk_ops.knn_topk(q3, pr, qid3, cid3, k=K), reps=3)
    lib_ms = cuda_ms(lambda: chunked(library_topk, 262_144), reps=1)
    nbytes = (q3.numel() + pr.numel()) * 4 + (qid3.numel() + cid3.numel()) * 4 + kd.numel() * 8
    b_ms, b_by = bound(nbytes, q3.shape[0] * pr.shape[0] * (2 * dim + 3))
    kernels.append(dict(name="knn_tile_topk", route="cuda",
                        source="src/repro_torch/csrc/knn_topk.cu",
                        replaces="src/repro/kernels/knn_topk/kernel.py:119",
                        launches=launches["knn_tile_topk"], max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms))

    # #4 distance_bin_histogram: the ε selection's own sample and bin width.
    n_q = min(cfg.n_query_sample, len(pts))
    ia, ib, qidx = eps_lib.sample_indices(len(pts), cfg.seed, n_pair_sample=cfg.n_pair_sample,
                                          n_query_sample=n_q, device=dev)
    bw = eps_lib.mean_pair_distance(pr, ia, ib) / cfg.n_bins
    q4 = pr[qidx].contiguous()
    kc = hist_ops.distance_bin_histogram(q4, pr, bw, cfg.n_bins, self_indices=qidx)
    pid = torch.arange(len(pts), dtype=torch.int32, device=dev)
    rc, plain_ms = timed(lambda: hist_ref.distance_bin_histogram_ref(
        q4, pr, qidx.to(torch.int32), pid, bw, n_bins=cfg.n_bins))
    # Bin b differs between the versions only by pairs near its two edges.
    near = bin_edge_pairs(q4, pr, bw, cfg.n_bins)
    allowed = (near[:-1] + near[1:]).to(kc.dtype)
    delta = (kc - rc).abs()
    err = delta.max().item()
    log(f"[a] distance_bin_histogram: {tuple(q4.shape)} × {tuple(pr.shape)} "
        f"bin-count |Δ| max={err:.0f} sum={delta.sum().item():.0f}; pairs near an edge "
        f"{int(near.sum())}, per-bin allowance min={allowed.min().item():.0f} "
        f"max={allowed.max().item():.0f}, largest |Δ|/allowance="
        f"{(delta / allowed.clamp(min=1)).max().item():.3f}; total kernel="
        f"{kc.sum().item():.0f} plain={rc.sum().item():.0f}")
    bad = (delta > allowed).nonzero()[:, 0].tolist()
    assert not bad, f"distance_bin_histogram: bins {bad[:8]} differ beyond their edge pairs"
    # Self pairs sit at d = 0: without the exclusion exactly S more in bin 0.
    extra = hist_ops.distance_bin_histogram(q4, pr, bw, cfg.n_bins) - kc
    n_self = int((qidx >= 0).sum())
    log(f"[a] distance_bin_histogram self exclusion: bin 0 +{extra[0].item():.0f} "
        f"without it (S={n_self}), other bins +{extra[1:].abs().sum().item():.0f}")
    assert extra[0].item() == n_self and not extra[1:].any(), \
        "distance_bin_histogram: the self pairs are not excluded from bin 0"
    ms = cuda_ms(lambda: hist_ops.distance_bin_histogram(q4, pr, bw, cfg.n_bins,
                                                         self_indices=qidx))
    hi = float(bw) * cfg.n_bins
    lib_ms = cuda_ms(lambda: torch.histc(torch.cdist(q4, pr), bins=cfg.n_bins, min=0.0, max=hi),
                     reps=3)
    nbytes = (q4.numel() + pr.numel()) * 4 + qidx.numel() * 4 + cfg.n_bins * 8
    b_ms, b_by = bound(nbytes, q4.shape[0] * pr.shape[0] * (2 * dim + 5))
    kernels.append(dict(name="distance_bin_histogram", route="cuda",
                        source="src/repro_torch/csrc/bin_hist.cu",
                        replaces="src/repro/kernels/bin_hist/kernel.py:80",
                        launches=launches["distance_bin_histogram"], max_abs_err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms))

    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
