"""REFIMPL — the paper's CPU-only parallel reference (§VI-C), in PyTorch.

Port of ``repro/core/refimpl.py``.  The paper parallelizes exact-ANN over
|p| MPI ranks with round-robin query assignment and no inter-rank
communication.  The reference is the work-efficient engine the hybrid uses
for its sparse path (pyramid + brute certification), run over *all* of D.
Each simulated rank's share is timed separately on this host, and speedup
is Σ t_rank / max t_rank — the paper's load-balance claim is about
partition evenness, which this measures on any core count."""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from repro_torch.core import brute as brute_lib
from repro_torch.core import epsilon as eps_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.core.hybrid import HybridConfig, JoinStats, KNNResult, _pad_ids
from repro_torch.utils import resolve_device


def _exact_engine(points_r: torch.Tensor, pyramid, query_ids: np.ndarray,
                  cfg: HybridConfig):
    """Work-efficient exact KNN for a query-id list (pyramid + backstop):
    the sparse engine, then the brute lane for every uncertified query.
    Returns squared distances and ids as numpy arrays."""
    dev = points_r.device
    qp = _pad_ids(np.asarray(query_ids, np.int32), cfg.query_block, dev)
    sres = sparse_lib.sparse_knn(
        pyramid, points_r, qp, k=cfg.k, budget=cfg.sparse_budget,
        query_block=cfg.query_block, sel_factor=cfg.sel_factor)
    n = len(query_ids)
    d = sres.dists[:n].cpu().numpy()
    i = sres.ids[:n].cpu().numpy()
    cert = sres.certified[:n].cpu().numpy()
    uncert = np.asarray(query_ids)[~cert].astype(np.int32)
    if len(uncert):
        # Only the uncertified rows are scored (the reference pads them to
        # a pow2 bucket for its compile cache; padding rows change nothing).
        ub = torch.as_tensor(uncert, device=dev)
        bd, bi = brute_lib.brute_knn(points_r, points_r[ub.long()], ub, k=cfg.k,
                                     corpus_chunk=cfg.brute_chunk)
        rows = np.nonzero(~cert)[0]
        d[rows] = bd.cpu().numpy()
        i[rows] = bi.cpu().numpy()
    return d, i


def refimpl_knn(points, k: int, cfg: HybridConfig | None = None,
                n_ranks: int = 1, *, device="cuda"):
    """Exact KNN self-join of all points, partitioned round-robin over
    ``n_ranks`` simulated shared-nothing ranks, on ``device`` (``"cuda"``
    unless the caller asks for the CPU; a missing card raises).

    Returns (KNNResult, rank_times: list[float]).  Response time of the
    parallel execution is max(rank_times) (shared-nothing, no comm)."""
    dev = resolve_device(device)
    cfg = cfg or HybridConfig(k=k)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    npts = pts.shape[0]
    m = min(cfg.m, pts.shape[1])
    if cfg.reorder:
        points_r = grid_lib.reorder_by_variance(pts)[0].contiguous()
    else:
        points_r = pts

    # ε only sizes the pyramid's finest level here; REFIMPL itself has no ε.
    sel = eps_lib.select_epsilon(
        points_r, cfg.seed, k, 0.0, n_query_sample=min(cfg.n_query_sample, npts),
        n_bins=cfg.n_bins, n_pair_sample=cfg.n_pair_sample)
    pyramid = sparse_lib.build_pyramid(points_r, sel.epsilon, m, n_levels=cfg.n_levels,
                                       level_scale=cfg.level_scale)

    final_d = np.full((npts, k), np.inf, np.float32)
    final_i = np.full((npts, k), -1, np.int32)
    rank_times: List[float] = []
    all_ids = np.arange(npts, dtype=np.int32)
    for rank in range(n_ranks):
        share = all_ids[all_ids % n_ranks == rank]       # round-robin (§VI-C)
        if not len(share):
            rank_times.append(0.0)
            continue
        t0 = time.perf_counter()
        d, i = _exact_engine(points_r, pyramid, share, cfg)
        rank_times.append(time.perf_counter() - t0)
        final_d[share] = d
        final_i[share] = i

    stats = JoinStats(epsilon=float(sel.epsilon))
    stats.t_sparse = max(rank_times)
    return (
        KNNResult(dists=np.sqrt(np.maximum(final_d, 0.0)), ids=final_i,
                  source=np.ones((npts,), np.int8), stats=stats),
        rank_times,
    )
