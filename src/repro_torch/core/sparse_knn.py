"""Sparse engine — the grid-pyramid replacement for the paper's CPU
EXACT-ANN, in PyTorch.

Port of ``repro/core/sparse_knn.py``.  Level ℓ is an ε·2^ℓ grid.  A query
reads its 3^m-neighborhood population at every level, picks the finest
level with ≥ sel_factor·(K+1) candidates, gathers that level's candidates
under a fixed budget and keeps the K nearest.  A second pass escalates to
the first level whose certified radius covers the pass-1 k-th distance.
``found ≥ K ∧ kth ≤ cert_r(ℓ)² ∧ ¬overflow`` certifies the exact KNN;
uncertified queries fall back to the brute lane.

Backends: ``"ref"`` scores the gathered (B, budget, n) operand in the
difference form; ``"pallas"`` (``"interpret"`` on the CPU is its alias)
scores it in the expansion form |q|² + |c|² − 2q·c clamped at 0
(candidate sets are per query here, so the dense engine's shared-tile
kernel does not apply); ``"fused"`` streams
the budget in ``STREAM_CHUNK``-wide chunks through a running top-K
(``knn_topk.merge_running_topk``), so neither the full gathered operand nor
the (B, budget) distance tile exists.  This engine is plain tensor code,
with no kernel of its own.

Under ``metric="ip"`` every backend scores −q·c and nothing is certified
(ip has no triangle inequality), so the brute lane keeps exactness.  Under
``distance_dtype="bf16"`` the non-ref backends score bf16-cast operands at
k + ``BF16_OVERFETCH`` and rescore the survivors in exact fp32 before the
certificate is evaluated.

Every query is independent, so where the JAX package maps over 128-query
blocks, the port runs memory-bounded chunks of many blocks at once.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import dense_join as dense_lib
from repro_torch.core import grid as grid_lib
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.utils import round_up

# Candidate-chunk width of the fused streaming scan.
STREAM_CHUNK = 128

# Working-set target per chunk of queries: the (L, B, 3^m) start/count
# stacks (~35 KB per query at L=6, m=6) dominate.
_CHUNK_BYTES = 2 << 30


@dataclasses.dataclass
class Pyramid:
    levels: tuple                 # tuple[GridIndex] (no materialized points)
    cert_radii: torch.Tensor      # (L,) f32 — certified coverage radius per level


def build_pyramid(points_r: torch.Tensor, epsilon, m: int, n_levels: int = 6,
                  level_scale: float = 2.0) -> Pyramid:
    """L stacked ε·scale^ℓ grids over the (variance-reordered) data."""
    levels = []
    eps = torch.as_tensor(epsilon, dtype=points_r.dtype, device=points_r.device)
    for lvl in range(n_levels):
        levels.append(grid_lib.build_grid(points_r, eps * (level_scale**lvl), m,
                                          materialize_points=False))
    radii = torch.stack([g.cell_edge.min() for g in levels])
    return Pyramid(levels=tuple(levels), cert_radii=radii)


def pyramid_from_arrays(level_fields, cert_radii, *, m: int, n_points: int,
                        device) -> Pyramid:
    """The port's ``Pyramid`` from another package's built pyramid: one
    dict of numpy arrays per level (see ``grid.grid_from_arrays``)."""
    levels = tuple(grid_lib.grid_from_arrays(f, m=m, n_points=n_points, device=device)
                   for f in level_fields)
    return Pyramid(levels=levels,
                   cert_radii=torch.as_tensor(np.array(cert_radii), device=device))


class SparseKNNResult(NamedTuple):
    dists: torch.Tensor            # (Q, K) f32 squared L2 ascending, inf-padded
    ids: torch.Tensor              # (Q, K) i32, −1-padded
    certified: torch.Tensor        # (Q,) bool — exactness proven at chosen level
    level: torch.Tensor            # (Q,) i32 — pyramid level used
    total_candidates: torch.Tensor  # (Q,) i32 — work proxy (T₁ numerator)


def _streamed_topk(points_r, qpts, cand_ids, keep, k, metric="l2"):
    """The ``"fused"`` scan: the budget in ``STREAM_CHUNK``-wide chunks,
    gathering (cast to the query dtype), scoring in the expansion form and
    merging per chunk."""
    b, budget = cand_ids.shape
    cpad = round_up(budget, STREAM_CHUNK)
    if cpad != budget:
        cand_ids = torch.cat([cand_ids, cand_ids.new_zeros((b, cpad - budget))], 1)
        keep = torch.cat([keep, keep.new_zeros((b, cpad - budget))], 1)
    run_d = torch.full((b, k), float("inf"), device=qpts.device)
    run_i = torch.full((b, k), -1, dtype=torch.int32, device=qpts.device)
    for c0 in range(0, cpad, STREAM_CHUNK):
        ids_c = cand_ids[:, c0:c0 + STREAM_CHUNK]
        pts_c = points_r[ids_c.long()].to(qpts.dtype)               # (B, chunk, n)
        d2 = dense_lib._scores(qpts, pts_c, metric, expansion=True)
        keep_c = keep[:, c0:c0 + STREAM_CHUNK]
        d2m = torch.where(keep_c, d2, torch.full_like(d2, float("inf")))
        idm = torch.where(keep_c, ids_c, torch.full_like(ids_c, -1))
        run_d, run_i = topk_ops.merge_running_topk(run_d, run_i, d2m, idm, k=k)
    return run_d, torch.where(torch.isinf(run_d), torch.full_like(run_i, -1), run_i)


def _query_level(pyr, points_r, queries, orders, starts, counts, qids, excl,
                 safe, sel, k, budget, backend, metric, distance_dtype):
    """Gather + distance + top-K at per-query pyramid level ``sel`` (B,).
    Returns (kd, ki, certified, overflow, total)."""
    b = sel.shape[0]
    ar = torch.arange(b, device=sel.device)
    sel64 = sel.long()
    pos, valid, total, overflow = grid_lib.gather_candidates(
        pyr.levels[0], starts[sel64, ar], counts[sel64, ar], budget)
    cand_ids = orders[sel64[:, None], pos.long()]                     # (B, budget)
    qpts = queries[safe]
    keep = valid & (cand_ids != excl[:, None])
    # bf16: score at k + over-fetch, then rescore the survivors in exact
    # fp32 — the certificate below reads exact distances.  ref stays fp32.
    lowp = distance_dtype == "bf16" and backend != "ref"
    k_run = min(k + dense_lib.BF16_OVERFETCH, budget) if lowp else k
    qk = qpts.to(torch.bfloat16) if lowp else qpts
    if backend == "fused":
        kd, ki = _streamed_topk(points_r, qk, cand_ids, keep, k_run, metric)
    else:
        cand_pts = points_r[cand_ids.long()].to(qk.dtype)
        d2 = dense_lib._scores(qk, cand_pts, metric, expansion=backend != "ref")
        d2m = torch.where(keep, d2, torch.full_like(d2, float("inf")))
        kd, ki = dense_lib._topk_stable(d2m, cand_ids, k_run)
    if lowp:
        kd, ki, _ = dense_lib._rescore_fp32(points_r, qpts, ki, float("inf"), k, metric)
    found = torch.isfinite(kd).sum(1)
    if metric == "ip":
        # No triangle inequality: a grid neighborhood certifies nothing
        # about ip neighbors, so every query goes to the brute lane.
        certified = torch.zeros_like(qids >= 0)
    else:
        cert_r = pyr.cert_radii[sel64]
        certified = ((found >= k) & (kd[:, k - 1] <= cert_r**2) & ~overflow
                     & (qids >= 0))
    return kd, ki, certified, overflow, total


def _level_search(pyr, points_r, qids, k, budget, sel_factor, backend, queries,
                  foreign, exclude_self, orders, offs, metric, distance_dtype):
    """Two-pass adaptive level search for one chunk of query ids."""
    n_levels = len(pyr.levels)
    m = pyr.levels[0].m
    safe = torch.clamp(qids, 0, queries.shape[0] - 1).long()
    excl = dense_lib._exclusion_ids(qids, exclude_self)
    qproj = queries[safe][:, :m] if foreign else None
    starts_l, counts_l = [], []
    for g in pyr.levels:
        coords = g.point_coords[safe] if qproj is None else grid_lib.compute_cell_coords(g, qproj)
        s, c = grid_lib.neighbor_ranges(g, coords, offs)
        starts_l.append(s)
        counts_l.append(c)
    starts = torch.stack(starts_l)                                   # (L, B, R)
    counts = torch.stack(counts_l)

    totals = counts.sum(-1)                                          # (L, B)
    enough = totals >= sel_factor * (k + 1)
    first = torch.argmax(enough.to(torch.int8), 0).to(torch.int32)
    sel1 = torch.where(enough.any(0), first, torch.full_like(first, n_levels - 1))
    args = (pyr, points_r, queries, orders, starts, counts, qids, excl, safe)
    kd1, ki1, cert1, _, tot1 = _query_level(*args, sel1, k, budget, backend,
                                            metric, distance_dtype)

    # Escalation level: first ℓ with cert_r(ℓ)² ≥ pass-1 kth (∞ → coarsest).
    cert_r2 = pyr.cert_radii**2
    sel2 = torch.searchsorted(cert_r2.contiguous(), kd1[:, k - 1].contiguous(),
                              out_int32=True)
    sel2 = torch.clamp(torch.maximum(sel2, sel1), 0, n_levels - 1)
    kd2, ki2, cert2, _, tot2 = _query_level(*args, sel2, k, budget, backend,
                                            metric, distance_dtype)

    use1 = cert1[:, None]
    return (torch.where(use1, kd1, kd2), torch.where(use1, ki1, ki2),
            cert1 | cert2, torch.where(cert1, sel1, sel2),
            tot1 + torch.where(cert1, torch.zeros_like(tot2), tot2))


def sparse_knn(pyr: Pyramid, points_r: torch.Tensor, query_ids: torch.Tensor,
               queries_r=None, *, k: int, budget: int = 512,
               query_block: int = 128, sel_factor: int = 4,
               backend: str = "ref", exclude_self: bool = True,
               metric: str = "l2", distance_dtype: str = "fp32") -> SparseKNNResult:
    """Pyramid search for the given query ids (−1 = padding).  With
    ``queries_r`` the ids index a foreign (R≠S) query cloud and per-level
    cell coords are computed on the fly.  ``metric`` is the kernel metric
    (``"l2"``/``"ip"``)."""
    backend = dense_lib.resolve_backend(backend, points_r.device)
    dense_lib.check_engine_args(metric, distance_dtype)
    dev = points_r.device
    n = query_ids.shape[0]
    qpad = round_up(n, query_block)
    qids = torch.full((qpad,), -1, dtype=torch.int32, device=dev)
    qids[:n] = query_ids
    queries = points_r if queries_r is None else queries_r
    orders = torch.stack([g.order for g in pyr.levels])             # (L, |D|)
    m = pyr.levels[0].m
    offs = torch.as_tensor(grid_lib.neighbor_offsets(m), device=dev)
    per_query = len(pyr.levels) * (3 ** m) * (m * 4 + 40) + budget * 64
    chunk = max(query_block, (_CHUNK_BYTES // per_query) // query_block * query_block)
    outs = [
        _level_search(pyr, points_r, qids[q0:q0 + chunk], k, budget, sel_factor,
                      backend, queries, queries_r is not None, exclude_self,
                      orders, offs, metric, distance_dtype)
        for q0 in range(0, qpad, chunk)
    ]
    kd, ki, cert, lvl, total = (torch.cat(x) for x in zip(*outs))
    return SparseKNNResult(kd[:n], ki[:n], cert[:n], lvl[:n], total[:n])
