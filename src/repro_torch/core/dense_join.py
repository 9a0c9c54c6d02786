"""Dense engine — the paper's GPU-JOIN (§V-B/§V-E), in PyTorch.

Port of ``repro/core/dense_join.py``.  Range-queries the ε-grid around
each assigned query, filters the 3^m-cell candidate set with
full-dimension distances and keeps the K nearest within ε.  A query FAILS
iff it finds < K neighbors within ε, or its candidate set overflowed the
budget (so exactness cannot be certified); failures go to the sparse
engine.

Three backends share those semantics:

  * ``"ref"`` — per-query gather + difference-form distances (the
    correctness oracle), run over memory-bounded chunks of queries;
  * ``"pallas"`` — the cell-tiled two-pass path: queries are grouped into
    cell-sorted tiles, each tile gathers ONE deduplicated candidate block
    (``grid.tile_shared_candidates``), the ``pairwise_l2`` kernel writes
    the (TQ, TC) distance tiles of a whole chunk of tiles in one launch
    (with the SHORTC ε² tile short-circuit under l2), and a second pass of
    plain tensor code filters at ε² and keeps the top K.  ``"interpret"``
    is an alias of ``"pallas"`` for CPU tensors (where the kernel's plain
    version runs); on a CUDA device it raises, so nothing on the card
    skips the kernel;
  * ``"fused"`` — the streaming one-pass engine: each tile's deduplicated
    3^m cell ranges become a block table (``_tile_block_tables``) and the
    ``knn_stream`` kernel reads those corpus blocks in place, filters at
    ε² and keeps a running top-K — no (block, budget) distance tile and no
    gathered candidate copy exists.  When k (+ the bf16 over-fetch)
    exceeds ``MAX_UNROLLED_K`` the gathered route (``_gathered_join``:
    each tile's gathered candidate union, one kernel launch per chunk of
    tiles) takes over, always at fp32.

``metric`` is the kernel score space: ``"l2"`` squared L2 (which cosine
indexes reuse over unit rows) or ``"ip"`` the negated inner product, where
ε² is a plain score threshold and SHORTC is off.  ``distance_dtype="bf16"``
(fused backend only; ref and tiled always serve fp32) streams bf16-cast
operands through the kernel at k + ``BF16_OVERFETCH`` slots with the keep
threshold inflated by ``BF16_EPS_SLACK``, then rescores the survivors in
exact fp32 (``_rescore_fp32``) and re-applies the exact ε².

``"auto"`` resolves to ``"fused"`` on a CUDA device and ``"ref"`` on the
CPU.  If ``found ≥ K`` and nothing overflowed, the K neighbors are the
exact global KNN (the 3^m neighborhood of an edge-≥ε grid covers the
ε-ball).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import grid as grid_lib
from repro_torch.core.hybrid import BACKENDS, DISTANCE_DTYPES
from repro_torch.kernels.knn_stream import kernel as stream_kernel
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.kernels.pairwise_l2 import ops as pairwise_ops
from repro_torch.utils import INT32_SENTINEL, cdiv, round_up

# bf16 distance mode: extra top-k slots streamed before the fp32 rescore,
# and the relative inflation of the keep threshold that absorbs the cast's
# rounding near ε² (the rescore re-applies the exact ε²).
BF16_OVERFETCH = 8
BF16_EPS_SLACK = 0.125

# Extra corpus-block slots past ceil(budget/block_c) in a tile's block
# table: rounding the deduped cell ranges to block_c-aligned blocks can
# touch a few more blocks than the budget's worth of rows.  Exceeding the
# table is a per-tile overflow failure, like exceeding the row budget.
PREFETCH_BLOCK_SLACK = 2

# Working-set target of the chunked passes below (tile metadata, ref-backend
# gathers, tiled distance tiles): eager PyTorch materializes what jit fused,
# so large batches run over chunks sized to stay near this many bytes.
_CHUNK_BYTES = 2 << 30


def resolve_backend(backend: str, device) -> str:
    """Collapse ``"auto"``: the fused engine on a CUDA device, ref on the
    CPU.  ``"interpret"`` names the tiled route on CPU tensors and resolves
    to ``"pallas"``; on a CUDA device it raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    cuda = torch.device(device).type == "cuda"
    if backend == "interpret" and cuda:
        raise ValueError(
            "backend='interpret' runs the tiled path's plain PyTorch version "
            "and serves CPU tensors only; on a CUDA device use backend='pallas', "
            "which launches the pairwise_sq_l2 kernel")
    if backend == "auto":
        return "fused" if cuda else "ref"
    return "pallas" if backend == "interpret" else backend


def check_engine_args(metric: str, distance_dtype: str) -> None:
    """Reject a kernel metric or distance dtype no engine serves."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"kernel metric must be 'l2' or 'ip', got {metric!r}")
    if distance_dtype not in DISTANCE_DTYPES:
        raise ValueError(f"distance_dtype must be one of {DISTANCE_DTYPES}, "
                         f"got {distance_dtype!r}")


class DenseJoinResult(NamedTuple):
    dists: torch.Tensor             # (Q, K) f32 squared L2, ascending, inf-padded
    ids: torch.Tensor               # (Q, K) i32, −1-padded
    found: torch.Tensor             # (Q,) i32 neighbors within ε (self excluded)
    failed: torch.Tensor            # (Q,) bool — < K within ε, or overflow
    total_candidates: torch.Tensor  # (Q,) i32 — filtering workload (T₂ proxy)


def _exclusion_ids(qids: torch.Tensor, exclude_self: bool) -> torch.Tensor:
    """Id each query must not match: itself for a self-join, else −2,
    which matches no candidate id (≥ 0) and not the −1 invalid marker."""
    return qids if exclude_self else torch.full_like(qids, -2)


def _topk_stable(d: torch.Tensor, ids: torch.Tensor, k: int):
    """k smallest along the last axis with ids (lowest column first on
    ties, as ``lax.top_k`` on the negated distances); ``ids`` broadcasts
    against ``d``; ids −1 where inf."""
    vals, sel = torch.sort(d, dim=-1, stable=True)
    kd = vals[..., :k]
    ki = ids.expand_as(d).gather(-1, sel[..., :k])
    return kd, torch.where(torch.isinf(kd), torch.full_like(ki, -1), ki)


def _scores(qpts, cand_pts, metric, expansion=False):
    """(B, n) queries vs per-query (B, C, n) candidates -> (B, C) f32
    scores: −q·c under ip; else squared L2 in the difference form, or with
    ``expansion`` in the form |q|² + |c|² − 2q·c clamped at 0.  bf16
    operands are upcast exactly, so every score is an exact-f32 function
    of the bf16-cast inputs."""
    q, c = qpts.float(), cand_pts.float()
    if metric == "ip":
        return -(q[:, None, :] * c).sum(-1)
    if not expansion:
        diff = q[:, None, :] - c
        return (diff * diff).sum(-1)
    qq = (q * q).sum(-1)[:, None]
    cc = (c * c).sum(-1)
    qc = (q[:, None, :] * c).sum(-1)
    return torch.clamp(qq + cc - 2.0 * qc, min=0.0)


def _ref_join(index, points_r, qids, eps2, k, budget, queries, coords_all,
              exclude_self, metric):
    """The ``"ref"`` backend over chunks of queries: each query gathers its
    own budget of candidates and scores them in the difference form."""
    n_dim = points_r.shape[1]
    r = 3 ** index.m
    per_query = budget * (n_dim * 8 + 48) + r * (index.m * 4 + 48)
    chunk = max(128, _CHUNK_BYTES // per_query)
    outs = []
    for q0 in range(0, qids.shape[0], chunk):
        q = qids[q0:q0 + chunk]
        safe = torch.clamp(q, 0, queries.shape[0] - 1).long()
        starts, counts = grid_lib.neighbor_ranges(index, coords_all[safe])
        pos, valid, total, overflow = grid_lib.gather_candidates(
            index, starts, counts, budget)
        pos = pos.long()
        cand_ids = index.order[pos]
        d2 = _scores(queries[safe], index.points_sorted[pos], metric)  # (B, budget)
        self_pair = cand_ids == _exclusion_ids(q, exclude_self)[:, None]
        keep = valid & ~self_pair & (d2 <= eps2)
        d2m = torch.where(keep, d2, torch.full_like(d2, float("inf")))
        kd, ki = _topk_stable(d2m, cand_ids, k)
        found = keep.sum(1).to(torch.int32)
        outs.append((kd, ki, found, (found < k) | overflow, total))
    return tuple(torch.cat(x) for x in zip(*outs))


def _tile_block_tables(index, coords_all, queries, tiles, nblk, n_cb, budget,
                       block_c):
    """Per query tile, turn the deduped 3^m cell ranges into (a) the list of
    ``block_c``-aligned corpus blocks the kernel must read and (b) a
    block-aligned candidate-id operand whose rows outside the deduped
    union carry −1 — so the kernel's keep predicate scores exactly the
    ``tile_shared_candidates`` union.  Only int32 metadata is built.

    Runs over chunks of tiles (the JAX package vmaps it over all tiles;
    eagerly that would materialize every tile's (n_cb + 1) marks vector at
    once).  Returns (block_table (T, nblk) i32, cand_ids (T, nblk·block_c)
    i32, own_total (T, TQ) i32, tile_overflow (T,) bool)."""
    n_tiles, tq = tiles.shape
    npts = index.n_points
    dev = tiles.device
    r = 3 ** index.m
    offs = torch.as_tensor(grid_lib.neighbor_offsets(index.m), device=dev)
    lanes = torch.arange(block_c, dtype=torch.int32, device=dev)
    slots = torch.arange(nblk, dtype=torch.int32, device=dev)
    blocks = torch.arange(n_cb, dtype=torch.int32, device=dev)
    per_tile = tq * r * (index.m * 4 + 96) + (n_cb + 1) * 16 + nblk * block_c * 40
    chunk = max(1, _CHUNK_BYTES // per_tile)
    outs = []
    for t0 in range(0, n_tiles, chunk):
        qids = tiles[t0:t0 + chunk]                                  # (tc, TQ)
        tc = qids.shape[0]
        safe = torch.clamp(qids, 0, queries.shape[0] - 1).long()
        starts, counts = grid_lib.neighbor_ranges(
            index, coords_all[safe].reshape(tc * tq, -1), offs)
        # Padding rows clip to point 0 — zero their ranges so a partial
        # tile's union holds only real queries' neighborhoods.
        counts = counts.reshape(tc, tq, r) * (qids >= 0)[:, :, None]
        own_total = counts.sum(-1, dtype=torch.int32)
        flat_s = starts.reshape(tc, tq * r)
        flat_c = counts.reshape(tc, tq * r)

        # Dedup by range start (a start uniquely keys its cell).
        key = torch.where(flat_c > 0, flat_s, torch.full_like(flat_s, INT32_SENTINEL))
        key_s, order = torch.sort(key, dim=1, stable=True)
        s_sorted = flat_s.gather(1, order)
        c_sorted = flat_c.gather(1, order)
        dup = torch.zeros_like(key_s, dtype=torch.bool)
        dup[:, 1:] = key_s[:, 1:] == key_s[:, :-1]
        uniq = (key_s != INT32_SENTINEL) & ~dup
        total = torch.where(uniq, c_sorted, 0).sum(1)

        # Touched corpus blocks by interval stabbing: +1 at each unique
        # range's first block, −1 after its last, running sum > 0.
        first = torch.clamp(torch.div(s_sorted, block_c, rounding_mode="floor"), 0, n_cb - 1)
        last = torch.clamp(torch.div(s_sorted + c_sorted - 1, block_c, rounding_mode="floor"),
                           0, n_cb - 1)
        marks = torch.zeros((tc, n_cb + 1), dtype=torch.int32, device=dev)
        u32 = uniq.to(torch.int32)
        marks.scatter_add_(1, torch.where(uniq, first, n_cb).long(), u32)
        marks.scatter_add_(1, torch.where(uniq, last + 1, n_cb).long(), -u32)
        touched = torch.cumsum(marks[:, :-1], 1, dtype=torch.int32) > 0   # (tc, n_cb)
        n_touched = touched.sum(1)
        # Touched blocks first, ascending (the JAX stable argsort of
        # ~touched); unused slots read block 0 with all-masked ids.
        rank = torch.cumsum(touched, 1, dtype=torch.int32) - 1
        dest = torch.where(touched & (rank < nblk), rank, nblk).long()
        blk = torch.zeros((tc, nblk + 1), dtype=torch.int32, device=dev)
        blk.scatter_(1, dest, blocks.expand(tc, n_cb))
        blk = blk[:, :nblk].contiguous()
        slot_ok = slots[None, :] < n_touched[:, None]

        # Membership of each aligned row: cell slices are disjoint, so row
        # p is in the union iff the last range with start ≤ p covers it.
        pos = (blk[:, :, None] * block_c + lanes).reshape(tc, nblk * block_c)
        j = torch.searchsorted(key_s, pos, right=True, out_int32=True) - 1
        js = torch.clamp(j, 0, key_s.shape[1] - 1).long()
        member = (
            (j >= 0)
            & (key_s.gather(1, js) != INT32_SENTINEL)
            & (pos < s_sorted.gather(1, js) + c_sorted.gather(1, js))
            & slot_ok.repeat_interleave(block_c, dim=1)
        )
        rows = index.order[torch.clamp(pos, 0, npts - 1).long()]
        cand = torch.where(member, rows, torch.full_like(rows, -1))
        overflow = (total > budget) | (n_touched > nblk)
        outs.append((blk, cand, own_total, overflow))
    return tuple(torch.cat(x) for x in zip(*outs))


def fused_prefetch_operands(index, points_r, qids, budget, query_block, block_c,
                            queries_r=None, qcoords=None, exclude_self=True):
    """Everything the block-table kernel call of ``_fused_prefetch_join``
    takes, for padded query ids ``qids``: (queries, corpus, block_table,
    exclusion ids, cand_ids) plus own_total, tile_overflow and the
    cell-sort permutation ``perm``."""
    queries = points_r if queries_r is None else queries_r
    coords_all = index.point_coords if qcoords is None else qcoords
    tiles, perm = grid_lib.group_queries_by_cell(index, qids, query_block, qcoords)
    n_cb = max(1, cdiv(index.n_points, block_c))
    nblk = min(round_up(budget, block_c) // block_c + PREFETCH_BLOCK_SLACK, n_cb)
    blk, cand, own_total, tile_ovf = _tile_block_tables(
        index, coords_all, queries, tiles, nblk, n_cb, budget, block_c)
    flat = tiles.reshape(-1)
    qpts = queries[torch.clamp(flat, 0, queries.shape[0] - 1).long()].contiguous()
    excl = _exclusion_ids(flat, exclude_self).contiguous()
    corpus = index.points_sorted
    c_pad = n_cb * block_c
    if c_pad != corpus.shape[0]:
        padded = torch.zeros((c_pad, corpus.shape[1]), dtype=corpus.dtype,
                             device=corpus.device)
        padded[: corpus.shape[0]] = corpus
        corpus = padded
    return (qpts, corpus.contiguous(), blk, excl, cand), own_total, tile_ovf, perm


def _rescore_fp32(points_r, qpts, ki, eps2, k, metric):
    """Exact fp32 rescore of the bf16 pass's over-fetched survivors: gather
    the (Q, k_run, n) candidate rows by id, recompute the distances at full
    precision, re-apply the exact ε² filter and keep the k best.  Returns
    (kd (Q, k), ki (Q, k), n_true (Q,) i32 — survivors within the exact ε²,
    the §V-E failure evidence)."""
    cand = points_r[torch.clamp(ki, 0, points_r.shape[0] - 1).long()]
    d = _scores(qpts, cand, metric)
    keep = (ki >= 0) & (d <= eps2)
    dm = torch.where(keep, d, torch.full_like(d, float("inf")))
    kd, kid = _topk_stable(dm, ki, k)
    return kd, kid, keep.sum(1, dtype=torch.int32)


def _unpermute(perm, outs):
    """Scatter cell-sorted rows back to the original query order."""
    perm = perm.long()
    res = []
    for x in outs:
        y = torch.zeros_like(x)
        y[perm] = x
        res.append(y)
    return tuple(res)


def _fused_prefetch_join(index, points_r, qids, eps2, k, budget, query_block,
                         block_c, queries_r=None, qcoords=None, exclude_self=True,
                         metric="l2", distance_dtype="fp32"):
    """The fused backend: one ``knn_stream`` launch over every tile of the
    batch; results scattered back to the original query order."""
    operands, own_total, tile_ovf, perm = fused_prefetch_operands(
        index, points_r, qids, budget, query_block, block_c, queries_r,
        qcoords, exclude_self)
    bf16 = distance_dtype == "bf16"
    if bf16:
        qpts, corpus = operands[:2]
        operands = (qpts.to(torch.bfloat16), corpus.to(torch.bfloat16)) + operands[2:]
        # Multiplicative slack on the runtime ε²; abs() keeps it an
        # inflation for ip's negative thresholds.
        eps_keep = eps2 + BF16_EPS_SLACK * torch.abs(eps2)
    else:
        eps_keep = eps2
    kd, ki, found = stream_ops.knn_stream_topk_prefetch(
        *operands, eps_keep, k=k + (BF16_OVERFETCH if bf16 else 0),
        block_q=query_block, block_c=block_c, metric=metric)
    if bf16:
        kd, ki, n_true = _rescore_fp32(points_r, qpts, ki, eps2, k, metric)
        # found counts at the inflated threshold (an over-estimate near the
        # boundary); n_true < k proves the exact-ε survivors fall short.
        failed = (found < k) | (n_true < k)
    else:
        failed = found < k
    failed = failed | tile_ovf.repeat_interleave(query_block)
    return _unpermute(perm, (kd, ki, found, failed, own_total.reshape(-1)))


def tiles_per_chunk(index, n_dim: int, query_block: int, budget: int,
                    block_c: int) -> int:
    """Tiles the tiled and the gathered routes process per step: their
    range stacks, gathered candidates and (TQ, TC) distance tile (with the
    sort's values and indices; the gathered route's plain version builds
    it too) stay near ``_CHUNK_BYTES``."""
    cand = round_up(budget, block_c)
    per_tile = (query_block * 3 ** index.m * (index.m * 4 + 96)
                + cand * (n_dim * 8 + 32) + query_block * cand * 32)
    return max(1, _CHUNK_BYTES // per_tile)


def tiled_candidates(index, points_r, tiles, budget, block_c, queries_r=None,
                     qcoords=None):
    """The tiled route's gather for a chunk of cell-sorted query tiles
    (T, TQ) (−1 = padding): each tile's ONE deduplicated candidate block.
    Returns (qpts (T, TQ, n), cand_ids (T, TC) i32 −1-padded, cand_pts
    (T, TC, n), own_total (T, TQ) i32 — each query's own 3^m total, the T₂
    proxy — and tile_overflow (T,) bool), TC = round_up(budget, block_c)."""
    queries = points_r if queries_r is None else queries_r
    coords_all = index.point_coords if qcoords is None else qcoords
    n_tiles, tq = tiles.shape
    safe = torch.clamp(tiles, 0, queries.shape[0] - 1).long()
    starts, counts = grid_lib.neighbor_ranges(
        index, coords_all[safe].reshape(n_tiles * tq, -1))
    r = starts.shape[1]
    # Padding rows clip to point 0 — zero their ranges so a partial tile's
    # union holds only real queries' neighborhoods.
    counts = counts.reshape(n_tiles, tq, r) * (tiles >= 0)[:, :, None]
    pos, valid, _, overflow = grid_lib.tile_shared_candidates(
        index, starts.reshape(n_tiles, tq, r), counts, round_up(budget, block_c))
    pos = pos.long()
    cand_ids = torch.where(valid, index.order[pos], torch.full_like(pos, -1, dtype=torch.int32))
    return (queries[safe], cand_ids, index.points_sorted[pos],
            counts.sum(-1, dtype=torch.int32), overflow)


def _gathered_join(index, points_r, qids, eps2, k, budget, query_block, block_c,
                   queries_r=None, qcoords=None, exclude_self=True, metric="l2"):
    """Gathered one-pass route for k (+ over-fetch) > MAX_UNROLLED_K: per
    chunk of cell-sorted tiles (``tiles_per_chunk``), each tile gathers its
    shared candidate union (``tiled_candidates``) and one ``knn_stream``
    launch streams every tile through its own union at fp32 (k >
    MAX_UNROLLED_K goes to the plain version).  The JAX package maps the
    same work over the tiles one at a time."""
    tiles, perm = grid_lib.group_queries_by_cell(index, qids, query_block, qcoords)
    chunk = tiles_per_chunk(index, points_r.shape[1], query_block, budget, block_c)
    outs = []
    for t0 in range(0, tiles.shape[0], chunk):
        t = tiles[t0:t0 + chunk]
        qpts, cand_ids, cand_pts, own_total, tile_ovf = tiled_candidates(
            index, points_r, t, budget, block_c, queries_r, qcoords)
        kd, ki, found = stream_ops.knn_stream_topk_tiles(
            qpts, cand_pts, _exclusion_ids(t, exclude_self), cand_ids, eps2, k=k,
            block_c=block_c, metric=metric)
        failed = (found < k) | tile_ovf.repeat_interleave(query_block)
        outs.append((kd, ki, found, failed, own_total.reshape(-1)))
    return _unpermute(perm, (torch.cat(x) for x in zip(*outs)))


def _tiled_join(index, points_r, qids, eps2, k, budget, query_block, block_c,
                queries_r=None, qcoords=None, exclude_self=True, metric="l2"):
    """The tiled backend: per chunk of cell-sorted tiles, one ``pairwise_l2``
    launch writes every tile's (TQ, TC) distance tile, then the ε² filter,
    the exclusion and a stable top-K run as plain tensor code."""
    tiles, perm = grid_lib.group_queries_by_cell(index, qids, query_block, qcoords)
    chunk = tiles_per_chunk(index, points_r.shape[1], query_block, budget, block_c)
    outs = []
    for t0 in range(0, tiles.shape[0], chunk):
        t = tiles[t0:t0 + chunk]
        qpts, cand_ids, cand_pts, own_total, tile_ovf = tiled_candidates(
            index, points_r, t, budget, block_c, queries_r, qcoords)
        d2 = pairwise_ops.pairwise_sq_l2_batched(
            qpts, cand_pts, block_q=query_block, block_c=block_c,
            # SHORTC's monotone partial sums hold for l2 only; under ip the
            # ε² cutoff below is a plain score filter.
            shortc_eps2=None if metric == "ip" else eps2, metric=metric)  # (T, TQ, TC)
        cid = cand_ids[:, None, :]
        keep = (cid >= 0) & (cid != _exclusion_ids(t, exclude_self)[:, :, None]) & (d2 <= eps2)
        kd, ki = _topk_stable(torch.where(keep, d2, torch.full_like(d2, float("inf"))),
                              cid, k)
        found = keep.sum(-1, dtype=torch.int32)
        # The shared block holds the tile's union, so truncation fails every
        # query of the tile at once.
        failed = (found < k) | tile_ovf[:, None]
        outs.append((kd.reshape(-1, k), ki.reshape(-1, k), found.reshape(-1),
                     failed.reshape(-1), own_total.reshape(-1)))
    return _unpermute(perm, (torch.cat(x) for x in zip(*outs)))


def dense_join(index: grid_lib.GridIndex, points_r: torch.Tensor,
               query_ids: torch.Tensor, epsilon, queries_r=None, *, k: int,
               budget: int = 1024, query_block: int = 128, block_c: int = 128,
               backend: str = "ref", exclude_self: bool = True,
               metric: str = "l2", distance_dtype: str = "fp32") -> DenseJoinResult:
    """Run GPU-JOIN over the given query ids (−1 = padding).  Results are
    aligned with ``query_ids``; padding rows are failed.

    With ``queries_r`` the join is a foreign (R≠S) join: ids index
    ``queries_r`` rows (already in the reference's reordered dim space),
    home cells are computed against the reference grid, and
    ``exclude_self`` decides whether query i may report reference point i.
    ``metric`` is the kernel metric (``"l2"``/``"ip"``); ``distance_dtype``
    applies to the fused backend (module docstring)."""
    backend = resolve_backend(backend, points_r.device)
    check_engine_args(metric, distance_dtype)
    dev = points_r.device
    n = query_ids.shape[0]
    qpad = round_up(n, query_block)
    qids = torch.full((qpad,), -1, dtype=torch.int32, device=dev)
    qids[:n] = query_ids
    eps2 = torch.as_tensor(epsilon, dtype=torch.float32, device=dev) ** 2
    queries = points_r if queries_r is None else queries_r
    qcoords = (None if queries_r is None
               else grid_lib.compute_cell_coords(index, queries_r[:, : index.m]))
    coords_all = index.point_coords if qcoords is None else qcoords
    fused_k_run = k + (BF16_OVERFETCH if distance_dtype == "bf16" else 0)
    route = (queries_r, qcoords, exclude_self, metric)

    if backend == "ref":
        kd, ki, found, failed, total = _ref_join(
            index, points_r, qids, eps2, k, budget, queries, coords_all,
            exclude_self, metric)
    elif backend == "pallas":
        kd, ki, found, failed, total = _tiled_join(
            index, points_r, qids, eps2, k, budget, query_block, block_c, *route)
    elif fused_k_run <= stream_kernel.MAX_UNROLLED_K:
        kd, ki, found, failed, total = _fused_prefetch_join(
            index, points_r, qids, eps2, k, budget, query_block, block_c,
            *route, distance_dtype)
    else:
        kd, ki, found, failed, total = _gathered_join(
            index, points_r, qids, eps2, k, budget, query_block, block_c, *route)
    pad_row = torch.arange(qpad, device=dev) >= n
    failed = failed | pad_row | (qids < 0)
    return DenseJoinResult(kd[:n], ki[:n], found[:n], failed[:n], total[:n])
