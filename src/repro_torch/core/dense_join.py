"""Dense engine — the paper's GPU-JOIN (§V-B/§V-E), in PyTorch.

Port of ``repro/core/dense_join.py``.  Range-queries the ε-grid around
each assigned query, filters the 3^m-cell candidate set with
full-dimension distances and keeps the K nearest within ε.  A query FAILS
iff it finds < K neighbors within ε, or its candidate set overflowed the
budget (so exactness cannot be certified); failures go to the sparse
engine.

Two backends share those semantics:

  * ``"ref"`` — per-query gather + difference-form distances (the
    correctness oracle), run over memory-bounded chunks of queries;
  * ``"fused"`` — the streaming one-pass engine: queries are grouped into
    cell-sorted tiles, each tile's deduplicated 3^m cell ranges become a
    block table (``_tile_block_tables``) and the ``knn_stream`` kernel
    reads those corpus blocks in place, filters at ε² and keeps a running
    top-K — no (block, budget) distance tile and no gathered candidate
    copy exists.  For k > ``MAX_UNROLLED_K`` the gathered per-tile route
    (``_fused_tile_fn``) takes over and its stream op reroutes to the
    plain version.

``"auto"`` resolves to ``"fused"`` on a CUDA device and ``"ref"`` on the
CPU.  If ``found ≥ K`` and nothing overflowed, the K neighbors are the
exact global KNN (the 3^m neighborhood of an edge-≥ε grid covers the
ε-ball).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import grid as grid_lib
from repro_torch.core.hybrid import BACKENDS
from repro_torch.kernels.knn_stream import kernel as stream_kernel
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.utils import INT32_SENTINEL, cdiv, round_up, unported

# Extra corpus-block slots past ceil(budget/block_c) in a tile's block
# table: rounding the deduped cell ranges to block_c-aligned blocks can
# touch a few more blocks than the budget's worth of rows.  Exceeding the
# table is a per-tile overflow failure, like exceeding the row budget.
PREFETCH_BLOCK_SLACK = 2

# Working-set target of the chunked passes below (tile metadata, ref-backend
# gathers): eager PyTorch materializes what jit fused, so large batches run
# over chunks sized to stay near this many bytes.
_CHUNK_BYTES = 2 << 30


def resolve_backend(backend: str, device) -> str:
    """Collapse ``"auto"``: the fused engine on a CUDA device, ref on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend in ("pallas", "interpret"):
        raise unported(f"backend={backend!r} (the tiled pairwise_l2 path)",
                       "queue B item 5")
    if backend == "auto":
        return "fused" if torch.device(device).type == "cuda" else "ref"
    return backend


def check_exact_l2(metric: str, distance_dtype: str = "fp32") -> None:
    """This slice serves exact fp32 squared-L2 only."""
    if metric != "l2":
        raise unported(f"metric={metric!r}", "queue A item 11")
    if distance_dtype != "fp32":
        raise unported(f"distance_dtype={distance_dtype!r}", "queue A item 11")


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
    """k smallest per row with ids (lowest column first on ties, as
    ``lax.top_k`` on the negated distances); ids −1 where inf."""
    vals, sel = torch.sort(d, dim=1, stable=True)
    kd = vals[:, :k]
    ki = ids.gather(1, sel[:, :k])
    return kd, torch.where(torch.isinf(kd), torch.full_like(ki, -1), ki)


def _ref_join(index, points_r, qids, eps2, k, budget, queries, coords_all,
              exclude_self):
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
        diff = queries[safe][:, None, :] - index.points_sorted[pos]
        d2 = (diff * diff).sum(-1)                                  # (B, budget)
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


def _fused_prefetch_join(index, points_r, qids, eps2, k, budget, query_block,
                         block_c, queries_r=None, qcoords=None, exclude_self=True):
    """The fused backend: one ``knn_stream`` launch over every tile of the
    batch; results scattered back to the original query order."""
    operands, own_total, tile_ovf, perm = fused_prefetch_operands(
        index, points_r, qids, budget, query_block, block_c, queries_r,
        qcoords, exclude_self)
    kd, ki, found = stream_ops.knn_stream_topk_prefetch(
        *operands, eps2, k=k, block_q=query_block, block_c=block_c)
    failed = (found < k) | tile_ovf.repeat_interleave(query_block)
    perm = perm.long()
    outs = []
    for x in (kd, ki, found, failed, own_total.reshape(-1)):
        y = torch.zeros_like(x)
        y[perm] = x
        outs.append(y)
    return tuple(outs)


def _fused_tile_fn(index, points_r, eps2, k, budget, block_c, queries_r=None,
                   qcoords=None, exclude_self=True):
    """Gathered one-pass route for k > MAX_UNROLLED_K: each cell-sorted
    tile gathers its shared candidate union and streams it through
    ``knn_stream`` ops (which reroute oversized k to the plain version)."""
    queries = points_r if queries_r is None else queries_r
    coords_all = index.point_coords if qcoords is None else qcoords
    cand_budget = round_up(budget, block_c)

    def fn(qids):
        safe = torch.clamp(qids, 0, queries.shape[0] - 1).long()
        starts, counts = grid_lib.neighbor_ranges(index, coords_all[safe])
        counts = counts * (qids >= 0)[:, None]
        pos, valid, _, tile_overflow = grid_lib.tile_shared_candidates(
            index, starts, counts, cand_budget)
        pos = pos.long()
        cand_ids = torch.where(valid, index.order[pos], torch.full_like(pos, -1, dtype=torch.int32))
        kd, ki, found = stream_ops.knn_stream_topk(
            queries[safe], index.points_sorted[pos],
            _exclusion_ids(qids, exclude_self), cand_ids, eps2,
            k=k, block_q=qids.shape[0], block_c=block_c)
        failed = (found < k) | tile_overflow
        return kd, ki, found, failed, counts.sum(1, dtype=torch.int32)

    return fn


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
    ``exclude_self`` decides whether query i may report reference point i."""
    backend = resolve_backend(backend, points_r.device)
    check_exact_l2(metric, distance_dtype)
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

    if backend == "ref":
        kd, ki, found, failed, total = _ref_join(
            index, points_r, qids, eps2, k, budget, queries, coords_all,
            exclude_self)
    elif k <= stream_kernel.MAX_UNROLLED_K:
        kd, ki, found, failed, total = _fused_prefetch_join(
            index, points_r, qids, eps2, k, budget, query_block, block_c,
            queries_r, qcoords, exclude_self)
    else:
        fn = _fused_tile_fn(index, points_r, eps2, k, budget, block_c,
                            queries_r, qcoords, exclude_self)
        tiles, perm = grid_lib.group_queries_by_cell(index, qids, query_block, qcoords)
        outs = [fn(t) for t in tiles]
        perm = perm.long()
        res = []
        for x in zip(*outs):
            x = torch.cat(x)
            y = torch.zeros_like(x)
            y[perm] = x
            res.append(y)
        kd, ki, found, failed, total = res
    pad_row = torch.arange(qpad, device=dev) >= n
    failed = failed | pad_row | (qids < 0)
    return DenseJoinResult(kd[:n], ki[:n], found[:n], failed[:n], total[:n])
