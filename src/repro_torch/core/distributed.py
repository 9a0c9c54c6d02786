"""Distributed-memory KNN join on a slot mesh — port of
``repro/core/distributed.py``.

The JAX module runs one ``shard_map`` program per mesh device.  Here one
process drives the P logical slots of a ``launch.mesh.Mesh`` (each slot
pinned to a ``torch.device``; on one card they all share it), so every
"collective" is a plain tensor operation over the slots' tensors and the
loop over slots replaces ``shard_map``'s per-device body:

  * ``build_shard_indices`` — each shard's ε-grid and pyramid, built on
    that shard's slot device;

  * the collective top-K merge — ``collective_topk_merge`` combines the P
    shard-local candidate sets ``runtime/sharded_index.py`` produces into
    the exact global KNN on slot 0's device, either as the all-gather fold
    of ``knn_topk.merge_running_topk`` over p = 0…P−1 or as the butterfly
    tree, log₂P rounds each merging block 2j with block 2j+1 (the order in
    which the JAX butterfly's rank 0 — whose copy it returns — merges);

  * ``ring_self_join`` / ``ring_self_join_bf16`` — the corpus-rotation
    exact join: at hop h query shard p meets corpus shard (p − h) mod P,
    the JAX ``ppermute`` ring, each chunk through ``knn_topk`` (the
    ``knn_tile_topk`` kernel on the card);

  * ``hybrid_join_spmd`` — the static-shape hybrid self-join with queries
    split over the slots and the corpus replicated, routed through
    ``splitter.split_from_counts``.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import brute as brute_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.core import splitter as split_lib
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.utils import cdiv, pad_to, pow2_bucket


def _axis_size(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


def shard_devices(mesh, axes: Sequence[str]) -> list:
    """The device of each position along ``axes`` (flattened in the order
    given), taken at index 0 of every other mesh axis — where a shard's
    state lives when the other axes replicate it."""
    names = list(mesh.axis_names)
    lead = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in lead]
    devs = mesh.devices.transpose(lead + rest)
    return list(devs.reshape(_axis_size(mesh, axes), -1)[:, 0])


# --------------------------------------------------------------------------
# Shard-local index build
# --------------------------------------------------------------------------

def build_shard_indices(mesh, axis_names: Sequence[str], points_stacked, epsilon, m: int, *,
                        n_levels: int = 6, level_scale: float = 2.0):
    """Build every shard's ε-grid + pyramid on its slot device.

    ``points_stacked`` holds shard p's (reordered) points at index p — a
    (P, shard_n, n) tensor or array, or a sequence of P such blocks.
    Returns ``(grids, pyramids)``, lists of P per-shard objects.  All shards
    share one ε, so their engines run at the same shapes."""
    devs = shard_devices(mesh, tuple(axis_names))
    if len(points_stacked) != len(devs):
        raise ValueError(f"{len(points_stacked)} point blocks for {len(devs)} shards")
    grids, pyramids = [], []
    for p, dev in enumerate(devs):
        pts = torch.as_tensor(points_stacked[p], dtype=torch.float32).to(dev)
        eps = torch.tensor(float(epsilon), dtype=torch.float32, device=dev)
        grids.append(grid_lib.build_grid(pts, eps, m))
        pyramids.append(sparse_lib.build_pyramid(pts, eps, m, n_levels=n_levels,
                                                 level_scale=level_scale))
    return grids, pyramids


# --------------------------------------------------------------------------
# Collective top-K merge (the serving path's only cross-shard step)
# --------------------------------------------------------------------------

#: Shard count at which the butterfly tree overtakes the all-gather fold.
TREE_MERGE_MIN_SHARDS = 8

MERGE_STRATEGIES = ("allgather", "tree", "auto")


def merge_strategy(n_shards: int, strategy: str = "auto") -> str:
    """Resolve the collective-merge strategy (DESIGN.md §5.3): ``"auto"``
    picks the butterfly for pow2 shard counts ≥ ``TREE_MERGE_MIN_SHARDS``
    and the all-gather fold otherwise; ``"tree"`` needs a pow2 count."""
    if strategy not in MERGE_STRATEGIES:
        raise ValueError(f"merge strategy must be one of {MERGE_STRATEGIES}, got {strategy!r}")
    pow2 = n_shards & (n_shards - 1) == 0
    if strategy == "auto":
        return "tree" if pow2 and n_shards >= TREE_MERGE_MIN_SHARDS else "allgather"
    if strategy == "tree" and not pow2:
        raise ValueError(f"tree merge needs a pow2 shard count, got {n_shards}")
    return strategy


def _merge_blocks(a_d, a_i, b_d, b_i, k: int):
    """``merge_running_topk`` batched over a leading block axis: (B, Q, ·)
    pairs -> (B, Q, k); equal keys keep ``a``'s entries first."""
    nb, q = a_d.shape[:2]
    d, i = topk_ops.merge_running_topk(
        a_d.reshape(nb * q, -1), a_i.reshape(nb * q, -1),
        b_d.reshape(nb * q, -1), b_i.reshape(nb * q, -1), k=k)
    return d.reshape(nb, q, k), i.reshape(nb, q, k)


def collective_topk_merge(mesh, axis_names: Sequence[str], *, k: int,
                          strategy: str = "auto", dedup: bool = False):
    """Build the collective merge for ``mesh``:

        fn(dists (P, Q, k_in), ids (P, Q, k_in), excl (Q,))
            -> (dists (Q, k), ids (Q, k))       # on slot 0's device

    Block p is shard p's local top-``k_in`` candidate set — keys ascending,
    global ids, (inf, −1) where a shard had fewer candidates.  ``excl`` is
    the id each query must not match (−2 ⇒ none).  ``dedup`` drops
    repeated global ids within a block (the earlier copy wins) — the
    uneven-|D| pad rows, which never cross shards.  Every block is masked
    and reduced to k before any exchange, as in the JAX body."""
    axes = tuple(axis_names)
    n_shards = _axis_size(mesh, axes)
    strategy = merge_strategy(n_shards, strategy)
    if strategy == "tree" and len(axes) != 1:
        raise ValueError("tree merge runs over a single mesh axis")
    dev = shard_devices(mesh, axes)[0]

    def merge(dists, ids, excl):
        d = torch.as_tensor(dists).to(dev, torch.float32)
        i = torch.as_tensor(ids).to(dev, torch.int32)
        ex = torch.as_tensor(excl).to(dev, torch.int32)
        p, q, k_in = i.shape
        # Mask excluded and (optionally) in-block duplicate ids BEFORE the
        # reduction to k, so a masked slot never displaces a real candidate.
        valid = (i >= 0) & (i != ex[None, :, None])
        if dedup:
            eq = i[..., :, None] == i[..., None, :]                    # (P, Q, k_in, k_in)
            earlier = torch.tril(torch.ones((k_in, k_in), dtype=torch.bool, device=dev), -1)
            valid &= ~(eq & earlier & (i[..., :, None] >= 0)).any(-1)
        dm = torch.where(valid, d, torch.full_like(d, float("inf")))
        im = torch.where(valid, i, torch.full_like(i, -1))
        run_d, run_i = _merge_blocks(torch.full((p, q, k), float("inf"), device=dev),
                                     torch.full((p, q, k), -1, dtype=torch.int32, device=dev),
                                     dm, im, k)
        if strategy == "allgather":
            out_d, out_i = run_d[0], run_i[0]
            for s in range(1, p):
                out_d, out_i = topk_ops.merge_running_topk(out_d, out_i, run_d[s], run_i[s], k=k)
            return out_d, out_i
        while run_d.shape[0] > 1:
            run_d, run_i = _merge_blocks(run_d[0::2], run_i[0::2], run_d[1::2], run_i[1::2], k)
        return run_d[0], run_i[0]

    return merge


# --------------------------------------------------------------------------
# Ring-systolic exact join
# --------------------------------------------------------------------------

def _even_chunk(corpus_chunk: int, c_loc: int) -> int:
    """Largest divisor of ``c_loc`` that is ≤ ``corpus_chunk`` (the JAX
    body's ``dynamic_slice`` would clamp and re-read rows otherwise; the
    port keeps its chunk plan so the merge order is the same)."""
    chunk = min(corpus_chunk, c_loc)
    while c_loc % chunk:
        chunk -= 1
    return chunk


def _pad_ring_rows(n: int, n_shards: int, pad_block: int) -> int:
    """Padded row count: every shard gets the serving path's
    ``pow2_bucket`` row bucket; padding rows carry id −1."""
    return n_shards * pow2_bucket(cdiv(n, n_shards), pad_block)


def _ring(mesh, axes, k: int, corpus_chunk: int, pad_block: int, wire_dtype):
    n_shards = _axis_size(mesh, axes)
    devs = shard_devices(mesh, axes)

    def join(points):
        pts = torch.as_tensor(points, dtype=torch.float32).to(devs[0])
        n = pts.shape[0]
        total = _pad_ring_rows(n, n_shards, pad_block)
        q_loc = total // n_shards
        pts = pad_to(pts, total)
        ids = pad_to(torch.arange(n, dtype=torch.int32, device=devs[0]), total, value=-1)
        qp = [pts[p * q_loc:(p + 1) * q_loc].to(devs[p]) for p in range(n_shards)]
        qi = [ids[p * q_loc:(p + 1) * q_loc].to(devs[p]) for p in range(n_shards)]
        # The rotating corpus shards, in their wire format.
        wire = [x.to(wire_dtype) for x in qp]
        chunk = _even_chunk(corpus_chunk, q_loc)
        run = [(torch.full((q_loc, k), float("inf"), device=devs[p]),
                torch.full((q_loc, k), -1, dtype=torch.int32, device=devs[p]))
               for p in range(n_shards)]
        for hop in range(n_shards):
            for p in range(n_shards):
                src = (p - hop) % n_shards          # the shard that reached slot p
                cp = wire[src].to(devs[p]).float()
                ci = qi[src].to(devs[p])
                rd, ri = run[p]
                for c0 in range(0, q_loc, chunk):
                    nd, ni = topk_ops.knn_topk(qp[p], cp[c0:c0 + chunk], qi[p],
                                               ci[c0:c0 + chunk], k=k)
                    rd, ri = topk_ops.merge_running_topk(rd, ri, nd, ni, k=k)
                run[p] = (rd, ri)
        d = torch.cat([rd.to(devs[0]) for rd, _ in run])
        i = torch.cat([ri.to(devs[0]) for _, ri in run])
        return d[:n], i[:n]

    return join


def ring_self_join(mesh, axis_names: Sequence[str], *, k: int, corpus_chunk: int = 4096,
                   pad_block: int = 128):
    """Build the ring join for ``mesh``; returns fn(points) -> (dists (|D|,
    k) squared L2, ids (|D|, k)), on slot 0's device.

    Rows are padded to ``n_shards × pow2_bucket(|D|/n_shards, pad_block)``
    and split over ``axis_names``; within a hop the resident corpus shard
    streams through ``knn_topk`` in ``corpus_chunk`` slices (a divisor of
    the shard), bounding the working set at O(q_loc × corpus_chunk)."""
    return _ring(mesh, tuple(axis_names), k, corpus_chunk, pad_block, torch.float32)


def ring_self_join_bf16(mesh, axis_names: Sequence[str], *, k: int,
                        corpus_chunk: int = 4096, pad_block: int = 128):
    """Ring join with bf16 corpus shards on the wire: each rotating shard
    travels as bf16 and is upcast to f32 at every hop, so distances are
    accumulated in f32 from bf16 coordinates (queries stay f32).  Exactness
    -critical callers keep the f32 ring."""
    return _ring(mesh, tuple(axis_names), k, corpus_chunk, pad_block, torch.bfloat16)


# --------------------------------------------------------------------------
# Static-shape SPMD hybrid join
# --------------------------------------------------------------------------

class SPMDJoinResult(NamedTuple):
    dists: torch.Tensor        # (Q, k) squared L2
    ids: torch.Tensor          # (Q, k)
    source: torch.Tensor       # (Q,) 0=dense, 1=sparse, 2=fail/brute lane, 3=unresolved
    n_unresolved: int          # summed over slots — the caller re-issues these


def _scatter(out, rows, vals):
    """``out.at[rows].set(vals, mode="drop")`` with the drop target being
    ``out``'s extra last row."""
    out[rows.long()] = vals.to(out.dtype)


def hybrid_join_spmd(mesh, query_axes: Sequence[str], *, k: int, m: int = 6, rho: float = 0.5,
                     gamma: float = 0.0, dense_budget: int = 1024, sparse_budget: int = 512,
                     query_block: int = 128, n_levels: int = 3, fail_lane_factor: float = 0.25,
                     brute_lane_factor: float = 0.25, brute_chunk: int = 2048):
    """Build fn(points, epsilon) -> SPMDJoinResult.

    The corpus (= the query set; self-join) is replicated — one copy and
    one grid + pyramid per distinct slot device — and the queries are split
    into contiguous per-slot ranges (|D| must divide by the slot count).
    Each slot runs the same lanes at the same sizes as the JAX body: the
    ρ split (``split_from_counts``), the dense-first stable order, the
    dense lane, the sparse lane, the fixed-capacity fail lane (dense
    failures retried on the pyramid) and the brute lane, every lane
    ``pow2_bucket``-padded with −1 ids.  The engines run the device's
    backend: ``fused`` (the ``knn_stream`` kernel) on a card, ``ref`` on
    the CPU."""
    backend = "auto"
    axes = tuple(query_axes)
    n_slots = _axis_size(mesh, axes)
    devs = shard_devices(mesh, axes)

    def local(pts, grid, pyramid, eps, qids):
        dev = pts.device
        q_loc = qids.shape[0]
        lane = pow2_bucket(q_loc, query_block)
        home = grid.cell_counts[grid.point_cell_pos[qids.long()].long()]
        split = split_lib.split_from_counts(home, k, m, gamma, rho)
        key = torch.where(split.to_dense, -home, torch.ones_like(home))
        order = torch.argsort(key, stable=True).to(torch.int32)
        sorted_ids = qids[order.long()]
        rank = torch.arange(q_loc, dtype=torch.int32, device=dev)
        in_dense = rank < split.n_dense
        minus1 = torch.full_like(sorted_ids, -1)
        dense_ids = pad_to(torch.where(in_dense, sorted_ids, minus1), lane, value=-1)
        sparse_ids = pad_to(torch.where(in_dense, minus1, sorted_ids), lane, value=-1)
        rows = pad_to(order, lane, value=q_loc)

        # One extra row: the drop target of masked and padding rows.
        out_d = torch.full((q_loc + 1, k), float("inf"), device=dev)
        out_i = torch.full((q_loc + 1, k), -1, dtype=torch.int32, device=dev)
        out_s = torch.full((q_loc + 1,), 3, dtype=torch.int32, device=dev)

        def put(ok, tgt_rows, d, i, src):
            tgt = torch.where(ok, tgt_rows, torch.full_like(tgt_rows, q_loc))
            _scatter(out_d, tgt, d)
            _scatter(out_i, tgt, i)
            out_s[tgt.long()] = src

        dres = dense_lib.dense_join(grid, pts, dense_ids, eps, k=k, budget=dense_budget,
                                    query_block=query_block, backend=backend)
        put((dense_ids >= 0) & ~dres.failed, rows, dres.dists, dres.ids, 0)

        sres = sparse_lib.sparse_knn(pyramid, pts, sparse_ids, k=k, budget=sparse_budget,
                                     query_block=query_block, backend=backend)
        put((sparse_ids >= 0) & sres.certified, rows, sres.dists, sres.ids, 1)

        # Fixed-capacity fail lane: dense failures re-tried on the pyramid.
        flane = pow2_bucket(max(int(fail_lane_factor * q_loc), 1), query_block)
        dfail = (dense_ids >= 0) & dres.failed
        frank = torch.cumsum(dfail.to(torch.int32), 0) - 1
        slot = torch.where(dfail & (frank < flane), frank, torch.full_like(frank, flane)).long()
        lane_ids = torch.full((flane + 1,), -1, dtype=torch.int32, device=dev)
        lane_ids[slot] = dense_ids
        lane_rows = torch.full((flane + 1,), q_loc, dtype=torch.int32, device=dev)
        lane_rows[slot] = rows
        lane_ids, lane_rows = lane_ids[:flane], lane_rows[:flane]
        fres = sparse_lib.sparse_knn(pyramid, pts, lane_ids, k=k, budget=sparse_budget,
                                     query_block=query_block, backend=backend)
        put(fres.certified & (lane_ids >= 0), lane_rows, fres.dists, fres.ids, 2)

        # Brute lane: the fixed-capacity exact backstop for what the grid
        # engines could not certify.
        if brute_lane_factor > 0.0:
            blane = pow2_bucket(max(int(brute_lane_factor * q_loc), 1), query_block)
            pending = out_s[:q_loc] == 3
            prank = torch.cumsum(pending.to(torch.int32), 0) - 1
            slot = torch.where(pending & (prank < blane), prank,
                               torch.full_like(prank, blane)).long()
            blane_ids = torch.full((blane + 1,), -1, dtype=torch.int32, device=dev)
            blane_ids[slot] = qids
            blane_rows = torch.full((blane + 1,), -1, dtype=torch.int32, device=dev)
            blane_rows[slot] = torch.arange(q_loc, dtype=torch.int32, device=dev)
            blane_ids, blane_rows = blane_ids[:blane], blane_rows[:blane]
            bq = pts[blane_ids.clamp(0, pts.shape[0] - 1).long()]
            bd, bi = brute_lib.brute_knn(pts, bq, blane_ids, k=k, corpus_chunk=brute_chunk)
            put(blane_ids >= 0, blane_rows, bd, bi, 2)
        return out_d[:q_loc], out_i[:q_loc], out_s[:q_loc]

    def join(points, epsilon) -> SPMDJoinResult:
        n = points.shape[0]
        if n % n_slots:
            raise ValueError(f"hybrid_join_spmd splits |D|={n} queries over {n_slots} slots: "
                             f"|D| must be a multiple of the slot count")
        q_loc = n // n_slots
        replicas = {}
        outs = []
        for p, dev in enumerate(devs):
            if dev not in replicas:
                pts = torch.as_tensor(points, dtype=torch.float32).to(dev)
                eps = torch.tensor(float(epsilon), dtype=torch.float32, device=dev)
                replicas[dev] = (pts, grid_lib.build_grid(pts, eps, m),
                                 sparse_lib.build_pyramid(pts, eps, m, n_levels=n_levels), eps)
            pts, grid, pyramid, eps = replicas[dev]
            qids = torch.arange(p * q_loc, (p + 1) * q_loc, dtype=torch.int32, device=dev)
            outs.append(local(pts, grid, pyramid, eps, qids))
        d, i, s = (torch.cat([o[j].to(devs[0]) for o in outs]) for j in range(3))
        return SPMDJoinResult(d, i, s, int((s == 3).sum()))

    return join
