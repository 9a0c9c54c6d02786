"""Mutable-index substrate: the delta buffer, tombstones, and the merge-time
fold that makes ``insert``/``delete`` exact — in PyTorch.

Port of ``repro/runtime/mutation.py`` (DESIGN.md §6):

  * **inserts** land in a small brute-force *delta buffer* (host-side,
    original dim order).  At query time the buffer answers with its own
    per-query top-K (``delta_topk`` — the ``knn_topk`` op, so the
    ``knn_tile_topk`` kernel on the card, over the pow2-padded buffer) and
    that block folds into the main pipeline's results through
    ``knn_topk.merge_running_topk``;

  * **deletes** become *tombstones by global id*.  Deleted delta rows are
    masked at the source (their candidate id flips to −1, the kernels'
    invalid marker); deleted base rows are masked at merge time against a
    sorted, −2-padded tombstone table — the −1/−2 sentinel ids of the R≠S
    exclusion path, so no engine or kernel changes.  Exactness costs only
    *headroom*: the main pipeline is asked for ``k + headroom_bucket(...)``
    candidates so that after ≤ |tombstones| maskings k live neighbors
    survive.  The headroom is pow2-bucketed so the engine shape buckets
    stay quantized;

  * **compaction** (owned by ``KNNIndex``) rebuilds REORDER, ε selection
    and grid/pyramid into a fresh *generation* on the net corpus and swaps
    it atomically; this module's state then resets to empty.

Global-id space of one generation: base rows keep their build ids
``0..|D|−1``; the j-th inserted point is ``|D|+j`` for the life of the
generation (tombstoned delta rows keep their slot, so ids never shift).
Compaction renumbers: net row r of ``net_corpus()`` becomes id r of the
next generation, exactly as if ``KNNIndex.build(net)`` had been called.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import grid as grid_lib
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.utils import pow2_bucket

#: Row bucket of the padded delta buffer — small so a handful of inserts
#: does not over-pad, pow2-growing so buffer growth lands on few shapes.
DELTA_BLOCK = 32

#: Headroom bucket quantum: tombstone counts round up to a pow2 multiple of
#: this before widening the main pipeline's k.
HEADROOM_BLOCK = 8


@dataclasses.dataclass(frozen=True)
class MutationState:
    """Pending mutations against one generation's base corpus.

    Instances are immutable; every mutation returns a NEW state object and
    the owning index swaps ``(generation, mutations)`` as one reference, so
    an in-flight query always sees a consistent pair."""

    delta_points: np.ndarray   # (n_delta, dim) f32, ORIGINAL dim order
    delta_live: np.ndarray     # (n_delta,) bool — False = tombstoned insert
    base_tombs: np.ndarray     # sorted unique i32 base row ids

    @classmethod
    def empty(cls, dim: int) -> "MutationState":
        return cls(delta_points=np.empty((0, dim), np.float32),
                   delta_live=np.empty((0,), bool),
                   base_tombs=np.empty((0,), np.int32))

    # -- introspection -----------------------------------------------------

    @property
    def is_clean(self) -> bool:
        return self.delta_points.shape[0] == 0 and self.base_tombs.size == 0

    @property
    def n_delta_rows(self) -> int:
        """Delta-buffer rows including tombstoned ones (they keep their slot
        so later inserts' global ids never shift)."""
        return int(self.delta_points.shape[0])

    @property
    def n_delta_live(self) -> int:
        return int(self.delta_live.sum())

    @property
    def n_base_tombs(self) -> int:
        return int(self.base_tombs.size)

    def n_live(self, n_base: int) -> int:
        return n_base - self.n_base_tombs + self.n_delta_live

    # -- transitions -------------------------------------------------------

    def with_insert(self, points, n_base: int,
                    dim: int) -> Tuple["MutationState", np.ndarray]:
        """Append ``points`` to the delta buffer; returns the new state and
        the global ids assigned to the inserted rows."""
        pts = np.asarray(points, np.float32)
        if pts.ndim == 1:
            pts = pts[None]
        if pts.ndim != 2 or pts.shape[1] != dim:
            raise ValueError(f"insert expects (n, {dim}) points, got {pts.shape}")
        n0 = self.n_delta_rows
        gids = n_base + n0 + np.arange(len(pts), dtype=np.int64)
        state = MutationState(
            delta_points=np.concatenate([self.delta_points, pts]),
            delta_live=np.concatenate([self.delta_live, np.ones(len(pts), bool)]),
            base_tombs=self.base_tombs)
        return state, gids

    def with_delete(self, ids, n_base: int) -> "MutationState":
        """Tombstone the given global ids (base rows or delta rows).
        Deleting an id that does not exist, or twice, is an error."""
        raw = np.atleast_1d(np.asarray(ids, np.int64))
        ids = np.unique(raw)
        if ids.size != raw.size:
            raise ValueError("duplicate ids in one delete call")
        hi = n_base + self.n_delta_rows
        bad = ids[(ids < 0) | (ids >= hi)]
        if bad.size:
            raise ValueError(f"delete ids out of range [0, {hi}): {bad.tolist()}")
        base_ids = ids[ids < n_base].astype(np.int32)
        delta_rows = (ids[ids >= n_base] - n_base).astype(np.int64)
        dead = base_ids[np.isin(base_ids, self.base_tombs)]
        if dead.size:
            raise ValueError(f"ids already deleted: {dead.tolist()}")
        dead_d = delta_rows[~self.delta_live[delta_rows]]
        if dead_d.size:
            raise ValueError(f"ids already deleted: {(dead_d + n_base).tolist()}")
        live = self.delta_live.copy()
        live[delta_rows] = False
        return MutationState(
            delta_points=self.delta_points, delta_live=live,
            base_tombs=np.sort(np.concatenate([self.base_tombs, base_ids])).astype(np.int32))

    # -- views -------------------------------------------------------------

    def _live_gids(self, n_base: int) -> np.ndarray:
        base_live = np.ones(n_base, bool)
        base_live[self.base_tombs] = False
        return np.concatenate([
            np.flatnonzero(base_live).astype(np.int64),
            n_base + np.flatnonzero(self.delta_live).astype(np.int64),
        ])

    def net_corpus(self, base_points: np.ndarray):
        """The live corpus in ascending-global-id order — base survivors
        first (build order), then live delta rows (insertion order).
        Returns ``(net_points, gids)`` where ``gids[r]`` is net row r's
        current-generation global id (and r its id in the next one)."""
        n_base = base_points.shape[0]
        gids = self._live_gids(n_base)
        base_live = np.ones(n_base, bool)
        base_live[self.base_tombs] = False
        net = np.concatenate([np.asarray(base_points, np.float32)[base_live],
                              self.delta_points[self.delta_live]])
        return net, gids

    def remap_after_compact(self, n_base: int) -> np.ndarray:
        """Old global id → next-generation id (−1 for deleted rows)."""
        gids = self._live_gids(n_base)
        remap = np.full((n_base + self.n_delta_rows,), -1, np.int64)
        remap[gids] = np.arange(len(gids), dtype=np.int64)
        return remap

    def delta_r(self, dim_perm: Optional[np.ndarray]) -> np.ndarray:
        """All delta rows (live and tombstoned) in the REORDER frame."""
        if dim_perm is None:
            return self.delta_points
        return self.delta_points[:, np.asarray(dim_perm)]

    def padded_delta(self, dim_perm: Optional[np.ndarray], n_base: int):
        """The delta buffer as kernel operands: points in the REORDER frame,
        rows pow2-padded to ``DELTA_BLOCK`` buckets, and per-row global ids
        with −1 marking tombstoned/padding rows (the kernels' invalid
        marker, so the fold never sees delta tombstones)."""
        n, dim = self.delta_points.shape
        rows = pow2_bucket(n, DELTA_BLOCK)
        out = np.zeros((rows, dim), np.float32)
        out[:n] = self.delta_r(dim_perm)
        gids = np.full((rows,), -1, np.int32)
        gids[:n] = np.where(self.delta_live, n_base + np.arange(n, dtype=np.int64),
                            -1).astype(np.int32)
        return out, gids

    def tombstone_table(self) -> np.ndarray:
        """Sorted tombstone-id table, −2-padded at the front (keeping it
        ascending) to a pow2 bucket: the fold's membership operand.  −2
        never equals a real id (≥ 0) nor the −1 invalid marker."""
        size = pow2_bucket(self.n_base_tombs, HEADROOM_BLOCK)
        table = np.full((size,), -2, np.int32)
        if self.n_base_tombs:
            table[size - self.n_base_tombs:] = self.base_tombs
        return table


def headroom_bucket(n_tombs: int, need_self: bool) -> int:
    """Extra candidates the main pipeline must surface so that merge-time
    masking (≤ ``n_tombs`` tombstones, plus the query's own id when the
    fold self-excludes) still leaves k live neighbors — pow2-bucketed."""
    h = n_tombs + (1 if need_self else 0)
    return 0 if h == 0 else pow2_bucket(h, HEADROOM_BLOCK)


# ---------------------------------------------------------------------------
# The two mutation engines (kinds "delta" and "merge" in compile_counts)
# ---------------------------------------------------------------------------

def delta_topk(queries_rp, delta_pts, excl, delta_gids, *, k: int, metric: str = "l2"):
    """Per-query top-K over the delta buffer: the ``knn_topk`` op (the
    ``knn_tile_topk`` kernel on the card), with the exclusion ids riding in
    the query-id operand (−2 excludes nothing) and tombstoned/padding rows
    already −1 in ``delta_gids``.  Returns raw scores (squared L2, or −q·c
    for ip), so the fold merges like with like."""
    return topk_ops.knn_topk(queries_rp, delta_pts, excl, delta_gids, k=k, metric=metric)


def fold_topk(main_d, main_i, delta_d, delta_i, tombs, excl, *, k: int):
    """Merge-time fold: tombstone-mask the main pipeline's block by global
    id (sorted-table membership through ``searchsorted``), apply the −1/−2
    exclusion sentinel, then fold the delta block in with
    ``merge_running_topk`` — equal scores keep the main block first, and
    within a block the lower position."""
    t = tombs.shape[0]
    pos = torch.clamp(torch.searchsorted(tombs, main_i.contiguous()), 0, t - 1)
    hit = tombs[pos] == main_i
    drop = hit | (main_i == excl[:, None]) | (main_i < 0)
    d = torch.where(drop, torch.full_like(main_d, float("inf")), main_d)
    i = torch.where(drop, torch.full_like(main_i, -1), main_i)
    return topk_ops.merge_running_topk(d, i, delta_d, delta_i, k=k)


# ---------------------------------------------------------------------------
# Net-density correction for the splitter
# ---------------------------------------------------------------------------

def _grid_cell_ids(grid: grid_lib.GridIndex, pts_r: np.ndarray) -> np.ndarray:
    """Linearized cell ids of raw (reordered) points against ``grid`` —
    the floor + clip every query's classification uses."""
    if len(pts_r) == 0:
        return np.empty((0,), np.int64)
    proj = torch.as_tensor(np.asarray(pts_r, np.float32)[:, : grid.m],
                           device=grid.mins.device)
    coords = grid_lib.compute_cell_coords(grid, proj)
    return grid_lib.linearize(coords, grid.radices).cpu().numpy().astype(np.int64)


def net_cell_adjustment(grid: grid_lib.GridIndex, q_cell_ids: np.ndarray,
                        delta_pts_r: np.ndarray, tomb_pts_r: np.ndarray) -> np.ndarray:
    """Per-query home-cell population correction: +1 for every live delta
    point sharing the query's cell, −1 for every tombstoned base point in
    it — the splitter's ``net_adjust``, so dense/sparse routing follows the
    net corpus density."""
    q_cell_ids = np.asarray(q_cell_ids, np.int64)
    adj = np.zeros(q_cell_ids.shape[0], np.int64)
    for pts, sign in ((delta_pts_r, 1), (tomb_pts_r, -1)):
        cells = _grid_cell_ids(grid, pts)
        if cells.size == 0:
            continue
        u, c = np.unique(cells, return_counts=True)
        pos = np.clip(np.searchsorted(u, q_cell_ids), 0, len(u) - 1)
        adj += np.where(u[pos] == q_cell_ids, sign * c[pos], 0)
    return adj.astype(np.int32)
