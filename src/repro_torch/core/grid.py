"""Non-hierarchical ε-grid index (paper §IV-A), in PyTorch.

Port of ``repro/core/grid.py``.  The layout is the paper's: ``B`` the sorted
non-empty linear cell ids (``unique_cells``), ``G`` their [start, count)
ranges (``cell_starts``/``cell_counts``) into ``A``, the cell-sorted
permutation of the database (``order``).  Every array has a shape that
depends only on (|D|, m), padded with sentinels, and ids are int32 so the
integer metadata is bit-identical to the JAX package's.

Only ``m ≤ n`` (variance-ordered) dims are indexed; distances are always
computed in all n dims.  When the int32 id cap binds, cell edges grow
beyond ε, which only adds candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import INT32_SENTINEL

I32 = torch.int32


def neighbor_offsets(m: int) -> np.ndarray:
    """All 3^m offsets in {-1, 0, 1}^m (static, tiny for m ≤ 6)."""
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * m), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1).astype(np.int32)


def max_cells_per_dim(m: int) -> int:
    """Largest per-dim cell count such that the id space fits int32."""
    return max(2, int((2.0**31 - 2.0) ** (1.0 / m)) - 1)


@dataclasses.dataclass
class GridIndex:
    """ε-grid over the first ``m`` (variance-ordered) dims of the data."""

    m: int                                  # number of indexed dims
    n_points: int                           # |D|
    epsilon: torch.Tensor                   # () f32 — cell edge target
    mins: torch.Tensor                      # (m,) f32 grid origin
    cell_edge: torch.Tensor                 # (m,) f32 actual edge (≥ ε)
    cells_per_dim: torch.Tensor             # (m,) i32
    radices: torch.Tensor                   # (m,) i32 mixed-radix multipliers
    unique_cells: torch.Tensor              # (|D|,) i32 sorted ids, sentinel-padded
    cell_starts: torch.Tensor               # (|D|,) i32 start in sorted order
    cell_counts: torch.Tensor               # (|D|,) i32 points in cell
    n_cells: torch.Tensor                   # () i32 non-empty cells
    order: torch.Tensor                     # (|D|,) i32 A: sorted-pos -> original id
    point_cell_pos: torch.Tensor            # (|D|,) i32 original id -> cell slot
    point_coords: torch.Tensor              # (|D|, m) i32 original id -> cell coords
    points_sorted: Optional[torch.Tensor]   # (|D|, n) f32 cell-sorted copy of D


_GRID_ARRAYS = tuple(f.name for f in dataclasses.fields(GridIndex)
                     if f.name not in ("m", "n_points"))


def grid_from_arrays(fields: dict, *, m: int, n_points: int, device) -> GridIndex:
    """The port's ``GridIndex`` from another package's built grid, each
    field given as a numpy array (``np.asarray`` of a JAX ``GridIndex``
    field) — so engines of both packages can run on identical state."""
    def conv(name):
        a = fields.get(name)
        if a is None:
            return None
        a = np.array(a)                     # a writable copy
        return torch.as_tensor(a.astype(np.int32) if a.dtype.kind in "iu" else a,
                               device=device)
    return GridIndex(m=m, n_points=n_points, **{n: conv(n) for n in _GRID_ARRAYS})


def compute_cell_coords(index: GridIndex, proj: torch.Tensor) -> torch.Tensor:
    """(Q, m) float projected coords -> (Q, m) int32 cell coords (clipped)."""
    c = torch.floor((proj - index.mins[None, :]) / index.cell_edge[None, :])
    hi = (index.cells_per_dim - 1).to(c.dtype)[None, :]
    return torch.minimum(torch.clamp(c, min=0.0), hi).to(I32)


def linearize(coords: torch.Tensor, radices: torch.Tensor) -> torch.Tensor:
    """(..., m) int32 coords -> (...,) int32 linear cell ids (wrapping like
    the JAX int32 sum; only in-range coords are ever looked up)."""
    return (coords * radices).sum(-1).to(I32)


def build_grid(points: torch.Tensor, epsilon, m: int,
               materialize_points: bool = True) -> GridIndex:
    """Build the ε-grid over ``points[:, :m]`` (points already
    variance-reordered, see ``reorder_by_variance``)."""
    npts, n = points.shape
    assert m <= n, (m, n)
    dev = points.device
    proj = points[:, :m]
    mins = proj.min(0).values
    maxs = proj.max(0).values
    extent = torch.clamp(maxs - mins, min=1e-30)

    cap = max_cells_per_dim(m)
    eps = torch.as_tensor(epsilon, dtype=points.dtype, device=dev)
    edge = torch.maximum(eps, extent / (cap - 1))
    cells_per_dim = torch.clamp(torch.ceil(extent / edge).to(I32) + 1, 1, cap)
    radices = torch.cat([
        torch.ones((1,), dtype=I32, device=dev),
        torch.cumprod(cells_per_dim, 0)[:-1].to(I32),
    ])
    index = GridIndex(
        m=m, n_points=npts, epsilon=eps, mins=mins, cell_edge=edge,
        cells_per_dim=cells_per_dim, radices=radices,
        unique_cells=None, cell_starts=None, cell_counts=None, n_cells=None,
        order=None, point_cell_pos=None, point_coords=None, points_sorted=None,
    )
    coords = compute_cell_coords(index, proj)                       # (|D|, m)
    ids = linearize(coords, radices)                                # (|D|,)

    order = torch.argsort(ids, stable=True)                         # A (int64)
    ids_sorted = ids[order]
    is_start = torch.ones((npts,), dtype=torch.bool, device=dev)
    is_start[1:] = ids_sorted[1:] != ids_sorted[:-1]
    seg = torch.cumsum(is_start.to(I32), 0, dtype=I32) - 1           # sorted-pos -> slot
    n_cells = seg[-1] + 1
    seg64 = seg.long()

    unique_cells = torch.full((npts,), INT32_SENTINEL, dtype=I32, device=dev)
    unique_cells[seg64] = ids_sorted
    cell_starts = torch.full((npts,), npts, dtype=I32, device=dev).scatter_reduce(
        0, seg64, torch.arange(npts, dtype=I32, device=dev), reduce="amin")
    cell_counts = torch.zeros((npts,), dtype=I32, device=dev).scatter_add(
        0, seg64, torch.ones((npts,), dtype=I32, device=dev))
    point_cell_pos = torch.zeros((npts,), dtype=I32, device=dev)
    point_cell_pos[order] = seg

    return dataclasses.replace(
        index,
        unique_cells=unique_cells,
        cell_starts=cell_starts,
        cell_counts=cell_counts,
        n_cells=n_cells.to(I32),
        order=order.to(I32),
        point_cell_pos=point_cell_pos,
        point_coords=coords,
        points_sorted=points[order] if materialize_points else None,
    )


def lookup_cells(index: GridIndex, ids: torch.Tensor):
    """Binary-search linear cell ids in B.  Returns (starts, counts) with
    count 0 for empty / not-found cells.  ``ids`` any shape."""
    pos = torch.searchsorted(index.unique_cells, ids.contiguous(), out_int32=True)
    pos = torch.clamp(pos, 0, index.n_points - 1).long()
    found = index.unique_cells[pos] == ids
    starts = index.cell_starts[pos]
    counts = torch.where(found, index.cell_counts[pos], torch.zeros_like(starts))
    return starts, counts


def neighbor_ranges(index: GridIndex, coords: torch.Tensor, offs=None):
    """For query cell coords (Q, m) the candidate ranges over the 3^m
    adjacent cells: (starts, counts), both (Q, 3^m) int32."""
    if offs is None:
        offs = torch.as_tensor(neighbor_offsets(index.m), device=coords.device)
    ncoords = coords[:, None, :] + offs[None, :, :]                  # (Q, R, m)
    valid = ((ncoords >= 0) & (ncoords < index.cells_per_dim[None, None, :])).all(-1)
    ids = linearize(ncoords, index.radices)
    starts, counts = lookup_cells(index, ids)
    return starts, torch.where(valid, counts, torch.zeros_like(counts))


def neighborhood_counts(index: GridIndex, coords: torch.Tensor) -> torch.Tensor:
    """Total candidate count in the 3^m neighborhood of each query (Q,)."""
    _, counts = neighbor_ranges(index, coords)
    return counts.sum(-1)


def gather_candidates(index: GridIndex, starts: torch.Tensor,
                      counts: torch.Tensor, budget: int):
    """Expand per-query candidate ranges (Q, R) into fixed-budget tiles.

    Returns (cand_sorted_pos (Q, budget) i32 clipped positions into the
    cell-sorted order, valid (Q, budget) bool, total (Q,) i32 true count,
    overflow (Q,) bool — the true count exceeded the budget)."""
    nq, r = counts.shape
    dev = counts.device
    cum = torch.cumsum(counts, 1, dtype=I32)                          # (Q, R)
    total = cum[:, -1]
    slots = torch.arange(budget, dtype=I32, device=dev)
    rr = torch.searchsorted(cum, slots.expand(nq, budget).contiguous(),
                            right=True, out_int32=True)
    rr = torch.clamp(rr, 0, r - 1).long()
    before = torch.cat([torch.zeros_like(cum[:, :1]), cum], 1).gather(1, rr)
    within = slots[None, :] - before
    pos = starts.gather(1, rr) + within
    valid = slots[None, :] < torch.clamp(total, max=budget)[:, None]
    pos = torch.clamp(torch.where(valid, pos, torch.zeros_like(pos)), 0, index.n_points - 1)
    return pos.to(I32), valid, total, total > budget


def tile_shared_candidates(index: GridIndex, starts: torch.Tensor,
                           counts: torch.Tensor, budget: int):
    """Deduplicate one query tile's (TQ, R) candidate ranges into a shared
    block: a range's start uniquely keys its cell, so sorting the ranges
    by start and zeroing repeats yields the exact union.  Returns (pos
    (budget,) i32, valid (budget,) bool, tile_total () i32, overflow ()).
    A batch of tiles (T, TQ, R) gives each output a leading T axis."""
    lead = starts.shape[:-2]
    flat_s = starts.reshape(-1, starts.shape[-2] * starts.shape[-1])
    flat_c = counts.reshape(flat_s.shape)
    key = torch.where(flat_c > 0, flat_s, torch.full_like(flat_s, INT32_SENTINEL))
    key_s, order = torch.sort(key, dim=1, stable=True)
    dup = torch.zeros_like(key_s, dtype=torch.bool)
    dup[:, 1:] = key_s[:, 1:] == key_s[:, :-1]
    dedup_c = torch.where(dup, torch.zeros_like(flat_c), flat_c.gather(1, order))
    pos, valid, total, overflow = gather_candidates(
        index, flat_s.gather(1, order), dedup_c, budget)
    return (pos.reshape(lead + (budget,)), valid.reshape(lead + (budget,)),
            total.reshape(lead), overflow.reshape(lead))


def home_cell_ids(index: GridIndex, qids: torch.Tensor, coords=None) -> torch.Tensor:
    """Linear home-cell id per query id; padding rows (qids < 0) get the
    int32 sentinel so a stable sort clusters them after all real work.
    ``coords`` carries a foreign (R≠S) query cloud's cell coords."""
    if coords is None:
        coords = index.point_coords
    safe = torch.clamp(qids, 0, coords.shape[0] - 1).long()
    cid = linearize(coords[safe], index.radices)
    return torch.where(qids >= 0, cid, torch.full_like(cid, INT32_SENTINEL))


def group_queries_by_cell(index: GridIndex, qids: torch.Tensor, query_block: int,
                          coords=None):
    """Sort the padded query-id vector by home cell id and cut it into
    (n_tiles, query_block) tiles; ``perm`` maps sorted -> original position."""
    assert qids.shape[0] % query_block == 0, (qids.shape, query_block)
    cid = home_cell_ids(index, qids, coords)
    perm = torch.argsort(cid, stable=True)
    return qids[perm].reshape(-1, query_block), perm.to(I32)


def reorder_by_variance(points: torch.Tensor):
    """Paper §IV-D REORDER: permute dims by descending variance.  Returns
    (reordered_points, perm)."""
    var = torch.var(points, dim=0, correction=0)
    perm = torch.argsort(-var, stable=True)
    return points[:, perm], perm
