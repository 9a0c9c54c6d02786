"""Dividing work between the two engines (paper §V-D/§V-F), in PyTorch.

Port of ``repro/core/splitter.py``: a query goes to the dense engine iff
its home cell holds at least ``n_thresh`` points; ρ then forces a minimum
fraction onto the sparse engine, taken from the least-dense cells."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import grid as grid_lib


def n_min(k: int, m: int) -> float:
    """Paper Eq. (1): K · 2^m · Γ(m/2 + 1) / π^{m/2}."""
    return k * (2.0**m) * math.gamma(m / 2.0 + 1.0) / (math.pi ** (m / 2.0))


def n_thresh(k: int, m: int, gamma: float) -> float:
    """n_thresh = n_min + (10·n_min − n_min)·γ  (paper §V-D)."""
    base = n_min(k, m)
    return base + (10.0 * base - base) * gamma


def rho_model(t_sparse: float, t_dense: float) -> float:
    """Paper Eq. (6): ρ^Model = T₂/(T₁+T₂)."""
    denom = t_sparse + t_dense
    if denom <= 0:
        return 0.5
    return t_dense / denom


class WorkSplit(NamedTuple):
    to_dense: torch.Tensor      # (|Q|,) bool
    home_counts: torch.Tensor   # (|Q|,) i32
    n_dense: torch.Tensor       # () i32
    n_sparse: torch.Tensor      # () i32
    threshold: torch.Tensor     # () f32 — n_thresh actually applied


def split_from_counts(home_counts: torch.Tensor, k: int, m: int, gamma: float,
                      rho: float, net_adjust: torch.Tensor = None) -> WorkSplit:
    """Engine assignment from per-query home-cell populations: the density
    rule, then the ρ floor as a rank threshold on home-cell counts (dense
    queries from the least-populated cells are demoted first).

    ``net_adjust`` (optional, (|Q|,) i32) corrects each query's home-cell
    population for pending index mutations — +inserted, −tombstoned points
    in the cell, clamped at 0 — so classification and the ρ-floor ranking
    see the net corpus density; the returned ``home_counts`` are the
    adjusted ones."""
    nq = home_counts.shape[0]
    dev = home_counts.device
    home_counts = home_counts.to(torch.int32)
    if net_adjust is not None:
        home_counts = torch.clamp(
            home_counts + torch.as_tensor(net_adjust, device=dev).to(torch.int32), min=0)
    thresh = torch.tensor(n_thresh(k, m, gamma), dtype=torch.float32, device=dev)
    dense0 = home_counts.to(torch.float32) >= thresh

    min_sparse = int(math.ceil(rho * nq))
    n_sparse0 = (~dense0).sum().to(torch.int32)
    deficit = torch.clamp(min_sparse - n_sparse0, min=0)

    sort_key = torch.where(dense0, home_counts,
                           torch.full_like(home_counts, torch.iinfo(torch.int32).max))
    order = torch.argsort(sort_key, stable=True)
    rank = torch.empty((nq,), dtype=torch.int32, device=dev)
    rank[order] = torch.arange(nq, dtype=torch.int32, device=dev)
    to_dense = dense0 & ~(rank < deficit)
    n_dense = to_dense.sum().to(torch.int32)
    return WorkSplit(to_dense=to_dense, home_counts=home_counts, n_dense=n_dense,
                     n_sparse=(nq - n_dense).to(torch.int32), threshold=thresh)


def split_work(index: grid_lib.GridIndex, k: int, gamma: float, rho: float) -> WorkSplit:
    """Self-join split: the home-cell populations are cached on the index."""
    home_counts = index.cell_counts[index.point_cell_pos.long()]
    return split_from_counts(home_counts, k, index.m, gamma, rho)


def split_queries(index: grid_lib.GridIndex, q_coords: torch.Tensor, k: int,
                  gamma: float, rho: float, net_adjust: torch.Tensor = None) -> WorkSplit:
    """Foreign-query (R≠S) split by the reference-grid density around each
    query; queries in empty reference cells count 0 and go sparse.
    ``net_adjust`` as in ``split_from_counts``."""
    ids = grid_lib.linearize(q_coords, index.radices)
    _, home_counts = grid_lib.lookup_cells(index, ids)
    return split_from_counts(home_counts, k, index.m, gamma, rho, net_adjust=net_adjust)
