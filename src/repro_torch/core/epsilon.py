"""Empirical selection of the range-query distance ε (paper §V-C), in PyTorch.

Port of ``repro/core/epsilon.py``, split into two steps:

  1. ``sample_indices`` draws the pair sample and the query sample from a
     ``torch.Generator`` seeded with ``cfg.seed`` (the JAX package draws
     them with ``jax.random``; the two streams differ, so the selected ε
     differs — results are exact either way);
  2. ``select_epsilon_from_indices`` computes everything after sampling:
     ε^mean from the pairs, the ``bin_hist`` histogram of the sampled
     queries against the full database, and ε = 2·ε^β.  Fed the JAX
     package's indices it reproduces the JAX selection.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.bin_hist import ops as hist_ops


class EpsilonSelection(NamedTuple):
    epsilon: torch.Tensor          # () f32 — final grid/query radius (= 2 ε^β)
    epsilon_beta: torch.Tensor     # () f32 — ε^β
    epsilon_default: torch.Tensor  # () f32 — ε^default (β = 0)
    epsilon_mean: torch.Tensor     # () f32 — mean pairwise distance (bin cutoff)
    cumulative: torch.Tensor       # (n_bins,) f32 — B^c_d
    bin_width: torch.Tensor        # () f32


def sample_indices(npts: int, seed: int, *, n_pair_sample: int = 4096,
                   n_query_sample: int = 256, device="cpu"):
    """(ia, ib, qidx) int64 sample indices in [0, npts), drawn on the host
    from ``torch.Generator().manual_seed(seed)`` so they are the same on
    every device."""
    gen = torch.Generator().manual_seed(int(seed))
    ia = torch.randint(0, npts, (n_pair_sample,), generator=gen)
    ib = torch.randint(0, npts, (n_pair_sample,), generator=gen)
    qidx = torch.randint(0, npts, (n_query_sample,), generator=gen)
    return ia.to(device), ib.to(device), qidx.to(device)


def mean_pair_distance(points: torch.Tensor, ia, ib) -> torch.Tensor:
    """ε^mean: mean Euclidean distance over the sampled point pairs."""
    diff = points[ia] - points[ib]
    d = torch.sqrt((diff * diff).sum(-1) + 1e-30)
    keep = (ia != ib).to(d.dtype)
    return (d * keep).sum() / torch.clamp(keep.sum(), min=1.0)


def distance_histogram(points: torch.Tensor, qidx, epsilon_mean, n_bins: int = 256):
    """Average cumulative neighbor count per distance bin (B^c_d) and the
    bin width; distances ≥ ε^mean are discarded, self pairs excluded."""
    bin_width = epsilon_mean / n_bins
    counts = hist_ops.distance_bin_histogram(
        points[qidx], points, bin_width, n_bins, self_indices=qidx)
    per_query = counts.to(torch.float32) / qidx.shape[0]
    return torch.cumsum(per_query, 0), bin_width


def _bin_for_target(cumulative, bin_width, target: float):
    """Midpoint distance of the first bin where cumulative ≥ target;
    clamps to the last bin if unreachable."""
    t = torch.tensor([target], dtype=cumulative.dtype, device=cumulative.device)
    d = torch.searchsorted(cumulative.contiguous(), t)[0]
    d = torch.clamp(d, 0, cumulative.shape[0] - 1)
    start = d.to(bin_width.dtype) * bin_width
    end = start + bin_width
    return 0.5 * (start + end)


def select_epsilon_from_indices(points: torch.Tensor, ia, ib, qidx, k: int,
                                beta: float = 0.0,
                                n_bins: int = 256) -> EpsilonSelection:
    """Paper §V-C2 after sampling: a pure function of the sample."""
    eps_mean = mean_pair_distance(points, ia, ib)
    cumulative, bin_width = distance_histogram(points, qidx, eps_mean, n_bins)
    target_beta = k + (100.0 * k - k) * beta
    eps_default = _bin_for_target(cumulative, bin_width, float(k))
    eps_beta = _bin_for_target(cumulative, bin_width, target_beta)
    return EpsilonSelection(
        epsilon=2.0 * eps_beta,
        epsilon_beta=eps_beta,
        epsilon_default=eps_default,
        epsilon_mean=eps_mean,
        cumulative=cumulative,
        bin_width=bin_width,
    )


def select_epsilon(points: torch.Tensor, seed: int, k: int, beta: float = 0.0,
                   n_query_sample: int = 256, n_bins: int = 256,
                   n_pair_sample: int = 4096) -> EpsilonSelection:
    """The full paper §V-C2 procedure: sample, then select."""
    ia, ib, qidx = sample_indices(
        points.shape[0], seed, n_pair_sample=n_pair_sample,
        n_query_sample=n_query_sample, device=points.device)
    return select_epsilon_from_indices(points, ia, ib, qidx, k, beta, n_bins)
