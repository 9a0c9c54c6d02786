"""Dispatch for the ε-selection distance histogram: the plain version for
a CPU tensor, the CUDA kernel for a CUDA tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels.bin_hist import kernel as _kernel
from repro_torch.kernels.bin_hist import ref as _ref


def distance_bin_histogram(queries, points, bin_width, n_bins: int, *,
                           self_indices=None):
    """(n_bins,) counts of pairwise distances < n_bins·bin_width.
    ``self_indices`` (S,) are the queries' row ids within ``points``;
    without them nothing is excluded (ids past the point-id range)."""
    s = queries.shape[0]
    n = points.shape[0]
    dev = queries.device
    qid = (self_indices.to(torch.int32) if self_indices is not None
           else n + torch.arange(s, dtype=torch.int32, device=dev))
    bw = torch.as_tensor(bin_width, dtype=torch.float32, device=dev)
    if not queries.is_cuda:
        pid = torch.arange(n, dtype=torch.int32, device=dev)
        return _ref.distance_bin_histogram_ref(
            queries, points, qid, pid, bw, n_bins=n_bins)
    return _kernel.distance_bin_histogram(
        queries.float().contiguous(), points.float().contiguous(),
        qid.contiguous(), bw, n_bins=n_bins)
