"""Wrapper of the CUDA distance-bin histogram kernel (``csrc/bin_hist.cu``),
the port of ``repro/kernels/bin_hist/kernel.py::distance_bin_histogram``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_QTILE = 64                   # sampled queries per shared-memory tile (bin_hist.cu)

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def distance_bin_histogram(queries, points, query_ids, bin_width, *,
                           n_bins: int, block_p: int = 256):
    """(n_bins,) f32 counts over all (query, point) pairs; point ids are the
    row indices of ``points``, so ``query_ids`` carries the self-exclusion
    (−1 ⇒ the query row is skipped).  ``bin_width`` is a () f32 tensor on
    the card (or a float)."""
    global launches
    req = _build.require
    dev = queries.device
    req(dev.type == "cuda", "bin_hist kernel needs CUDA tensors")
    for name, t, dt in (("queries", queries, torch.float32),
                        ("points", points, torch.float32),
                        ("query_ids", query_ids, torch.int32)):
        req(t.device == dev and t.dtype == dt and t.is_contiguous(),
            f"bin_hist: {name} must be a contiguous {dt} tensor on {dev}")
    req(block_p % 32 == 0 and 32 <= block_p <= 1024,
        f"block_p must be a multiple of 32 in [32, 1024], got {block_p}")
    n_q, dim = queries.shape
    n_p = points.shape[0]
    req(points.shape[1] == dim and query_ids.shape == (n_q,),
        "bin_hist: operand shapes disagree")
    smem = 4 * (dim * block_p + _QTILE * dim + 2 * _QTILE + n_bins)
    req(smem <= _build.SMEM_LIMIT,
        f"bin_hist: dim={dim}, n_bins={n_bins} need {smem} B of shared memory")
    bw = torch.as_tensor(bin_width, dtype=torch.float32, device=dev).reshape(1)
    counts = torch.zeros((n_bins,), dtype=torch.int64, device=dev)
    fn = _build.function("bin_hist", "bin_hist_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(points), p(query_ids), p(bw), p(counts), n_q, n_p,
             dim, n_bins, block_p, _build.stream())
    _build.check(err, "bin_hist_launch")
    launches += 1
    return counts.to(torch.float32)
