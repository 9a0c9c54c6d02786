"""Wrapper of the CUDA distance-bin histogram kernel (``csrc/bin_hist.cu``),
the port of ``repro/kernels/bin_hist/kernel.py::distance_bin_histogram``.

Rows of up to 32 dims are staged whole, ``block_p`` points per block;
wider rows in ``WIDE_D``-dim chunks, ``WIDE_P`` points and ``WIDE_G``
sampled queries at a time, so any width fits (``smem_bytes`` is the
plan)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_QTILE = 64                   # sampled queries per shared-memory tile (bin_hist.cu)
WIDE_G = 32                   # sampled queries per group of the wide kernel (HG)
WIDE_D = 32                   # dims per staged chunk of the wide kernel (HD)
WIDE_P = 256                  # points (threads) per block of the wide kernel (TP)

launches = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def smem_bytes(dim: int, n_bins: int, block_p: int) -> int:
    """Dynamic shared memory of one block (mirrors ``bin_hist.cu``)."""
    if dim <= _build.NARROW_DIM:
        return 4 * (dim * block_p + _QTILE * dim + 2 * _QTILE + n_bins)
    return 4 * (WIDE_D * (WIDE_P + 4) + WIDE_D * (WIDE_G + 4) + WIDE_P + 2 * WIDE_G + n_bins)


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
    smem = smem_bytes(dim, n_bins, block_p)
    req(smem <= _build.SMEM_LIMIT,
        f"bin_hist: n_bins={n_bins} needs {smem} B of shared memory")
    bw = torch.as_tensor(bin_width, dtype=torch.float32, device=dev).reshape(1)
    counts = torch.zeros((n_bins,), dtype=torch.int64, device=dev)
    fn = _build.function("bin_hist", "bin_hist_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(points), p(query_ids), p(bw), p(counts), n_q, n_p,
             dim, n_bins, block_p, _build.stream())
    _build.check(err, "bin_hist_launch")
    launches += 1
    return counts.to(torch.float32)
