"""Wrapper of the CUDA distance-bin histogram kernel (``csrc/bin_hist.cu``),
the port of ``repro/kernels/bin_hist/kernel.py::distance_bin_histogram``.

One kernel for every width: a block scores a 128-query × 128-point tile
in registers (``score_tile.cuh``), staging the d axis in ``CHUNK_D``-dim
chunks, and walks one contiguous split of the points; ``split_plan`` (the
``knn_topk`` kernel's) sizes the splits to fill whole waves of two blocks
per SM.  Each warp counts into its own shared-memory sub-histogram
(``smem_bytes`` is the plan)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.knn_topk.kernel import split_plan
from repro_torch.utils import cdiv

TILE_Q = 128                  # sampled queries per block tile (score_tile.cuh TQ)
TILE_P = 128                  # points per block tile (TC)
CHUNK_D = 8                   # dims per staged chunk (BK)
WARPS = 8                     # warps per block, one sub-histogram each
MAX_SPLIT = 1 << 27           # points per split: a warp's int counts cannot overflow

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
             + [ctypes.c_void_p])


def smem_bytes(n_bins: int) -> int:
    """Dynamic shared memory of one block (mirrors ``bin_hist.cu``): two
    double-buffered transposed chunks, the tile's query and point norms and
    query ids, and one int sub-histogram per warp.  It does not depend on
    the width."""
    chunk = CHUNK_D * (TILE_Q + 4)
    return 4 * (4 * chunk + 3 * TILE_Q) + 4 * WARPS * n_bins


def distance_bin_histogram(queries, points, query_ids, bin_width, *, n_bins: int):
    """(n_bins,) f32 counts over all (query, point) pairs; point ids are the
    row indices of ``points``, so ``query_ids`` carries the self-exclusion
    (−1 ⇒ the query row is skipped).  ``bin_width`` is a () f32 tensor on
    the card (or a float)."""
    global launches
    req = _build.require
    req(n_bins >= 1, f"bin_hist: n_bins must be >= 1, got {n_bins}")
    smem = smem_bytes(n_bins)
    req(smem <= _build.SMEM_LIMIT,
        f"bin_hist: n_bins={n_bins} needs {smem} B of shared memory per block, "
        f"more than the {_build.SMEM_LIMIT} B one H100 block may use")
    dev = queries.device
    req(dev.type == "cuda", "bin_hist kernel needs CUDA tensors")
    for name, t, dt in (("queries", queries, torch.float32),
                        ("points", points, torch.float32),
                        ("query_ids", query_ids, torch.int32)):
        req(t.device == dev and t.dtype == dt and t.is_contiguous(),
            f"bin_hist: {name} must be a contiguous {dt} tensor on {dev}")
    n_q, dim = queries.shape
    n_p = points.shape[0]
    req(points.shape[1] == dim and query_ids.shape == (n_q,) and dim >= 1,
        "bin_hist: operand shapes disagree")
    req(cdiv(n_q, TILE_Q) <= 65535, f"bin_hist: {n_q} sampled queries exceed the grid")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, per_split = split_plan(n_q, n_p, TILE_Q, TILE_P, n_sms)
    per_split = min(per_split, MAX_SPLIT)
    n_splits = max(1, cdiv(n_p, per_split))
    bw = torch.as_tensor(bin_width, dtype=torch.float32, device=dev).reshape(1)
    counts = torch.zeros((n_bins,), dtype=torch.int64, device=dev)
    fn = _build.function("bin_hist", "bin_hist_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(points), p(query_ids), p(bw), p(counts), n_q, n_p,
             dim, n_bins, n_splits, per_split, _build.stream())
    _build.check(err, "bin_hist_launch")
    launches += 1
    return counts.to(torch.float32)
