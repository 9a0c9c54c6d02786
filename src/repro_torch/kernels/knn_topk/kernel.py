"""Wrapper of the CUDA exact top-k kernel (``csrc/knn_topk.cu``), the port
of ``repro/kernels/knn_topk/kernel.py::knn_tile_topk``.

The kernel fuses the TPU path's cross-tile merge: each thread block walks
one contiguous split of the candidates, so the output is (n_splits, Q, k)
partials instead of (C / block_c, Q, k).  ``n_splits`` is chosen to give
the card about two blocks per SM.  ``metric`` is "l2" (squared L2) or
"ip" (the unclamped −q·c).  ``launches`` counts the launches per variant
(``knn_tile_topk``, ``knn_tile_topk[ip]``)."""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils import cdiv

MAX_UNROLLED_K = 32

launches: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_longlong]
             + [ctypes.c_int, ctypes.c_void_p])


def split_plan(n_q: int, n_c: int, block_q: int, block_c: int, n_sms: int):
    """(n_splits, per_split): candidate splits of block_c-aligned width,
    enough that query tiles × splits covers ~2 blocks per SM."""
    n_cb = max(1, cdiv(n_c, block_c))
    want = max(1, cdiv(2 * n_sms, max(1, cdiv(n_q, block_q))))
    per_split = cdiv(n_cb, min(want, n_cb)) * block_c
    return max(1, cdiv(n_c, per_split)), per_split


def knn_tile_topk(queries, candidates, query_ids, cand_ids, *, k: int,
                  block_q: int = 128, block_c: int = 256, metric: str = "l2"):
    """Per-split exact top-k partials: (dists (S, Q, k) f32, ids (S, Q, k)
    i32), −1 ids where inf.  Any Q and C (the kernel masks ragged edges)."""
    req = _build.require
    dev = queries.device
    req(dev.type == "cuda", "knn_topk kernel needs CUDA tensors")
    req(metric in ("l2", "ip"), f"metric must be 'l2' or 'ip', got {metric!r}")
    for name, t, dt in (("queries", queries, torch.float32),
                        ("candidates", candidates, torch.float32),
                        ("query_ids", query_ids, torch.int32),
                        ("cand_ids", cand_ids, torch.int32)):
        req(t.device == dev and t.dtype == dt and t.is_contiguous(),
            f"knn_topk: {name} must be a contiguous {dt} tensor on {dev}")
    req(1 <= k <= MAX_UNROLLED_K,
        f"knn_topk kernel keeps k <= MAX_UNROLLED_K={MAX_UNROLLED_K} in "
        f"registers, got k={k}")
    req(block_q % 32 == 0 and 32 <= block_q <= 1024,
        f"block_q must be a multiple of 32 in [32, 1024], got {block_q}")
    n_q, dim = queries.shape
    n_c = candidates.shape[0]
    req(candidates.shape[1] == dim, "queries and candidates differ in dim")
    smem = 4 * (block_c * max(dim, 32) + 2 * block_c + (dim * block_q if dim > 32 else 0))
    req(smem <= _build.SMEM_LIMIT,
        f"knn_topk: dim={dim} needs {smem} B of shared memory (> {_build.SMEM_LIMIT})")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, per_split = split_plan(n_q, n_c, block_q, block_c, n_sms)

    out_d = torch.empty((n_splits, n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_splits, n_q, k), dtype=torch.int32, device=dev)
    fn = _build.function("knn_topk", "knn_topk_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(candidates), p(query_ids), p(cand_ids), p(out_d),
             p(out_i), n_q, n_c, dim, k, block_q, block_c, n_splits, per_split,
             int(metric == "ip"), _build.stream())
    _build.check(err, "knn_topk_launch")
    launches["knn_tile_topk[ip]" if metric == "ip" else "knn_tile_topk"] += 1
    return out_d, out_i
