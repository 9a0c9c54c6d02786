"""Wrapper of the CUDA exact top-k kernel (``csrc/knn_topk.cu``), the port
of ``repro/kernels/knn_topk/kernel.py::knn_tile_topk``.

The kernel fuses the TPU path's cross-tile merge: each thread block walks
one contiguous split of the candidates, so the output is (n_splits, Q, k)
partials instead of (C / block_c, Q, k).  A block scores a 128-query ×
128-candidate tile in registers, staging the d axis in ``CHUNK_D``-dim
chunks (any width), and keeps each query's top-k in shared memory behind a
threshold filter.  ``split_plan`` sizes the splits to fill whole waves of
two blocks per SM.  ``metric`` is "l2" (squared L2) or "ip" (the
unclamped −q·c).  ``launches`` counts the launches per variant
(``knn_tile_topk``, ``knn_tile_topk[ip]``)."""
from __future__ import annotations

import collections
import ctypes
from fractions import Fraction

import torch

from repro_torch.kernels import _build
from repro_torch.utils import cdiv

MAX_UNROLLED_K = 32
TILE_Q = 128                  # queries per block tile (knn_topk.cu TQ)
TILE_C = 128                  # candidates per block tile (TC)
CHUNK_D = 8                   # dims per staged chunk (BK)
QCAP = 32                     # queued survivors per query per round

launches: collections.Counter = collections.Counter()

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong]
             + [ctypes.c_int, ctypes.c_void_p])


def kmax(k: int) -> int:
    """The compile-time top-k capacity that holds ``k`` (8, 16 or 32)."""
    return 8 if k <= 8 else 16 if k <= 16 else 32


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block (mirrors ``knn_topk.cu``):
    two double-buffered transposed chunks, the top-k lists, the survivor
    queues and seven per-row/column vectors.  It does not depend on the
    width."""
    chunk = CHUNK_D * (TILE_Q + 4)
    return 4 * (4 * chunk + 2 * TILE_Q * kmax(k) + 2 * TILE_Q * QCAP + 7 * TILE_Q)


def split_plan(n_q: int, n_c: int, block_q: int, block_c: int, n_sms: int):
    """(n_splits, per_split): candidate splits of block_c-aligned width.
    The card runs 2·n_sms blocks at once (one wave); the split count s
    minimizes the waves each candidate costs, ⌈tiles·s / wave⌉ / s (the
    smallest such s), so that a few query tiles still fill the card and no
    last wave runs nearly empty."""
    n_cb = max(1, cdiv(n_c, block_c))
    tiles = max(1, cdiv(n_q, block_q))
    wave = 2 * n_sms
    s = min(range(1, min(n_cb, max(2, cdiv(2 * wave, tiles))) + 1),
            key=lambda s: (Fraction(cdiv(tiles * s, wave), s), s))
    per_split = cdiv(n_cb, s) * block_c
    return max(1, cdiv(n_c, per_split)), per_split


def knn_tile_topk(queries, candidates, query_ids, cand_ids, *, k: int,
                  block_q: int = 128, block_c: int = 256, metric: str = "l2"):
    """Per-split exact top-k partials: (dists (S, Q, k) f32, ids (S, Q, k)
    i32), −1 ids where inf.  Any Q, C and width (the kernel masks ragged
    edges and stages the d axis in chunks).  ``block_q`` is the kernel's
    query tile; ``block_c`` the alignment of the candidate splits."""
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
    req(block_q == TILE_Q, f"knn_topk: block_q must be {TILE_Q} (the kernel's query tile)")
    req(block_c >= TILE_C and block_c % TILE_C == 0,
        f"knn_topk: block_c must be a multiple of {TILE_C}, got {block_c}")
    n_q, dim = queries.shape
    n_c = candidates.shape[0]
    req(candidates.shape[1] == dim, "queries and candidates differ in dim")
    req(n_c < 2**31, f"knn_topk: {n_c} candidates exceed int32 columns")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_splits, per_split = split_plan(n_q, n_c, block_q, block_c, n_sms)

    out_d = torch.empty((n_splits, n_q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_splits, n_q, k), dtype=torch.int32, device=dev)
    fn = _build.function("knn_topk", "knn_topk_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(candidates), p(query_ids), p(cand_ids), p(out_d),
             p(out_i), n_q, n_c, dim, k, n_splits, per_split,
             int(metric == "ip"), _build.stream())
    _build.check(err, "knn_topk_launch")
    launches["knn_tile_topk[ip]" if metric == "ip" else "knn_tile_topk"] += 1
    return out_d, out_i
