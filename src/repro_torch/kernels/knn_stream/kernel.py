"""Wrapper of the CUDA streaming top-k kernel (``csrc/knn_stream.cu``).

One kernel serves both TPU entry points of
``repro/kernels/knn_stream/kernel.py``: the scalar-prefetch block-table
kernel (the dense engine's hot loop) and the contiguous padded kernel,
which is the block-table kernel with one identity table shared by every
tile (tile stride 0).

Both take ``metric`` ("l2" squared L2, "ip" the unclamped −q·c) and
queries and corpus in float32 or both in bfloat16 (upcast exactly in the
kernel, fp32 arithmetic), at any width: rows of up to 32 dims sit whole in
registers and shared memory, wider rows are staged in ``WIDE_D``-dim
chunks, ``WIDE_G`` candidates at a time (``smem_bytes`` is the plan).
``launches`` counts the launches per variant: ``knn_stream_topk_prefetch``,
``knn_stream_topk_padded``, with ``[ip]`` and ``[bf16]`` appended for
those variants.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

MAX_UNROLLED_K = 32
WIDE_G = 32                   # candidates per group of the wide kernel (WG)
WIDE_D = 32                   # dims per staged chunk of the wide kernel (WD)

launches: collections.Counter = collections.Counter()

_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
    + [ctypes.c_void_p]
)


def variant(entry: str, metric: str = "l2", dtype=torch.float32) -> str:
    """Launch-counter key: the entry name with ``[ip]``/``[bf16]`` tags."""
    return (entry + ("[ip]" if metric == "ip" else "")
            + ("[bf16]" if dtype == torch.bfloat16 else ""))


def smem_bytes(dim: int, block_q: int, block_c: int) -> int:
    """Dynamic shared memory of one block (mirrors ``knn_stream.cu``): a
    narrow row (≤ 32 dims) stages the whole corpus block at its padded
    width; a wide one a transposed query chunk, one candidate group's chunk
    and norms, and the slot's ids."""
    if dim <= _build.NARROW_DIM:
        dp = next(p for p in (8, 16, 24, 32) if dim <= p)
        return 4 * (block_c * dp + 2 * block_c)
    ids = -(-block_c // WIDE_G) * WIDE_G
    return 4 * (WIDE_D * (block_q + 1) + WIDE_G * WIDE_D + WIDE_G + ids)


def _launch(queries, corpus, block_table, bt_stride, query_ids, cand_ids,
            cid_stride, eps2, *, n_tiles, nblk, k, block_q, block_c, metric):
    req = _build.require
    dev = queries.device
    req(dev.type == "cuda", "knn_stream kernel needs CUDA tensors")
    req(metric in ("l2", "ip"), f"metric must be 'l2' or 'ip', got {metric!r}")
    op_dt = queries.dtype
    req(op_dt in (torch.float32, torch.bfloat16),
        f"knn_stream: queries must be float32 or bfloat16, got {op_dt}")
    for name, t, dt in (("queries", queries, op_dt),
                        ("corpus", corpus, op_dt),
                        ("block_table", block_table, torch.int32),
                        ("query_ids", query_ids, torch.int32),
                        ("cand_ids", cand_ids, torch.int32)):
        req(t.device == dev and t.dtype == dt and t.is_contiguous(),
            f"knn_stream: {name} must be a contiguous {dt} tensor on {dev}")
    req(1 <= k <= MAX_UNROLLED_K,
        f"knn_stream kernel keeps k <= MAX_UNROLLED_K={MAX_UNROLLED_K} "
        f"in registers, got k={k}")
    req(block_q % 32 == 0 and 32 <= block_q <= 1024,
        f"block_q must be a multiple of 32 in [32, 1024], got {block_q}")
    dim = queries.shape[1]
    req(corpus.shape[1] == dim and corpus.shape[0] % block_c == 0,
        f"corpus {tuple(corpus.shape)} must be (C, {dim}) with C % {block_c} == 0")
    req(queries.shape[0] == n_tiles * block_q, "queries must hold n_tiles·block_q rows")
    smem = smem_bytes(dim, block_q, block_c)
    req(smem <= _build.SMEM_LIMIT,
        f"knn_stream: block_c={block_c} needs {smem} B of shared memory "
        f"(> {_build.SMEM_LIMIT})")
    eps = torch.as_tensor(eps2, dtype=torch.float32, device=dev).reshape(1)

    rows = n_tiles * block_q
    out_d = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    found = torch.empty((rows,), dtype=torch.int32, device=dev)
    fn = _build.function("knn_stream", "knn_stream_topk_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(corpus), p(block_table), bt_stride, p(query_ids),
             p(cand_ids), cid_stride, p(eps), p(out_d), p(out_i), p(found),
             n_tiles, nblk, dim, k, block_q, block_c, int(metric == "ip"),
             int(op_dt == torch.bfloat16), _build.stream())
    _build.check(err, "knn_stream_topk_launch")
    return out_d, out_i, found


def knn_stream_topk_prefetch(queries, corpus, block_table, query_ids, cand_ids,
                             eps2, *, k: int, block_q: int = 128,
                             block_c: int = 128, metric: str = "l2"):
    """Block-table streaming top-k (``knn_stream_topk_prefetch`` of the JAX
    package): tile i scores the ``block_c``-row corpus blocks named by
    ``block_table[i]`` against its ``block_q`` query rows.

    queries (T·block_q, D) and corpus (C, D), C % block_c == 0, both f32
    or both bf16;
    block_table (T, nblk) i32; query_ids (T·block_q,) i32 exclusion ids;
    cand_ids (T, nblk·block_c) i32, −1 = row outside the tile's union;
    eps2 a () f32 tensor on the card (or a float).
    Returns (dists (T·block_q, k) f32, ids i32, found (T·block_q,) i32)."""
    n_tiles, nblk = block_table.shape
    _build.require(tuple(cand_ids.shape) == (n_tiles, nblk * block_c),
                   f"cand_ids {tuple(cand_ids.shape)} != ({n_tiles}, {nblk * block_c})")
    out = _launch(queries, corpus, block_table, nblk, query_ids, cand_ids,
                  nblk * block_c, eps2, n_tiles=n_tiles, nblk=nblk, k=k,
                  block_q=block_q, block_c=block_c, metric=metric)
    launches[variant("knn_stream_topk_prefetch", metric, queries.dtype)] += 1
    return out


def knn_stream_topk_padded(queries, candidates, query_ids, cand_ids, eps2, *,
                           k: int, block_q: int = 128, block_c: int = 128,
                           metric: str = "l2"):
    """Contiguous streaming top-k (``knn_stream_topk_padded``): every query
    tile scans all of ``candidates``.  Q % block_q == 0, C % block_c == 0."""
    n_c = candidates.shape[0]
    _build.require(queries.shape[0] % block_q == 0 and n_c % block_c == 0,
                   "knn_stream_topk_padded needs padded operands")
    n_cb = n_c // block_c
    table = torch.arange(n_cb, dtype=torch.int32, device=queries.device)
    out = _launch(queries, candidates, table, 0, query_ids, cand_ids, 0, eps2,
                  n_tiles=queries.shape[0] // block_q, nblk=n_cb, k=k,
                  block_q=block_q, block_c=block_c, metric=metric)
    launches[variant("knn_stream_topk_padded", metric, queries.dtype)] += 1
    return out
