"""Wrapper of the CUDA streaming top-k kernel (``csrc/knn_stream.cu``).

One kernel serves both TPU entry points of
``repro/kernels/knn_stream/kernel.py``: the scalar-prefetch block-table
kernel (the dense engine's hot loop) and the contiguous padded kernel,
which is the block-table kernel with an identity table — one table shared
by every tile (tile stride 0) when all tiles scan the same candidates, or
the per-tile table ``identity_block_table`` when each tile scans its own
gathered candidates (the dense engine's gathered route, one launch per
chunk of tiles).

Both take ``metric`` ("l2" squared L2, "ip" the unclamped −q·c) and
queries and corpus in float32 or both in bfloat16 (upcast exactly in the
kernel, fp32 arithmetic), at any width.  One block of 256 threads owns a
``TILE_Q``-query tile: it compacts the tile's candidate stream (the
positions whose id is ≥ 0, ``LCAP`` positions a window) and scores it in
``TILE_C``-candidate tiles on the register-tiled score tile of
``csrc/score_tile.cuh``, staging the d axis in ``CHUNK_D``-dim chunks;
``smem_bytes`` is the plan.  ``launches`` counts the launches per variant:
``knn_stream_topk_prefetch``, ``knn_stream_topk_padded``, with ``[ip]``
and ``[bf16]`` appended for those variants.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.knn_topk.kernel import kmax

MAX_UNROLLED_K = 32
TILE_Q = 128                  # queries per block (score_tile.cuh TQ)
TILE_C = 128                  # candidates per score tile (TC)
CHUNK_D = 8                   # dims per staged chunk (BK)
QCAP = 32                     # queued survivors per query per round
LCAP = 4096                   # stream positions compacted per window

launches: collections.Counter = collections.Counter()

_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
    + [ctypes.c_longlong] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)


def variant(entry: str, metric: str = "l2", dtype=torch.float32) -> str:
    """Launch-counter key: the entry name with ``[ip]``/``[bf16]`` tags."""
    return (entry + ("[ip]" if metric == "ip" else "")
            + ("[bf16]" if dtype == torch.bfloat16 else ""))


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block (mirrors ``knn_stream.cu``): two
    double-buffered transposed chunks, the top-k lists, the survivor
    queues, six per-query and five per-candidate vectors, the compacted
    window and the per-warp counts.  It does not depend on the width."""
    chunk = CHUNK_D * (TILE_Q + 4)
    return 4 * (4 * chunk + 2 * TILE_Q * kmax(k) + 2 * TILE_Q * QCAP + 6 * TILE_Q
                + 5 * TILE_C + LCAP + 8)


def identity_block_table(n_tiles: int, nblk: int, device) -> torch.Tensor:
    """(n_tiles, nblk) i32 ``table[t, j] = t·nblk + j``: tile t's blocks of
    a (n_tiles·nblk·block_c, D) array of per-tile gathered candidates."""
    return torch.arange(n_tiles * nblk, dtype=torch.int32, device=device).reshape(n_tiles, nblk)


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
        f"in its top-k lists, got k={k}")
    req(block_q == TILE_Q, f"knn_stream: block_q must be {TILE_Q} (the kernel's query tile)")
    req(block_c >= 1, f"block_c must be >= 1, got {block_c}")
    dim = queries.shape[1]
    req(corpus.shape[1] == dim and corpus.shape[0] % block_c == 0,
        f"corpus {tuple(corpus.shape)} must be (C, {dim}) with C % {block_c} == 0")
    req(corpus.shape[0] < 2**31 and nblk * block_c < 2**31,
        "knn_stream: corpus rows and stream positions must fit int32")
    req(queries.shape[0] == n_tiles * block_q, "queries must hold n_tiles·block_q rows")
    eps = torch.as_tensor(eps2, dtype=torch.float32, device=dev).reshape(1)

    rows = n_tiles * block_q
    out_d = torch.empty((rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((rows, k), dtype=torch.int32, device=dev)
    found = torch.empty((rows,), dtype=torch.int32, device=dev)
    fn = _build.function("knn_stream", "knn_stream_topk_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(corpus), p(block_table), bt_stride, p(query_ids),
             p(cand_ids), cid_stride, p(eps), p(out_d), p(out_i), p(found),
             n_tiles, nblk, dim, k, block_c, int(metric == "ip"),
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
    """Contiguous streaming top-k (``knn_stream_topk_padded``).  With
    candidates (C, D) and cand_ids (C,) every query tile scans all of them;
    with candidates (T, C, D) and cand_ids (T, C) — one launch for a chunk
    of the gathered route's tiles — tile t scans its own.
    Q = T·block_q, C % block_c == 0."""
    batched = candidates.dim() == 3
    n_c, dim = candidates.shape[-2:]
    _build.require(queries.shape[0] % block_q == 0 and n_c % block_c == 0,
                   "knn_stream_topk_padded needs padded operands")
    n_tiles, nblk = queries.shape[0] // block_q, n_c // block_c
    if batched:
        _build.require(candidates.shape[0] == n_tiles
                       and tuple(cand_ids.shape) == (n_tiles, n_c),
                       f"knn_stream_topk_padded: per-tile candidates "
                       f"{tuple(candidates.shape)} / ids {tuple(cand_ids.shape)} do not "
                       f"match {n_tiles} query tiles")
        table = identity_block_table(n_tiles, nblk, queries.device)
        corpus, strides = candidates.reshape(n_tiles * n_c, dim), (nblk, n_c)
    else:
        table = torch.arange(nblk, dtype=torch.int32, device=queries.device)
        corpus, strides = candidates, (0, 0)
    out = _launch(queries, corpus, table, strides[0], query_ids, cand_ids, strides[1],
                  eps2, n_tiles=n_tiles, nblk=nblk, k=k, block_q=block_q,
                  block_c=block_c, metric=metric)
    launches[variant("knn_stream_topk_padded", metric, queries.dtype)] += 1
    return out
