"""Dispatch for the streaming distance + top-k engine: the plain version
for a CPU tensor, the CUDA kernel for a CUDA tensor.

Oversized k (> ``MAX_UNROLLED_K``) reroutes ``knn_stream_topk`` and
``knn_stream_topk_tiles`` to the plain version on either device, as the
JAX ops do: the kernel's top-k lists hold k up to that ceiling.  The
reroute is counted (``oversized_k_reroutes``) and logged once per process.
"""
from __future__ import annotations

import logging

import torch

from repro_torch.kernels.knn_stream import kernel as _kernel
from repro_torch.kernels.knn_stream import ref as _ref
from repro_torch.utils import cdiv, round_up

_log = logging.getLogger(__name__)

oversized_k_reroutes = 0
_oversized_k_warned = False


def _reroute_oversized_k(k: int) -> None:
    global oversized_k_reroutes, _oversized_k_warned
    oversized_k_reroutes += 1
    if not _oversized_k_warned:
        _oversized_k_warned = True
        _log.warning(
            "knn_stream: k=%d exceeds MAX_UNROLLED_K=%d — routing to the "
            "materialize-then-sort plain version (exact, but without the "
            "streaming kernel's memory ceiling; later reroutes are silent)",
            k, _kernel.MAX_UNROLLED_K,
        )


def _pad_rows(x: torch.Tensor, rows: int, value) -> torch.Tensor:
    if x.shape[0] == rows:
        return x.contiguous()
    out = torch.full((rows,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out


def knn_stream_topk(queries, candidates, query_ids, cand_ids, eps2, *, k: int,
                    block_q: int = 128, block_c: int = 128, metric: str = "l2"):
    """One-pass ε-filtered top-k over arbitrary (unpadded) shapes; scores
    are squared L2, or −q·c under ``metric="ip"``.

    Returns (dists (Q, k) ascending inf-padded, ids (Q, k) −1-padded,
    found (Q,) i32 — in-range candidates, self/invalid excluded)."""
    if not queries.is_cuda or k > _kernel.MAX_UNROLLED_K:
        if queries.is_cuda:
            _reroute_oversized_k(k)
        return _ref.knn_stream_topk_ref(
            queries, candidates, query_ids, cand_ids, eps2, k=k, metric=metric)
    q_n = queries.shape[0]
    qp = round_up(max(q_n, 1), block_q)
    cp = round_up(max(candidates.shape[0], 1), block_c)
    kd, ki, found = _kernel.knn_stream_topk_padded(
        _pad_rows(queries.float(), qp, 0.0),
        _pad_rows(candidates.float(), cp, 0.0),
        _pad_rows(query_ids.to(torch.int32), qp, -1),
        _pad_rows(cand_ids.to(torch.int32), cp, -1),
        eps2, k=k, block_q=block_q, block_c=block_c, metric=metric,
    )
    return kd[:q_n], ki[:q_n], found[:q_n]


def knn_stream_topk_prefetch(queries, corpus, block_table, query_ids, cand_ids,
                             eps2, *, k: int, block_q: int = 128,
                             block_c: int = 128, metric: str = "l2"):
    """Block-table streaming top-k (operands pre-padded by the dense
    engine — the block table fixes the shapes).  Queries and corpus are
    both f32, or both bf16 (the dense engine's bf16 distance mode)."""
    if not queries.is_cuda:
        return _ref.knn_stream_topk_prefetch_ref(
            queries, corpus, block_table, query_ids, cand_ids, eps2,
            k=k, block_q=block_q, block_c=block_c, metric=metric)
    return _kernel.knn_stream_topk_prefetch(
        queries, corpus, block_table, query_ids, cand_ids, eps2,
        k=k, block_q=block_q, block_c=block_c, metric=metric)


def knn_stream_topk_tiles(queries, candidates, query_ids, cand_ids, eps2, *, k: int,
                          block_c: int = 128, metric: str = "l2"):
    """Per-tile streaming top-k over a chunk of gathered tiles (the dense
    engine's gathered route): tile t's queries (T, TQ, D) against its own
    candidates (T, TC, D), TC % block_c == 0; query_ids (T, TQ) exclusion
    ids, cand_ids (T, TC) (−1 = padding).  On the card one launch scores
    every tile (``knn_stream_topk_padded``, a per-tile identity table); the
    plain version, with the same table, serves a CPU tensor or k >
    ``MAX_UNROLLED_K``.

    Returns (dists (T·TQ, k) ascending inf-padded, ids (T·TQ, k)
    −1-padded, found (T·TQ,) i32)."""
    n_tiles, tq, dim = queries.shape
    q = queries.reshape(n_tiles * tq, dim)
    qid = query_ids.to(torch.int32).reshape(-1).contiguous()
    cid = cand_ids.to(torch.int32).contiguous()
    if not queries.is_cuda or k > _kernel.MAX_UNROLLED_K:
        if queries.is_cuda:
            _reroute_oversized_k(k)
        table = _kernel.identity_block_table(n_tiles, cdiv(candidates.shape[1], block_c),
                                             queries.device)
        return _ref.knn_stream_topk_prefetch_ref(
            q, candidates.reshape(-1, dim), table, qid, cid, eps2, k=k, block_q=tq,
            block_c=block_c, metric=metric)
    return _kernel.knn_stream_topk_padded(
        q.float().contiguous(), candidates.float().contiguous(), qid, cid, eps2,
        k=k, block_q=tq, block_c=block_c, metric=metric)
