"""Plain PyTorch version of the streaming distance + ε-filtered top-k.

Deliberately materialize-then-sort: the full distance matrix in the
difference form (q − c)², ε-masked, then one stable sort (``lax.top_k``
keeps the lowest index on ties; ``torch.topk`` promises no tie order, so a
stable ``torch.sort`` takes its place).  The CUDA kernel computes the
expansion |q|² + |c|² − 2q·c, so the two agree modulo last-ulp ε²-boundary
flips and distance ties.  Under ``metric="ip"`` both score −q·c, unclamped.
bf16 operands are upcast exactly and scored in fp32.
"""
from __future__ import annotations

import torch

# Budget for the difference tensors: the plain versions run over chunks of
# queries (tiles) so that a main-path-sized call stays within a few GB.
_DIFF_BYTES = 1 << 30


def _topk_rows(d: torch.Tensor, ids: torch.Tensor, keep: torch.Tensor, k: int):
    """k smallest kept entries per row, stable on ties; ids −1 where inf."""
    dm = torch.where(keep, d, torch.full_like(d, float("inf")))
    vals, sel = torch.sort(dm, dim=-1, stable=True)
    kd = vals[..., :k]
    ki = torch.gather(ids.expand_as(dm), -1, sel[..., :k])
    ki = torch.where(torch.isinf(kd), torch.full_like(ki, -1), ki)
    return kd, ki


def _scores(q, c, metric: str):
    """(…, Q, D) × (…, C, D) f32 -> (…, Q, C) squared L2 (difference form)
    or −q·c."""
    if metric == "ip":
        return -(q @ c.transpose(-1, -2))
    diff = q[..., :, None, :] - c[..., None, :, :]
    return (diff * diff).sum(-1)


def knn_stream_topk_ref(queries, candidates, query_ids, cand_ids, eps2, *, k: int,
                        metric: str = "l2"):
    """ε-filtered exact k nearest candidates per query.

    Returns (dists (Q, k) f32 ascending inf-padded, ids (Q, k) i32
    −1-padded, found (Q,) i32 in-range candidates, self excluded)."""
    c = candidates.float()
    cid = cand_ids.to(torch.int32)[None, :]
    qid = query_ids.to(torch.int32)
    chunk = max(1, _DIFF_BYTES // max(1, c.numel() * 4))
    outs = []
    for q0 in range(0, queries.shape[0], chunk):
        d = _scores(queries[q0:q0 + chunk].float(), c, metric)    # (Qc, C)
        keep = (cid >= 0) & (qid[q0:q0 + chunk, None] != cid) & (d <= eps2)
        kd, ki = _topk_rows(d, cid, keep, k)
        outs.append((kd, ki, keep.sum(1).to(torch.int32)))
    return tuple(torch.cat(x) for x in zip(*outs))


def knn_stream_topk_prefetch_ref(queries, corpus, block_table, query_ids,
                                 cand_ids, eps2, *, k: int, block_q: int = 128,
                                 block_c: int = 128, metric: str = "l2"):
    """Plain version of the block-table kernel: gather each tile's
    block-aligned candidate rows explicitly — the data movement the
    kernel performs itself — and run the materialize-then-sort version
    per tile (batched over chunks of tiles)."""
    n_tiles, nblk = block_table.shape
    dim = queries.shape[1]
    width = nblk * block_c
    q_t = queries.float().reshape(n_tiles, block_q, dim)
    qid_t = query_ids.to(torch.int32).reshape(n_tiles, block_q)
    offs = torch.arange(block_c, device=queries.device)
    chunk = max(1, _DIFF_BYTES // max(1, block_q * width * dim * 4))
    outs = []
    for t0 in range(0, n_tiles, chunk):
        t1 = min(n_tiles, t0 + chunk)
        rows = (block_table[t0:t1].long()[:, :, None] * block_c + offs).reshape(t1 - t0, -1)
        cand = corpus[rows].float()                              # (tc, width, D)
        d = _scores(q_t[t0:t1], cand, metric)                     # (tc, bq, width)
        cid = cand_ids[t0:t1].to(torch.int32)[:, None, :]
        keep = (cid >= 0) & (qid_t[t0:t1, :, None] != cid) & (d <= eps2)
        kd, ki = _topk_rows(d, cid, keep, k)
        outs.append((kd, ki, keep.sum(-1).to(torch.int32)))
    kd, ki, found = (torch.cat(x) for x in zip(*outs))
    return kd.reshape(-1, k), ki.reshape(-1, k), found.reshape(-1)
