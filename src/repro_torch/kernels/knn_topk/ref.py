"""Plain PyTorch version of the exact per-query top-k (brute lane).

Difference-form distances and a stable sort, mirroring the JAX
``knn_topk/ref.py`` (whose ``lax.top_k`` keeps the lowest index on ties)."""
from __future__ import annotations

import torch

# Budget for the (query chunk, C, D) difference tensor.
_DIFF_BYTES = 1 << 28


def knn_topk_ref(queries, candidates, query_ids, cand_ids, *, k: int,
                 metric: str = "l2"):
    """Exact k nearest candidates per query: (dists (Q, k) f32 ascending,
    ids (Q, k) i32, −1 where fewer than k valid candidates exist).
    Candidates with id < 0 and the query's own id are excluded.  Scores are
    squared L2, or the negated inner product −q·c (may be negative) under
    ``metric="ip"``."""
    c = candidates.float()
    cid = cand_ids.to(torch.int32)[None, :]
    qid = query_ids.to(torch.int32)
    chunk = max(1, _DIFF_BYTES // max(1, c.numel() * 4))
    outs = []
    for q0 in range(0, queries.shape[0], chunk):
        q = queries[q0:q0 + chunk].float()
        if metric == "ip":
            d = -(q @ c.T)
        else:
            diff = q[:, None, :] - c[None, :, :]
            d = (diff * diff).sum(-1)
        invalid = (cid < 0) | (qid[q0:q0 + chunk, None] == cid)
        d = torch.where(invalid, torch.full_like(d, float("inf")), d)
        vals, sel = torch.sort(d, dim=1, stable=True)
        dk = vals[:, :k]
        ids = cid.expand_as(d).gather(1, sel[:, :k])
        outs.append((dk, torch.where(torch.isinf(dk), torch.full_like(ids, -1), ids)))
    return tuple(torch.cat(x) for x in zip(*outs))


def merge_topk_ref(dists, ids, *, k: int):
    """Reduce (R, Q, k) partial top-ks over axis 0 -> exact (Q, k); ties
    keep partial order (partial 0 first)."""
    r, q, kk = dists.shape
    flat_d = dists.permute(1, 0, 2).reshape(q, r * kk)
    flat_i = ids.permute(1, 0, 2).reshape(q, r * kk)
    vals, pos = torch.sort(flat_d, dim=1, stable=True)
    return vals[:, :k], flat_i.gather(1, pos[:, :k])
