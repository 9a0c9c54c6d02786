"""Dispatch for the exact per-query top-k: the plain version for a CPU
tensor, the CUDA kernel (plus the stable merge of its split partials) for a
CUDA tensor.  Oversized k reroutes to the plain version, counted in
``oversized_k_reroutes``, as the JAX ops reroute it to the ref oracle."""
from __future__ import annotations

import torch

from repro_torch.kernels.knn_topk import kernel as _kernel
from repro_torch.kernels.knn_topk import ref as _ref

oversized_k_reroutes = 0


def knn_topk(queries, candidates, query_ids, cand_ids, *, k: int,
             block_q: int = 128, block_c: int = 256, metric: str = "l2"):
    """Exact k nearest candidates per query (self/invalid excluded).

    Returns (dists (Q, k) f32 ascending — squared L2, or −q·c under
    ``metric="ip"`` — and ids (Q, k) i32, −1 where fewer than k candidates
    exist)."""
    global oversized_k_reroutes
    if not queries.is_cuda or k > _kernel.MAX_UNROLLED_K:
        if queries.is_cuda:
            oversized_k_reroutes += 1
        return _ref.knn_topk_ref(queries, candidates, query_ids, cand_ids, k=k,
                                 metric=metric)
    pd, pi = _kernel.knn_tile_topk(
        queries.float().contiguous(), candidates.float().contiguous(),
        query_ids.to(torch.int32).contiguous(),
        cand_ids.to(torch.int32).contiguous(),
        k=k, block_q=block_q, block_c=block_c, metric=metric)
    if pd.shape[0] == 1:
        return pd[0], pi[0]
    return _ref.merge_topk_ref(pd, pi, k=k)


def merge_running_topk(run_d, run_i, new_d, new_i, *, k: int):
    """Merge two (Q, k) top-k buffers into one; ties keep the running
    buffer's entries first (plain code: a stable sort)."""
    d = torch.cat([run_d, new_d], dim=1)
    i = torch.cat([run_i, new_i], dim=1)
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :k], i.gather(1, pos[:, :k])
