"""Brute-force KNN (the paper's GPU-JOINLINEAR baseline, §VI-D) and the
exact fallback for the sparse engine's certification misses, in PyTorch.

Port of ``repro/core/brute.py``.  On the card, for k within the
``knn_topk`` kernel's reach, one kernel call takes the whole corpus: the
kernel splits the candidates across thread blocks and keeps each running
top-k on chip.  Otherwise — on the CPU, and on the card for larger k,
where each call reroutes to the plain version as the JAX ops do — the
corpus is streamed in fixed chunks merged into a running (Q, K) buffer,
the reference's plan, so memory stays O(Q·K + Q·chunk) whatever |D| is."""
from __future__ import annotations

import torch

from repro_torch.core import dense_join as dense_lib
from repro_torch.kernels.knn_topk import kernel as topk_kernel
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.utils import round_up


def corpus_chunk_plan(device, n_corpus: int, k: int, corpus_chunk: int):
    """Corpus rows per ``knn_topk`` call: None for one call over the whole
    corpus (a CUDA device and k ≤ ``MAX_UNROLLED_K``), else the width of
    the streamed chunks, ``corpus_chunk`` cut to the corpus size rounded
    up to 8 as the reference cuts it."""
    if torch.device(device).type == "cuda" and k <= topk_kernel.MAX_UNROLLED_K:
        return None
    return min(corpus_chunk, round_up(n_corpus, 8))


def brute_knn(corpus: torch.Tensor, queries: torch.Tensor,
              query_ids: torch.Tensor, *, k: int, corpus_chunk: int = 4096,
              metric: str = "l2"):
    """Exact K nearest neighbors of each query over the whole corpus.
    Returns (dists (Q, k) ascending raw scores — squared L2, or the negated
    inner product −q·c under ``metric="ip"`` — and ids (Q, k), −1-padded);
    ``query_ids`` carries the self-exclusion (−1 = padding row).
    ``corpus_chunk`` bounds the memory of the streamed route
    (``corpus_chunk_plan``); equal scores keep the lower corpus row first
    on either route."""
    dense_lib.check_engine_args(metric, "fp32")
    n_corpus = corpus.shape[0]
    dev = corpus.device
    ids = torch.arange(n_corpus, dtype=torch.int32, device=dev)
    chunk = corpus_chunk_plan(dev, n_corpus, k, corpus_chunk)
    if chunk is None:
        return topk_ops.knn_topk(queries, corpus, query_ids, ids, k=k, metric=metric)
    run_d = torch.full((queries.shape[0], k), float("inf"), device=dev)
    run_i = torch.full((queries.shape[0], k), -1, dtype=torch.int32, device=dev)
    for c0 in range(0, n_corpus, chunk):
        nd, ni = topk_ops.knn_topk(
            queries, corpus[c0:c0 + chunk], query_ids, ids[c0:c0 + chunk], k=k,
            metric=metric)
        run_d, run_i = topk_ops.merge_running_topk(run_d, run_i, nd, ni, k=k)
    return run_d, run_i


def self_join_brute(points: torch.Tensor, *, k: int, corpus_chunk: int = 4096,
                    metric: str = "l2"):
    """GPU-JOINLINEAR: the O(|D|²) self-join baseline."""
    ids = torch.arange(points.shape[0], dtype=torch.int32, device=points.device)
    return brute_knn(points, points, ids, k=k, corpus_chunk=corpus_chunk,
                     metric=metric)
