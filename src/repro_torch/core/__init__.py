"""The hybrid KNN self-join (paper Algorithm 1), ported to PyTorch.

Public API: HybridConfig, HybridKNNJoin, JoinStats, KNNResult;
refimpl_knn (the REFIMPL baseline, §VI-C); brute_knn / self_join_brute
(the GPU-JOINLINEAR baseline); ring_self_join / hybrid_join_spmd (the
distributed joins) and collective_topk_merge / build_shard_indices /
merge_strategy (the sharded index's placement layer, DESIGN.md §5); the
work-queue scheduler (AsyncEngineCall, QueueReport, WorkQueue,
run_work_queue)."""
from repro_torch.core.hybrid import HybridConfig, HybridKNNJoin, JoinStats, KNNResult
from repro_torch.core.refimpl import refimpl_knn
from repro_torch.core.brute import brute_knn, self_join_brute
from repro_torch.core.distributed import (
    build_shard_indices, collective_topk_merge, hybrid_join_spmd, merge_strategy,
    ring_self_join,
)
from repro_torch.core.queue import AsyncEngineCall, QueueReport, WorkQueue, run_work_queue

__all__ = [
    "HybridConfig", "HybridKNNJoin", "JoinStats", "KNNResult",
    "refimpl_knn", "brute_knn", "self_join_brute",
    "ring_self_join", "hybrid_join_spmd",
    "build_shard_indices", "collective_topk_merge", "merge_strategy",
    "AsyncEngineCall", "QueueReport", "WorkQueue", "run_work_queue",
]
