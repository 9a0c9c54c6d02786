"""HYBRIDKNN-JOIN — the paper's Algorithm 1, in PyTorch.

Port of ``repro/core/hybrid.py``: the configuration, statistics and result
dataclasses (same fields and defaults as the JAX package), and the thin
self-join wrapper ``HybridKNNJoin`` over ``runtime.session.JoinSession``.
Execution lives in ``repro_torch.runtime.knn_index.KNNIndex``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.retrieval.metrics import validate_metric
from repro_torch.utils import pow2_bucket

BACKENDS = ("ref", "pallas", "interpret", "fused", "auto")
DISTANCE_DTYPES = ("fp32", "bf16")


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """All paper parameters (Table II) plus execution knobs; see the JAX
    ``HybridConfig`` for each field's meaning.  ``backend`` "pallas" is the
    cell-tiled dense path (its ``pairwise_l2`` kernel on the card),
    "interpret" an alias of it for CPU tensors.  ``recall_target < 1``
    serves the calibrated approximate pass and ``projection_dim > 0`` the
    projection front stage (``retrieval/calibrate.py``,
    ``retrieval/projection.py``)."""

    k: int
    m: int = 6
    beta: float = 0.0
    gamma: float = 0.0
    rho: float = 0.0
    reorder: bool = True
    n_bins: int = 256
    n_query_sample: int = 256
    n_pair_sample: int = 4096
    dense_budget: int = 2048
    query_block: int = 128
    block_c: int = 128
    n_batches: int = 2
    online_rebalance: bool = True
    rebalance_sync_batches: int = 1
    n_levels: int = 6
    level_scale: float = 2.0
    sparse_budget: int = 512
    sel_factor: int = 4
    brute_chunk: int = 2048
    kernel_mode: str = "auto"
    backend: str = "auto"
    distance_dtype: str = "fp32"
    mutation_compact_frac: float = 0.25
    metric: str = "l2"
    recall_target: float = 1.0
    calib_queries: int = 128
    projection_dim: int = 0
    projection_kind: str = "pca"
    rescore_mult: int = 8
    seed: int = 0

    def __post_init__(self):
        assert 0.0 <= self.beta <= 1.0 and 0.0 <= self.gamma <= 1.0
        assert 0.0 <= self.rho <= 1.0 and self.k >= 1 and self.m >= 1
        assert self.n_batches >= 1 and self.rebalance_sync_batches >= 0
        assert self.mutation_compact_frac >= 0.0
        assert self.backend in BACKENDS, self.backend
        assert self.block_c >= 1
        if self.distance_dtype not in DISTANCE_DTYPES:
            raise ValueError(
                f"distance_dtype must be one of {DISTANCE_DTYPES}, "
                f"got {self.distance_dtype!r}")
        validate_metric(self.metric, "HybridConfig.metric")
        if not 0.0 < self.recall_target <= 1.0:
            raise ValueError(
                f"recall_target must be in (0, 1], got {self.recall_target}")
        if not 0 <= self.projection_dim <= 8:
            raise ValueError(
                f"projection_dim must be 0 (off) or 1..8, got {self.projection_dim}")
        if self.projection_kind not in ("pca", "random"):
            raise ValueError(
                f"projection_kind must be 'pca' or 'random', got {self.projection_kind!r}")
        assert self.rescore_mult >= 1 and self.calib_queries >= 1
        if self.kernel_mode != "auto":
            raise ValueError(
                "kernel_mode names a JAX execution mode; the port dispatches "
                f"kernels by the tensor's device, so it must be 'auto', got "
                f"{self.kernel_mode!r}")


@dataclasses.dataclass
class JoinStats:
    epsilon: float = 0.0
    epsilon_beta: float = 0.0
    n_dense: int = 0
    n_sparse: int = 0
    n_failed: int = 0
    n_uncertified: int = 0
    n_thresh: float = 0.0
    t_select_eps: float = 0.0
    t_build: float = 0.0
    t_dense: float = 0.0
    t_sparse: float = 0.0
    t_brute: float = 0.0
    t_merge: float = 0.0
    t_delta: float = 0.0
    t_wall: float = 0.0
    t1_per_query: float = 0.0
    t2_per_query: float = 0.0
    rho_model: float = 0.5
    n_batches: int = 0
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    t_dense_batches: List[float] = dataclasses.field(default_factory=list)
    n_rebalanced: int = 0
    n_sparse_rounds: int = 0
    n_sparse_engine_total: int = 0
    rho_online: float = 0.0
    n_engine_compiles: int = 0
    n_hedged: int = 0
    n_hedge_wins: int = 0
    n_subquery_retries: int = 0
    n_subquery_failures: int = 0
    shards_lost: Tuple[int, ...] = ()
    shards_skipped: Tuple[int, ...] = ()
    t_effective: float = 0.0

    @property
    def response_time(self) -> float:
        """Measured wall time of the query phase (engines overlap, so not
        the sum of per-engine times)."""
        if self.t_wall > 0.0:
            return self.t_wall
        return self.t_dense + self.t_sparse + self.t_brute


@dataclasses.dataclass
class KNNResult:
    dists: np.ndarray     # (|Q|, K) Euclidean distances, ascending
    ids: np.ndarray       # (|Q|, K) neighbor ids
    source: np.ndarray    # (|Q|,) 0=dense engine, 1=sparse engine, 2=brute lane
    stats: JoinStats
    coverage: Optional[np.ndarray] = None
    recall_estimate: float = 1.0

    @property
    def fully_covered(self) -> bool:
        return self.coverage is None or bool(self.coverage.all())


def _pad_ids(ids: np.ndarray, block: int, device) -> torch.Tensor:
    """Pad a query-id list to a pow2 multiple of ``block`` (bounds the
    number of distinct engine shapes across sweeps)."""
    out = np.full((pow2_bucket(len(ids), block),), -1, np.int32)
    out[: len(ids)] = ids
    return torch.as_tensor(out, device=device)


class HybridKNNJoin:
    """Reusable joiner: ``HybridKNNJoin(cfg, device=...).join(points)`` —
    ``KNNIndex.build(points, cfg).query(exclude_self=True)`` through a
    ``JoinSession`` so repeated joins reuse the built index."""

    def __init__(self, config: HybridConfig, *, device="cuda"):
        self.config = config
        from repro_torch.runtime.session import JoinSession

        self.session = JoinSession(config, device=device)

    def join(self, points, epsilon: Optional[float] = None) -> KNNResult:
        return self.session.join(points, epsilon)
