"""Runtime of the port: the index/query serving API (mutable and durable)
and join sessions."""
from repro_torch.runtime.knn_index import (
    KNNIndex, clear_engine_cache, validate_k, validate_points,
)
from repro_torch.runtime.session import JoinSession

__all__ = ["KNNIndex", "JoinSession", "clear_engine_cache", "validate_k",
           "validate_points"]
