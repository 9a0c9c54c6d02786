"""Retrieval helpers of the port: the metric registry and the projection
front stage's fitted map."""
from repro_torch.retrieval.metrics import (
    METRICS, finalize, kernel_metric, normalize_rows, prepare_rows, unit_rows_ok,
    validate_metric,
)
from repro_torch.retrieval.projection import Projection

__all__ = ["METRICS", "Projection", "finalize", "kernel_metric", "normalize_rows",
           "prepare_rows", "unit_rows_ok", "validate_metric"]
