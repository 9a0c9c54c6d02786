"""Retrieval helpers of the port: the metric registry."""
from repro_torch.retrieval.metrics import (
    METRICS, finalize, kernel_metric, normalize_rows, prepare_rows, unit_rows_ok,
    validate_metric,
)

__all__ = ["METRICS", "finalize", "kernel_metric", "normalize_rows", "prepare_rows",
           "unit_rows_ok", "validate_metric"]
