"""Score spaces, row preparation and finalization — the l2 part of
``repro/retrieval/metrics.py`` (ip and cosine come with queue A item 11).

The raw score of every engine is squared L2; ``finalize`` maps it to the
reported Euclidean distance, once, at the index boundary."""
from __future__ import annotations

import numpy as np

from repro_torch.utils import unported


def kernel_metric(metric: str) -> str:
    """The kernel-level distance variant for ``metric``."""
    if metric != "l2":
        raise unported(f"metric={metric!r}", "queue A item 11")
    return "l2"


def prepare_rows(arr, metric: str, what: str, context: str = "") -> np.ndarray:
    """Rows as float32 at an ingest boundary (build / query)."""
    kernel_metric(metric)
    return np.asarray(arr, np.float32)


def finalize(raw, metric: str):
    """Squared L2 -> Euclidean distance; +inf padding passes through."""
    kernel_metric(metric)
    return np.sqrt(np.maximum(raw, 0.0))
