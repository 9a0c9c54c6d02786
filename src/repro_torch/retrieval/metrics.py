"""Metric registry: score spaces, row preparation and finalization (port of
``repro/retrieval/metrics.py``).

Three metrics, two kernel variants:

  * ``l2``     — raw score is squared L2; finalized to Euclidean distance
                 by √.
  * ``cosine`` — l2 over unit rows: for ‖q‖ = ‖c‖ = 1, d² = 2(1 − cos), a
                 monotone map, so the grid, SHORTC, the certificates and
                 every l2 engine apply unchanged.  Rows must be
                 pre-normalized (``normalize_rows``); finalized to the
                 cosine distance 1 − cos = d²/2.
  * ``ip``     — raw score is the negated inner product −q·c (ascending =
                 best first).  Scores may be negative: finalization is the
                 identity and nothing on the ip path clamps at 0.  Without a
                 projection front stage every ip query serves through the
                 brute lane (no triangle inequality bounds a grid search).

``finalize`` maps raw scores to reported distances once, at the index
boundary."""
from __future__ import annotations

import numpy as np

METRICS = ("l2", "ip", "cosine")

# Tolerance of the cosine unit-row contract: loose enough for float32
# embedding pipelines, tight enough that a raw row is always caught.
UNIT_ROW_ATOL = 1e-3


def validate_metric(metric: str, context: str = "") -> str:
    """``metric``, or a ValueError naming the accepted spellings."""
    if metric not in METRICS:
        where = f" ({context})" if context else ""
        raise ValueError(
            f"unknown metric {metric!r}{where}: expected one of {'|'.join(METRICS)}")
    return metric


def kernel_metric(metric: str) -> str:
    """The kernel-level variant: cosine rides the l2 kernels, only ip
    changes the kernel arithmetic."""
    return "ip" if metric == "ip" else "l2"


def normalize_rows(arr) -> np.ndarray:
    """L2-normalized float32 rows (zero rows stay zero) — the caller-side
    helper for building cosine indexes and queries."""
    a = np.asarray(arr, np.float32)
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.where(n > 0.0, n, 1.0)


def unit_rows_ok(arr) -> bool:
    """True iff every row has (approximately) unit L2 norm."""
    a = np.asarray(arr, np.float32)
    if a.size == 0:
        return True
    return bool(np.all(np.abs(np.linalg.norm(a, axis=-1) - 1.0) <= UNIT_ROW_ATOL))


def prepare_rows(arr, metric: str, what: str, context: str = "") -> np.ndarray:
    """Rows as float32 at an ingest boundary (build / query), checked
    against the metric contract: cosine rows that are not unit-normalized
    are an error, never silently normalized."""
    a = np.asarray(arr, np.float32)
    if metric == "cosine" and not unit_rows_ok(a):
        where = f" ({context})" if context else ""
        raise ValueError(
            f"{what} rows are not unit-normalized but the index metric is "
            f"'cosine'{where}: cosine indexes store and compare pre-normalized "
            "rows (d² = 2(1 − cos) only holds on the unit sphere) — pass them "
            "through repro_torch.retrieval.normalize_rows first")
    return a


def finalize(raw, metric: str):
    """Raw engine scores -> reported distances (ascending in both): l2 → √,
    cosine → d²/2, ip → identity (no clamp).  +inf padding passes through."""
    if metric == "ip":
        return raw
    if metric == "cosine":
        return np.maximum(raw, 0.0) / 2.0
    return np.sqrt(np.maximum(raw, 0.0))
