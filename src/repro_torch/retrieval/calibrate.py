"""Recall calibration (DESIGN.md §9.4): measure, don't guess — port of
``repro/retrieval/calibrate.py``.

``HybridConfig.recall_target`` is a measured contract: before the first
approximate query of a generation, a seeded held-out sample of corpus rows
is served both by an exact reference (the brute engine) and by each rung
of a tier ladder — cheapest first — and the first tier whose measured
recall@k meets the target wins.  The measurement rides on every result as
``KNNResult.recall_estimate``; when no tier qualifies, both paths fall
back to exact serving (estimate 1.0): the grid path re-enters the exact
pipeline, the projected path serves full-dimension brute.

Two ladders, one per approximate mechanism:

  * grid path  — ``GRID_EPS_TIERS``: the SHORTC ε shrinks (a runtime
    operand, so every rung reuses the exact path's engine buckets) and
    the failure-reassignment / brute backstops are dropped (the lean
    pass).
  * projected  — ``PROJ_CAND_TIERS``: candidate-pool multiples (×k) for
    the projected candidate stage, capped at ``rescore_mult``.

The sample (``_sample_rows``) is drawn with numpy's generator, as the
reference draws it, so both packages measure on the same rows.
Calibration is cached on the generation (``_Generation.calib``) per
(path, k, target): steady-state queries re-measure nothing and add no
engine bucket.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Lean-pass ε scales, cheapest first.  1.0 is still approximate (the
# backstops are off); exactness needs the fallback, not a rung.
GRID_EPS_TIERS = (0.5, 0.7, 0.85, 1.0)

# Projected candidate-pool multiples (×k), cheapest first.
PROJ_CAND_TIERS = (1, 2, 4, 8)


def recall_at_k(approx_ids: np.ndarray, exact_ids: np.ndarray,
                exclude: Optional[np.ndarray] = None) -> float:
    """Mean per-query overlap |approx ∩ exact| / |exact| over valid (≥ 0)
    ids — the standard recall@k, tolerant of short rows.

    ``exclude`` drops one id per row from both sides before comparing:
    calibration queries are corpus rows, so their own id is a guaranteed
    rank-0 hit for reference and candidate alike — counting it would
    inflate the estimate by ~(1−recall)/k."""
    approx_ids = np.asarray(approx_ids)
    exact_ids = np.asarray(exact_ids)
    hits = 0
    denom = 0
    for j, (row_a, row_e) in enumerate(zip(approx_ids, exact_ids)):
        a = set(row_a[row_a >= 0])
        e = set(row_e[row_e >= 0])
        if exclude is not None:
            a.discard(int(exclude[j]))
            e.discard(int(exclude[j]))
        hits += len(a & e)
        denom += len(e)
    return hits / max(1, denom)


def _sample_rows(n_base: int, cfg) -> np.ndarray:
    n_s = min(cfg.calib_queries, n_base)
    rng = np.random.default_rng(cfg.seed + 0x5EED)
    rows = rng.choice(n_base, size=n_s, replace=False)
    rows.sort()
    return rows


def grid_tier(index, gen, kq: int) -> Tuple[Optional[float], float]:
    """Calibrate the grid path's lean candidate stage: ``(eps_scale,
    measured_recall)`` for the cheapest qualifying tier, or ``(None, 1.0)``
    when none met the target (serve exact)."""
    from repro_torch.runtime import knn_index as ki

    cfg = index.config
    key = ("grid", kq, cfg.recall_target)
    hit = gen.calib.get(key)
    if hit is not None:
        return hit

    rows = _sample_rows(gen.n_base, cfg)
    n_s = len(rows)
    queries_r = gen.points_r[torch.as_tensor(rows, device=gen.points_r.device)]
    queries_rp = ki.pad_rows_pow2(queries_r, cfg.query_block).contiguous()
    # Exact reference through the brute engine.  exclude_self is off on
    # both sides: the sampled row is a legitimate rank-0 hit for reference
    # and candidate alike, so the overlap is like-for-like.
    _, ref_i = index._brute_fn(gen, kq, queries_rp, False)(np.arange(n_s, dtype=np.int32))
    dense_ids, sparse_ids, _, _ = index._query_split(gen, queries_r, kq)

    out: Tuple[Optional[float], float] = (None, 1.0)
    for scale in GRID_EPS_TIERS:
        _, ids, _, _ = index._lean_pass(
            gen, kq, n_s, queries_rp, dense_ids, sparse_ids, False, scale)
        r = recall_at_k(ids, ref_i, exclude=rows)
        if r >= cfg.recall_target:
            out = (scale, r)
            break
    gen.calib[key] = out
    return out


def projected_tier(index, gen, kq: int) -> Tuple[Optional[int], float]:
    """Calibrate the projection front stage's candidate-pool size:
    ``(cand_mult, measured_recall)`` — the cheapest qualifying rung of
    ``PROJ_CAND_TIERS`` (capped at ``rescore_mult``) — or ``(None, 1.0)``
    when no rung met the target on the held-out sample (serve exact
    full-dimension brute)."""
    from repro_torch.runtime import knn_index as ki

    cfg = index.config
    key = ("proj", kq, cfg.recall_target)
    hit = gen.calib.get(key)
    if hit is not None:
        return hit

    rows = _sample_rows(gen.n_base, cfg)
    n_s = len(rows)
    dev = gen.points_full.device
    q_full = gen.points_full[torch.as_tensor(rows, device=dev)]
    qfp = ki.pad_rows_pow2(q_full, cfg.query_block).contiguous()
    # Exact full-dimension reference: the brute engine over the full corpus
    # in the true metric (a distinct bucket from the grid-space brute).
    # The same engine serves the exact fallback when no rung qualifies.
    _, ref_i = index._full_brute_fn(gen, kq, qfp, False)(np.arange(n_s, dtype=np.int32))

    qproj = gen.projection.apply(q_full.cpu().numpy())
    qproj_rp = ki.pad_rows_pow2(torch.as_tensor(qproj, device=dev),
                                cfg.query_block).contiguous()
    if cfg.recall_target >= 1.0:
        mults = [cfg.rescore_mult]      # measurement-only pass
    else:
        mults = sorted({min(m, cfg.rescore_mult) for m in PROJ_CAND_TIERS}
                       | {cfg.rescore_mult})
    out: Tuple[Optional[int], float] = (None, 1.0)
    for cm in mults:
        k_cand = max(kq, min(cm * kq, gen.n_base))
        _, ids, *_ = index._projected_pass(gen, kq, k_cand, n_s, qproj_rp, q_full, False)
        r = recall_at_k(ids, ref_i, exclude=rows)
        if r >= cfg.recall_target:
            out = (cm, r)
            break
    gen.calib[key] = out
    return out
