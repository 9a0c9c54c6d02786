"""Projection front stage: route d ≫ 8 corpora through the low-dim grid —
a copy of ``repro/retrieval/projection.py`` (numpy only, as there).

The paper's machinery (ε-grid, pyramid, SHORTC) is built for m ≤ 8
indexed dims; embedding workloads arrive at d = 64..4096.  The bridge is
the coarse-filter-then-exact-rescore split: fit a linear map to ``m ≤ 8``
dims once at build time, run the whole grid/engine pipeline in projected
space to produce a candidate pool, then rescore the surviving candidates
with exact full-dimension scores in the index's true metric
(``KNNIndex``'s ``"rescore"`` engine).

Two fits, both deterministic under ``HybridConfig.seed``:

  * ``pca``    — top-m principal directions of a (seeded, capped) corpus
                 sample: the projection that preserves the most L2
                 structure per dim.
  * ``random`` — seeded Gaussian map scaled 1/√m (Johnson-Lindenstrauss):
                 no fit pass over the data, distances preserved in
                 expectation.

The fit and ``apply`` stay numpy on the host, so the fitted map and the
projected corpus are bit-identical to the JAX package's; the card receives
the projected rows.  The fitted map is generation state:
``KNNIndex.save()`` persists ``matrix``/``mean`` and ``load()`` replays
them bit-identically (a re-fit could differ across BLAS builds).
"""
from __future__ import annotations

import dataclasses

import numpy as np

PROJECTION_KINDS = ("pca", "random")

# PCA fit-sample cap: the covariance of a seeded 4k-row sample is
# plenty to rank principal directions for a coarse filter, and keeps
# build-time SVD cost independent of corpus size.
_PCA_FIT_SAMPLE = 4096


@dataclasses.dataclass(frozen=True)
class Projection:
    """A fitted linear map ``rows -> (rows - mean) @ matrix``.

    ``mips_m > 0`` marks an inner-product (MIPS) fit: the map was fit
    over the standard MIPS→L2 augmentation (Bachrach et al.) — corpus
    rows carry an extra coordinate √(M² − ‖c‖²) with M the max corpus
    norm, queries carry 0 there — under which squared L2 is
    ‖q‖² + M² − 2⟨q,c⟩, monotone in the inner product for any fixed
    query.  Projected-L2 candidate ranking then tracks ip ranking the
    way it tracks L2 ranking for an l2 index; without the augmentation
    the two geometries are unrelated and the front stage's recall
    collapses.  ``apply`` performs the matching augmentation, so
    callers always pass raw d-dim rows."""

    kind: str             # "pca" | "random"
    matrix: np.ndarray    # (d, m) f32 — (d+1, m) for a MIPS fit
    mean: np.ndarray      # f32, matrix.shape[0] entries — zeros for the
                          # random map
    mips_m: float = 0.0   # max corpus norm of the MIPS fit; 0 = plain

    @property
    def in_dim(self) -> int:
        """Dim of the RAW rows ``apply`` accepts (the augmentation
        coordinate is internal)."""
        return int(self.matrix.shape[0]) - (1 if self.mips_m > 0 else 0)

    @property
    def out_dim(self) -> int:
        return int(self.matrix.shape[1])

    def _augment(self, a: np.ndarray, corpus: bool) -> np.ndarray:
        extra = np.zeros((a.shape[0], 1), np.float32)
        if corpus:
            gap = self.mips_m ** 2 - np.sum(a.astype(np.float64) ** 2,
                                            axis=1)
            extra = np.sqrt(np.maximum(gap, 0.0))[:, None].astype(
                np.float32)
        return np.concatenate([a, extra], axis=1)

    def apply(self, rows: np.ndarray, *, corpus: bool = False) -> np.ndarray:
        """(N, d) raw rows -> (N, m) float32 projected rows.  For a
        MIPS fit, ``corpus=True`` selects the corpus-side augmentation
        (√(M² − ‖·‖²)) and the default the query side (0)."""
        a = np.asarray(rows, np.float32)
        if a.ndim != 2 or a.shape[1] != self.in_dim:
            raise ValueError(
                f"projection expects (N, {self.in_dim}) rows, got array "
                f"of shape {a.shape}"
            )
        if self.mips_m > 0:
            a = self._augment(a, corpus)
        return (a - self.mean[None, :]) @ self.matrix


def fit_projection(points: np.ndarray, m: int, kind: str = "pca",
                   seed: int = 0, mips: bool = False) -> Projection:
    """Fit a (d -> m) projection over the corpus (deterministic in
    ``seed``).  ``m`` must be strictly below d — projecting to ≥ d dims
    is a configuration error, not a no-op.  ``mips=True`` fits over the
    MIPS→L2 augmented corpus (see ``Projection``) so the projected
    front stage serves inner-product indexes."""
    pts = np.asarray(points, np.float32)
    n, d = pts.shape
    if kind not in PROJECTION_KINDS:
        raise ValueError(
            f"unknown projection kind {kind!r}: expected one of "
            f"{'|'.join(PROJECTION_KINDS)}"
        )
    if not 1 <= m < d:
        raise ValueError(
            f"projection_dim must satisfy 1 <= m < corpus dim "
            f"({d}), got {m}"
        )
    mips_m = 0.0
    if mips:
        mips_m = float(np.sqrt(np.sum(
            pts.astype(np.float64) ** 2, axis=1).max()))
        stub = Projection(kind=kind, matrix=np.zeros((d + 1, m)),
                          mean=np.zeros((d,)), mips_m=mips_m)
        pts = stub._augment(pts, corpus=True)
        d += 1
    rng = np.random.default_rng(seed)
    if kind == "random":
        mat = rng.standard_normal((d, m)).astype(np.float32) / np.sqrt(m)
        return Projection(kind=kind, matrix=mat,
                          mean=np.zeros((d,), np.float32), mips_m=mips_m)
    # PCA on a seeded sample: mean-center, top-m right singular vectors.
    if n > _PCA_FIT_SAMPLE:
        sample = pts[rng.choice(n, _PCA_FIT_SAMPLE, replace=False)]
    else:
        sample = pts
    mean = sample.mean(axis=0).astype(np.float32)
    _, _, vt = np.linalg.svd(sample - mean[None, :], full_matrices=False)
    # Sign-canonicalize each direction (largest-|coeff| entry positive)
    # so the fit is reproducible across LAPACK builds.
    comps = vt[:m]
    flips = np.sign(comps[np.arange(m), np.argmax(np.abs(comps), axis=1)])
    comps = comps * np.where(flips == 0.0, 1.0, flips)[:, None]
    return Projection(kind=kind, matrix=comps.T.astype(np.float32),
                      mean=mean, mips_m=mips_m)
