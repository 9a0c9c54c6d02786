"""Synthetic point-cloud generators mirroring the paper's four datasets
(a copy of ``repro/data/pointclouds.py``, which the port may not import).

The paper evaluates on SuSy (5M×18d), CHist (68k×32d), Songs (515k×90d),
FMA (107k×518d) from the UCI repository.  Offline we synthesize clouds
with the same *workload-shaping* properties the paper identifies —
dimensionality, size, and density skew (dense clusters + sparse
background, which is exactly what the β/γ/ρ split keys on).  Scale
factors shrink |D| so CPU benches finish; the relative comparisons
(hybrid vs refimpl vs brute) are preserved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class CloudSpec:
    name: str
    n_points: int
    n_dims: int
    n_clusters: int          # dense Gaussian clusters
    cluster_frac: float      # fraction of points inside clusters
    cluster_sigma: float
    intrinsic_dims: int      # dims carrying variance (rest near-constant —
                             # what REORDER exploits)


# Scaled-down analogues (same n, same density character, smaller |D|).
SPECS: Dict[str, CloudSpec] = {
    "susy": CloudSpec("susy", 20000, 18, 24, 0.75, 0.03, 18),
    "chist": CloudSpec("chist", 8000, 32, 12, 0.65, 0.04, 16),
    "songs": CloudSpec("songs", 12000, 90, 16, 0.55, 0.05, 30),
    "fma": CloudSpec("fma", 6000, 518, 8, 0.60, 0.05, 64),
}


def make_cloud(spec: CloudSpec, *, seed: int = 0,
               n_override: int | None = None) -> np.ndarray:
    """Dense clusters + uniform sparse background, low-variance tail dims."""
    rng = np.random.default_rng(seed)
    n = n_override or spec.n_points
    d = spec.n_dims
    n_cl = int(n * spec.cluster_frac)
    n_bg = n - n_cl

    centers = rng.uniform(0.15, 0.85, (spec.n_clusters, d))
    # Exponential cluster sizes — a few very dense cores (GPU-side work in
    # the paper), many small ones.
    sizes = rng.exponential(1.0, spec.n_clusters)
    sizes = np.maximum((sizes / sizes.sum() * n_cl).astype(int), 1)
    sizes[-1] += n_cl - sizes.sum()
    parts = [rng.normal(centers[i], spec.cluster_sigma, (s, d))
             for i, s in enumerate(sizes) if s > 0]
    background = rng.uniform(0.0, 1.0, (n_bg, d))
    pts = np.concatenate(parts + [background], axis=0)

    # Kill variance outside the intrinsic dims (REORDER's target property).
    if spec.intrinsic_dims < d:
        scale = np.ones(d)
        tail = rng.permutation(d)[spec.intrinsic_dims:]
        scale[tail] = 0.02
        pts = pts * scale
    rng.shuffle(pts)
    return pts.astype(np.float32)


def load(name: str, *, seed: int = 0, n_override: int | None = None) -> np.ndarray:
    return make_cloud(SPECS[name], seed=seed, n_override=n_override)
