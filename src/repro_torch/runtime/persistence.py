"""Index generations on disk: ``KNNIndex.save()`` / ``KNNIndex.load()`` —
port of ``repro/runtime/persistence.py``, with the same keys and ``extra``
fields, so a generation saved by either package loads into the other.

A generation on disk (DESIGN.md §7) is the minimal state from which the
index is rebuilt deterministically and answers bit-identically:

    points_ref     the corpus as given to build(), original dim order
    points_r       the REORDERed corpus (the permutation applied)
    dim_perm       the REORDER permutation itself (absent if reorder off)
    delta_points / delta_live / base_tombs
                   the pending MutationState, so a dirty index restores
                   dirty (same answers, same later compaction)
    proj_matrix / proj_mean
                   a projected generation's fitted map (``points_r`` then
                   holds the projected corpus), with ``projection_kind``
                   and ``projection_mips_m`` in ``extra``
    extra          config (HybridConfig asdict), ε, ε_β, the original ε
                   *argument* (replayed by compact()), generation number

Grid, pyramid and the shard partition are not stored: they are
deterministic functions of ``(points_r, ε, config)``, rebuilt by the same
code at load — which is what lets a generation saved from one device load
onto a 2 × 2 mesh, or the reverse.  What load
never redoes is the sampled or order-sensitive work: REORDER's variance
sort, the ε selection and the projection's fit are replayed from the
stored permutation, scalar and map (``KNNIndex.build``'s ``_prebuilt``).

Storage goes through ``checkpoint.CheckpointManager`` — atomic tmp+rename
step directories, crc-validated manifest, LATEST pointer with a durable
fallback.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np

import repro_torch.core.hybrid as hybrid_lib
from repro_torch.checkpoint import CheckpointManager
from repro_torch.retrieval.projection import Projection
from repro_torch.runtime import mutation as mut_lib

FORMAT = "knn-index-generation-v1"


def _manager(directory: str, manager) -> CheckpointManager:
    if manager is not None:
        return manager
    # Sync writes: save() returning means the generation is durable.
    return CheckpointManager(directory, async_save=False)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def save_index(index, directory: str, *, manager=None) -> int:
    """Write the index's live generation as the next checkpoint step;
    returns the step number."""
    mgr = _manager(directory, manager)
    gen, mut = index._live
    tree = {
        "points_ref": np.asarray(gen.points_ref, np.float32),
        "points_r": _host(gen.points_r).astype(np.float32),
        "delta_points": np.asarray(mut.delta_points, np.float32),
        "delta_live": np.asarray(mut.delta_live, bool),
        "base_tombs": np.asarray(mut.base_tombs, np.int32),
    }
    if gen.dim_perm is not None:
        tree["dim_perm"] = _host(gen.dim_perm).astype(np.int32)
    # A sharded generation stores the same global state (placement is a
    # load-time choice) and never has a projection.
    projection = getattr(gen, "projection", None)
    if projection is not None:
        # Replayed verbatim at load: a re-fit could differ across BLAS
        # builds and change which candidates the front stage surfaces.
        tree["proj_matrix"] = np.asarray(projection.matrix, np.float32)
        tree["proj_mean"] = np.asarray(projection.mean, np.float32)
    extra = {
        "format": FORMAT,
        "config": dataclasses.asdict(index.config),
        "eps": float(gen.eps),
        "eps_beta": float(gen.eps_beta),
        "epsilon_arg": (None if index._epsilon_arg is None else float(index._epsilon_arg)),
        "generation": int(index.generation),
    }
    if projection is not None:
        extra["projection_kind"] = projection.kind
        extra["projection_mips_m"] = float(projection.mips_m)
    latest = mgr.latest_step()
    step = 0 if latest is None else latest + 1
    mgr.save(step, tree, extra=extra)
    mgr.wait()
    return step


def load_index(directory: str, *, step: Optional[int] = None, device="cuda",
               backend: Optional[str] = None,
               compile_counts: Optional[Dict[str, int]] = None, mesh=None,
               mesh_axis=None, merge: str = "auto"):
    """Rebuild a served index from a saved generation on ``device``, or
    onto ``mesh`` (routed like ``KNNIndex.build``).  On the saver's
    placement it answers bit-identically to the index that called
    ``save``; another mesh shape re-partitions the same global generation
    along the same cell order and answers the same up to the order of
    equal-distance ties (a shard may certify a row in another engine)."""
    from repro_torch.runtime.knn_index import KNNIndex

    mgr = _manager(directory, None)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no durable index generation in {directory}")
    # Template keys come from the manifest: the tree is a flat dict.
    with open(os.path.join(directory, f"step-{step:09d}", "manifest.json")) as f:
        keys = list(json.load(f)["index"].keys())
    tree, extra, step = mgr.restore({k: 0 for k in keys}, step=step)
    if extra.get("format") != FORMAT:
        raise ValueError(
            f"checkpoint at {directory} step {step} is not an index "
            f"generation (format={extra.get('format')!r}; expected "
            f"{FORMAT!r} — training checkpoints do not load as indexes)")
    cfg = hybrid_lib.HybridConfig(**extra["config"])
    prebuilt = (tree["points_r"], tree.get("dim_perm"), float(extra["eps"]),
                float(extra["eps_beta"]))
    if "proj_matrix" in tree:
        prebuilt = prebuilt + (Projection(
            kind=extra.get("projection_kind", cfg.projection_kind),
            matrix=np.asarray(tree["proj_matrix"], np.float32),
            mean=np.asarray(tree["proj_mean"], np.float32),
            mips_m=float(extra.get("projection_mips_m", 0.0))),)
    index = KNNIndex.build(tree["points_ref"], cfg, extra["epsilon_arg"], device=device,
                           backend=backend, compile_counts=compile_counts, mesh=mesh,
                           mesh_axis=mesh_axis, merge=merge, _prebuilt=prebuilt)
    index.generation = int(extra["generation"])
    mut = mut_lib.MutationState(
        delta_points=np.asarray(tree["delta_points"], np.float32),
        delta_live=np.asarray(tree["delta_live"], bool),
        base_tombs=np.asarray(tree["base_tombs"], np.int32))
    if not mut.is_clean:
        index._live = (index._live[0], mut)
    return index
