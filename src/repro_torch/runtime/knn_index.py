"""Index/query serving API: build once, query many — in PyTorch.

Port of ``repro/runtime/knn_index.py`` for one device and exact results in
the l2, ip or cosine metric:

  * ``KNNIndex.build(points, config, device=...)`` runs the per-database
    steps once — REORDER by variance (§IV-D), ε selection (§V-C, the
    ``bin_hist`` kernel), ε-grid + pyramid construction;
  * ``index.query(queries, k=None, exclude_self=False)`` runs the hybrid
    dense/sparse/brute pipeline through the §V-A work queue for an
    arbitrary (R≠S) query set; ``index.query(exclude_self=True)`` is the
    classic self-join;
  * ``insert`` / ``delete`` absorb corpus changes into a delta buffer and
    tombstones that queries fold in exactly (``runtime/mutation.py``),
    ``compact()`` rebuilds a fresh generation, and ``save`` / ``load``
    write and replay a generation (``runtime/persistence.py``).

Metrics (``retrieval/metrics.py``): cosine runs the l2 engines over unit
rows; an un-projected ip index serves every query through the exact brute
lane (ip has no triangle inequality to bound a grid search); raw scores
become reported distances once, in ``finalize``, at this boundary.

Approximate paths (DESIGN.md §9.3–9.4): ``recall_target < 1`` serves the
calibrated lean pass of the grid engines (``_query_approx``), and
``projection_dim > 0`` runs the exact pipeline over a fitted ≤ 8-dim
projection of the corpus for a candidate pool that the ``"rescore"``
engine reduces in the full dimension and the true metric
(``_query_projected``); ``retrieval/calibrate.py`` measures either against
exact answers on a held-out sample of corpus rows.

Engine "compiles": the JAX package caches AOT executables per shape
bucket.  PyTorch runs eagerly and the CUDA sources build once per
process, so the port keeps only the bookkeeping — a process-global set of
(engine, argument shapes, static parameters) keys with the same pow2
query buckets — so ``compile_counts`` and ``JoinStats.n_engine_compiles``
keep their meaning: a steady-state query in a seen bucket counts zero.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

import repro_torch.core.hybrid as hybrid_lib
from repro_torch.core import brute as brute_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import epsilon as eps_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import queue as queue_lib
from repro_torch.core import sparse_knn as sparse_lib
from repro_torch.core import splitter as split_lib
from repro_torch.retrieval import calibrate as cal_lib
from repro_torch.retrieval import metrics as met_lib
from repro_torch.retrieval import projection as proj_lib
from repro_torch.runtime import mutation as mut_lib
from repro_torch.launch.mesh import check_mesh
from repro_torch.utils import pad_to, pow2_bucket, resolve_device

# Process-global engine shape-bucket keys (the JAX AOT cache's keys).
_ENGINE_CACHE: set = set()

# Bytes of gathered candidate rows the rescore engine holds at once: the
# reference gathers every (query, candidate, dim) at once, 21.7 GB for an
# FMA self-join at K = 10 and rescore_mult 8; here query rows go in chunks.
RESCORE_CHUNK_BYTES = 1 << 28


def clear_engine_cache() -> None:
    """Forget every seen engine shape bucket (tests)."""
    _ENGINE_CACHE.clear()


def _aval(x):
    """Shape/type signature of one engine argument."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, grid_lib.GridIndex):
        return ("grid", x.m, x.n_points, tuple(
            _aval(getattr(x, f.name)) for f in dataclasses.fields(x)
            if f.name not in ("m", "n_points")))
    if isinstance(x, sparse_lib.Pyramid):
        return ("pyramid", tuple(_aval(g) for g in x.levels), _aval(x.cert_radii))
    return type(x).__name__


def run_engine(owner, kind: str, args: tuple, kwargs: dict) -> None:
    """Charge a first-seen (engine, shapes, parameters) bucket to
    ``owner.compile_counts[kind]``."""
    key = (kind, tuple(_aval(a) for a in args), tuple(sorted(kwargs.items())))
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE.add(key)
        owner.compile_counts[kind] = owner.compile_counts.get(kind, 0) + 1


def validate_points(arr, n_dims: Optional[int], what: str = "queries"):
    """Reject dtype/shape mismatches with an actionable ``ValueError``
    before anything reaches the engines."""
    try:
        a = np.asarray(arr)
    except Exception as e:
        raise ValueError(f"{what} must be an array-like of numbers "
                         f"({type(arr).__name__} is not)") from e
    if a.dtype.kind not in "iuf":
        raise ValueError(
            f"{what} must have a real numeric dtype (int or float), got "
            f"{a.dtype} — the index stores float32 coordinates")
    if a.ndim != 2:
        raise ValueError(
            f"{what} must be a 2-D (rows, dims) array, got shape {a.shape}")
    if n_dims is not None and a.shape[1] != n_dims:
        raise ValueError(
            f"{what} have {a.shape[1]} dims but the index was built over "
            f"{n_dims}-dim points — shape must be (rows, {n_dims})")
    return a


def validate_k(k, available: int, *, what: str = "k", context: str = "") -> int:
    """Reject non-int / non-positive / too-large ``k``."""
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)):
        raise ValueError(f"{what} must be an int, got {type(k).__name__} ({k!r})")
    k = int(k)
    if k < 1:
        raise ValueError(f"{what} must be >= 1, got {k}")
    if k > available:
        raise ValueError(
            f"{what}={k} exceeds the {available} reference points "
            f"available{context}")
    return k


def pad_rows_pow2(arr: torch.Tensor, block: int) -> torch.Tensor:
    """Pad the leading axis to a pow2 multiple of ``block`` (zero fill) —
    the query-shape bucket, rounded like ``hybrid._pad_ids``."""
    return pad_to(arr, pow2_bucket(arr.shape[0], block))


def select_epsilon(points_r: torch.Tensor, cfg, epsilon, npts: int):
    """Step 2 of Algorithm 1: ``(eps, eps_beta, t_select)``, skipping the
    sampling sweep when the caller pins ``epsilon``."""
    t0 = time.perf_counter()
    if epsilon is None:
        sel = eps_lib.select_epsilon(
            points_r, cfg.seed, cfg.k, cfg.beta,
            n_query_sample=min(cfg.n_query_sample, npts),
            n_bins=cfg.n_bins, n_pair_sample=cfg.n_pair_sample,
        )
        eps, eps_beta = float(sel.epsilon), float(sel.epsilon_beta)
    else:
        eps, eps_beta = float(epsilon), float(epsilon) / 2.0
    return eps, eps_beta, time.perf_counter() - t0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def rescore_topk(points_full: torch.Tensor, queries_f: torch.Tensor,
                 cand_ids: torch.Tensor, excl: torch.Tensor, *, k: int, metric: str,
                 chunk_bytes: int = RESCORE_CHUNK_BYTES):
    """Full-dimension exact rescore of the projection front stage's
    candidate pools (engine kind ``"rescore"``, the reference's
    ``_rescore_engine``): gather each query's candidate rows, score them in
    the true kernel metric (squared L2 in the difference form, or −q·c),
    and keep the k best.  Invalid candidates (id −1) and the query's
    excluded id score +inf and come back as −1.  Among equal scores the
    lower pool position comes first, as ``lax.top_k`` orders them.  Query
    rows go in chunks of at most ``chunk_bytes`` of gathered rows; a row's
    result does not depend on the chunk."""
    n_q, n_cand = cand_ids.shape
    rows = max(1, chunk_bytes // max(1, n_cand * points_full.shape[1] * 4))
    out_d, out_i = [], []
    for r0 in range(0, n_q, rows):
        ci = cand_ids[r0:r0 + rows]
        q = queries_f[r0:r0 + rows, None, :]
        c = points_full[ci.clamp(min=0).long()]                 # (rows, n_cand, d)
        if metric == "ip":
            score = c.mul_(q).sum(-1).neg_()
        else:
            score = c.sub_(q).square_().sum(-1)
        valid = (ci >= 0) & (ci != excl[r0:r0 + rows, None])
        score = torch.where(valid, score, torch.full_like(score, float("inf")))
        vals, pos = torch.sort(score, dim=1, stable=True)
        kd = vals[:, :k]
        out_d.append(kd)
        out_i.append(torch.where(torch.isinf(kd), torch.full_like(ci[:, :k], -1),
                                 ci.gather(1, pos[:, :k])))
    return torch.cat(out_d), torch.cat(out_i)


@dataclasses.dataclass
class _Generation:
    """One immutable built snapshot of the reference cloud — everything
    ``query`` reads that ``compact()`` replaces.  The index holds
    ``self._live = (generation, mutations)`` and swaps that one reference
    atomically, so an in-flight query (which snapshots the pair once at
    entry) is unharmed by a concurrent compaction."""

    points_ref: object
    points_r: torch.Tensor
    dim_perm: Optional[torch.Tensor]
    eps: float
    eps_beta: float
    grid: grid_lib.GridIndex
    pyramid: sparse_lib.Pyramid
    home_counts: np.ndarray                 # (|D|,) self-cloud densities
    # Projection front stage: when set, ``points_r``, the grid and the
    # pyramid live in the projected (≤ 8-dim) space and ``points_full``
    # holds the full-dimension corpus the rescore engine reads.
    projection: Optional[proj_lib.Projection] = None
    points_full: Optional[torch.Tensor] = None
    # Self-split cache per (k, ρ): (dense_ids, sparse_ids, threshold).
    self_splits: Dict[Tuple[int, float], Tuple[np.ndarray, np.ndarray, float]] = (
        dataclasses.field(default_factory=dict))
    # Calibration cache: (path, k, target) -> (tier, recall_estimate),
    # measured once per generation on a held-out corpus sample.
    calib: Dict[tuple, Tuple[Optional[float], float]] = dataclasses.field(
        default_factory=dict)

    @property
    def n_base(self) -> int:
        return int(self.points_r.shape[0])

    def points_np(self) -> np.ndarray:
        """The base cloud in original dim order as float32 numpy."""
        p = self.points_ref
        return np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p, np.float32)

    def dim_perm_np(self) -> Optional[np.ndarray]:
        return None if self.dim_perm is None else self.dim_perm.cpu().numpy()

    @property
    def n_dims(self) -> int:
        """Query-facing width: the full corpus width, also on a projected
        generation."""
        if self.projection is not None:
            return self.projection.in_dim
        return int(self.points_r.shape[1])


class KNNIndex:
    """A built reference cloud plus everything needed to serve queries.

    >>> index = KNNIndex.build(db_points, HybridConfig(k=10), device="cuda")
    >>> r = index.query(batch)                     # R≠S join, k=10
    >>> r = index.query(exclude_self=True)         # the classic self-join

    The index is mutable (DESIGN.md §6): ``insert(points)`` /
    ``delete(ids)`` absorb corpus changes that queries fold in exactly,
    and ``compact()`` rebuilds into a fresh generation (auto-triggered when
    either side outgrows ``config.mutation_compact_frac``·|D|).  Global
    ids: build row i is id i; the j-th insert since the last compaction is
    ``n_base + j``; compaction renumbers (it returns the remap).
    """

    def __init__(self, config, *, backend: str, device: torch.device,
                 generation: _Generation, t_select_eps: float = 0.0,
                 t_build: float = 0.0, t_project: float = 0.0,
                 compile_counts: Optional[Dict[str, int]] = None,
                 epsilon_arg: Optional[float] = None):
        self.config = config
        self.backend = backend
        self.device = device
        # The atomic (generation, mutations) pair; delta rows arrive in the
        # corpus' original dim order.
        self._live: Tuple[_Generation, mut_lib.MutationState] = (
            generation, mut_lib.MutationState.empty(generation.n_dims))
        self.generation = 0
        # The ε argument build() was given (None = re-select), replayed by
        # compact() so a rebuilt generation is bit-identical to
        # KNNIndex.build(net_corpus, config, epsilon_arg).
        self._epsilon_arg = epsilon_arg
        self.t_select_eps = t_select_eps
        self.t_build = t_build
        # Seconds of the projection's fit and of projecting the corpus (0 on
        # a direct index or a load, which replays the saved map).
        self.t_project = t_project
        self.compile_counts = (
            compile_counts if compile_counts is not None
            else {"dense": 0, "sparse": 0, "brute": 0})

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, points, config, epsilon: Optional[float] = None, *,
              device="cuda", backend: Optional[str] = None,
              compile_counts: Optional[Dict[str, int]] = None, mesh=None,
              mesh_axis=None, merge: str = "auto", _prebuilt: Optional[tuple] = None):
        """Steps 1–3 of Algorithm 1, once per database: REORDER, ε
        selection (skipped when ``epsilon`` is pinned), grid + pyramid.
        Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU;
        a missing card raises).  With ``projection_dim > 0`` the projection
        is fitted and applied on the host (numpy, as the reference does)
        and REORDER is skipped: the grid indexes the projected rows, and
        the full-width corpus stays on the device for the rescore.

        ``mesh`` (a ``launch.mesh.Mesh``) makes placement a build parameter
        (DESIGN.md §5): the reference cloud is partitioned over the mesh's
        shard slots and a ``ShardedKNNIndex`` is returned — the same
        ``query()`` contract, shard-local pipelines plus a collective top-K
        merge (``mesh_axis`` names the shard axis or axes, default every
        axis but ``"replica"``; ``merge`` picks the collective strategy,
        ``core.distributed.merge_strategy``).  The mesh's slots decide the
        devices; ``device`` is not used then.

        ``_prebuilt`` is internal (``load``): a ``(points_r, dim_perm, eps,
        eps_beta[, projection])`` tuple replaying a saved generation's
        REORDER, ε and fitted projection verbatim, so a load never
        recomputes any of them."""
        if mesh is not None:
            if config.projection_dim > 0:
                raise ValueError(
                    "projection_dim > 0 is single-device in this release — the "
                    "projection front stage and the sharded cell-order partition "
                    "do not compose yet.  Build without a mesh, or drop the "
                    "projection.")
            from repro_torch.runtime.sharded_index import ShardedKNNIndex

            return ShardedKNNIndex.build(
                points, config, epsilon, mesh=check_mesh(mesh), mesh_axis=mesh_axis,
                merge=merge, backend=backend, compile_counts=compile_counts,
                _prebuilt=_prebuilt)
        dev = resolve_device(device)
        cfg = config
        pts_np = met_lib.prepare_rows(
            validate_points(points, None, what="indexed points"),
            cfg.metric, "indexed points", context="KNNIndex.build")
        npts, ndim = pts_np.shape
        validate_k(cfg.k, npts - 1, what="config.k",
                   context=" (build needs k < |D|)")

        projection = None
        t_project = 0.0
        if _prebuilt is not None:
            points_r, dim_perm, eps, eps_beta = _prebuilt[:4]
            if len(_prebuilt) > 4:
                projection = _prebuilt[4]
            points_r = torch.as_tensor(np.asarray(points_r, np.float32), device=dev)
            if dim_perm is not None:
                dim_perm = torch.as_tensor(np.asarray(dim_perm), device=dev).long()
            t_select = 0.0
        else:
            if cfg.projection_dim > 0:
                # An ip index fits over the MIPS→L2 augmented corpus, so
                # projected-l2 ranking tracks inner-product ranking.
                t0 = time.perf_counter()
                projection = proj_lib.fit_projection(
                    pts_np, cfg.projection_dim, kind=cfg.projection_kind,
                    seed=cfg.seed, mips=(cfg.metric == "ip"))
                points_r = torch.as_tensor(projection.apply(pts_np, corpus=True),
                                           device=dev)
                dim_perm = None
                t_project = time.perf_counter() - t0
            elif cfg.reorder:
                points_r, dim_perm = grid_lib.reorder_by_variance(
                    torch.as_tensor(pts_np, device=dev))
                points_r = points_r.contiguous()
            else:
                points_r, dim_perm = torch.as_tensor(pts_np, device=dev), None
            eps, eps_beta, t_select = select_epsilon(points_r, cfg, epsilon, npts)
        points_full = None if projection is None else torch.as_tensor(pts_np, device=dev)
        m = min(cfg.m, int(points_r.shape[1]))

        t0 = time.perf_counter()
        eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
        grid = grid_lib.build_grid(points_r, eps_t, m)
        pyramid = sparse_lib.build_pyramid(
            points_r, eps_t, m, n_levels=cfg.n_levels, level_scale=cfg.level_scale)
        _sync(dev)
        t_build = time.perf_counter() - t0

        home_counts = grid.cell_counts[grid.point_cell_pos.long()].cpu().numpy()
        gen = _Generation(points_ref=points, points_r=points_r, dim_perm=dim_perm,
                          eps=eps, eps_beta=eps_beta, grid=grid, pyramid=pyramid,
                          home_counts=home_counts, projection=projection,
                          points_full=points_full)
        return cls(cfg,
                   backend=dense_lib.resolve_backend(
                       backend if backend is not None else cfg.backend, dev),
                   device=dev, generation=gen, t_select_eps=t_select,
                   t_build=t_build, t_project=t_project,
                   compile_counts=compile_counts, epsilon_arg=epsilon)


    # -- introspection -----------------------------------------------------
    # Generation-owned state reads the LIVE generation, so it moves when
    # compact() swaps it.

    @property
    def points(self):
        """The live generation's base cloud in original dim order (the array
        passed to ``build``, or the net corpus of the last compaction); with
        mutations pending, prefer ``net_points()``."""
        return self._live[0].points_ref

    @property
    def points_r(self):
        return self._live[0].points_r

    @property
    def dim_perm(self):
        return self._live[0].dim_perm

    @property
    def eps(self) -> float:
        return self._live[0].eps

    @property
    def eps_beta(self) -> float:
        return self._live[0].eps_beta

    @property
    def grid(self):
        return self._live[0].grid

    @property
    def pyramid(self):
        return self._live[0].pyramid

    @property
    def home_counts(self):
        return self._live[0].home_counts

    @property
    def n_dims(self) -> int:
        """Query-facing width: what ``query`` / ``insert`` rows must have —
        the full corpus width even when the grid lives in projected space."""
        return self._live[0].n_dims

    @property
    def projection(self) -> Optional[proj_lib.Projection]:
        """The live generation's fitted projection (None on a direct index)."""
        return self._live[0].projection

    @property
    def n_base(self) -> int:
        """Base-corpus size of the live generation (grid/pyramid rows)."""
        return self._live[0].n_base

    @property
    def n_points(self) -> int:
        """Live corpus size: |base| − tombstones + live delta rows."""
        gen, mut = self._live
        return mut.n_live(gen.n_base)

    @property
    def n_delta(self) -> int:
        """Live (non-tombstoned) delta-buffer rows."""
        return self._live[1].n_delta_live

    @property
    def n_tombstones(self) -> int:
        """Tombstoned base rows."""
        return self._live[1].n_base_tombs

    @property
    def is_clean(self) -> bool:
        """True iff no mutations are pending against the live generation —
        queries take the unmodified path."""
        return self._live[1].is_clean

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    # -- persistence (DESIGN.md §7) ----------------------------------------

    def save(self, directory: str, *, manager=None) -> int:
        """Checkpoint the live generation (points, REORDER permutation, ε,
        mutation state) as the next step of ``directory``; returns the step
        written.  ``KNNIndex.load`` answers bit-identically."""
        from repro_torch.runtime import persistence
        return persistence.save_index(self, directory, manager=manager)

    @classmethod
    def load(cls, directory: str, *, step: Optional[int] = None, device="cuda",
             backend: Optional[str] = None,
             compile_counts: Optional[Dict[str, int]] = None, mesh=None,
             mesh_axis=None, merge: str = "auto"):
        """Rebuild a served index from a saved generation on ``device`` —
        or, with ``mesh``, onto any mesh shape (a ``ShardedKNNIndex``):
        REORDER and ε selection are replayed, not recomputed."""
        from repro_torch.runtime import persistence
        return persistence.load_index(directory, step=step, device=device,
                                      backend=backend, compile_counts=compile_counts,
                                      mesh=mesh, mesh_axis=mesh_axis, merge=merge)

    # -- mutations (DESIGN.md §6) ------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Add points to the corpus (delta buffer).  Returns the global ids
        assigned to them, valid as of this call's return (post-compaction
        ids when the insert tripped the auto-compact threshold)."""
        self._check_mutable()
        points = met_lib.prepare_rows(
            validate_points(points, self.n_dims, what="inserted points"),
            self.config.metric, "inserted points", context="KNNIndex.insert")
        gen, mut = self._live
        new_mut, gids = mut.with_insert(points, gen.n_base, self.n_dims)
        self._live = (gen, new_mut)
        remap = self._maybe_autocompact()
        if remap is not None:
            gids = remap[gids]
        return gids

    def delete(self, ids) -> None:
        """Remove points by global id (tombstones).  Raises ValueError on
        unknown or already-deleted ids."""
        self._check_mutable()
        gen, mut = self._live
        self._live = (gen, mut.with_delete(ids, gen.n_base))
        self._maybe_autocompact()

    def _check_mutable(self) -> None:
        if self._live[0].projection is not None:
            raise ValueError(
                "insert/delete are not supported on a projection-fronted index "
                "(the fitted projection would go stale against a drifting corpus) "
                "— rebuild with KNNIndex.build(...) on the updated points, or set "
                "projection_dim=0")

    def net_points(self) -> np.ndarray:
        """The live corpus in original dim order, ascending global id —
        ``KNNIndex.build(index.net_points(), config)`` is the index
        ``compact()`` swaps in."""
        gen, mut = self._live
        return mut.net_corpus(gen.points_np())[0]

    def _maybe_autocompact(self) -> Optional[np.ndarray]:
        gen, mut = self._live
        frac = self.config.mutation_compact_frac
        if mut.n_delta_rows > frac * gen.n_base or mut.n_base_tombs > frac * gen.n_base:
            return self.compact()
        return None

    def compact(self) -> np.ndarray:
        """Fold all pending mutations into a fresh generation: REORDER, ε
        selection (replaying build()'s ε argument) and grid/pyramid over the
        net corpus, then swap the (generation, mutations) pair atomically.

        Returns the id remap: ``remap[old_gid]`` is the point's id in the
        new generation, −1 if deleted.  Later queries are bit-identical to
        ``KNNIndex.build(net_points, config, ε_arg)``."""
        gen, mut = self._live
        if mut.is_clean:
            return np.arange(gen.n_base, dtype=np.int64)
        net, _ = mut.net_corpus(gen.points_np())
        if self.config.k >= len(net):
            raise ValueError(f"cannot compact: k={self.config.k} needs more than the "
                             f"{len(net)} live points")
        remap = mut.remap_after_compact(gen.n_base)
        fresh = KNNIndex.build(net, self.config, self._epsilon_arg, device=self.device,
                               backend=self.backend, compile_counts=self.compile_counts)
        self._live = (fresh._live[0], mut_lib.MutationState.empty(self.n_dims))
        self.generation += 1
        self.t_select_eps = fresh.t_select_eps
        self.t_build = fresh.t_build
        return remap

    # -- engine callables for the work queue -------------------------------
    # Each closure binds one _Generation explicitly, so a compact() mid-query
    # cannot mix generations' state.

    def _grid_metric(self, gen: _Generation) -> str:
        """The kernel metric of the grid-space engines: cosine rides the l2
        kernels over unit rows, and a projected grid is always l2 space —
        the true metric returns at rescore time."""
        if gen.projection is not None:
            return "l2"
        return met_lib.kernel_metric(self.config.metric)

    def _dense_fn(self, gen: _Generation, k: int, queries_rp, exclude_self: bool,
                  eps_scale: Optional[float] = None):
        cfg = self.config
        # ε is a device operand: the lean pass's scaled ε reuses the exact
        # path's engine bucket.
        eps_arg = torch.tensor(gen.eps if eps_scale is None else gen.eps * eps_scale,
                               dtype=torch.float32, device=self.device)

        def dense_fn(ids: np.ndarray):
            qp = hybrid_lib._pad_ids(ids, cfg.query_block, self.device)
            args = (gen.grid, gen.points_r, qp, eps_arg)
            if queries_rp is not None:
                args = args + (queries_rp,)
            kwargs = dict(
                k=k, budget=cfg.dense_budget, query_block=cfg.query_block,
                block_c=cfg.block_c, backend=self.backend,
                exclude_self=exclude_self, metric=self._grid_metric(gen),
                distance_dtype=cfg.distance_dtype,
            )
            run_engine(self, "dense", args, kwargs)
            _sync(self.device)
            t0 = time.perf_counter()
            res = dense_lib.dense_join(*args, **kwargs)
            n = len(ids)
            out = (res.dists[:n].cpu().numpy(), res.ids[:n].cpu().numpy(),
                   res.failed[:n].cpu().numpy())
            return out + (time.perf_counter() - t0,)

        return dense_fn

    def _sparse_fn(self, gen: _Generation, k: int, queries_rp, exclude_self: bool):
        cfg = self.config

        def sparse_fn(ids: np.ndarray) -> queue_lib.AsyncEngineCall:
            qp = hybrid_lib._pad_ids(ids, cfg.query_block, self.device)
            args = (gen.pyramid, gen.points_r, qp)
            if queries_rp is not None:
                args = args + (queries_rp,)
            kwargs = dict(
                k=k, budget=cfg.sparse_budget, query_block=cfg.query_block,
                sel_factor=cfg.sel_factor, backend=self.backend,
                exclude_self=exclude_self, metric=self._grid_metric(gen),
                distance_dtype=cfg.distance_dtype,
            )
            run_engine(self, "sparse", args, kwargs)
            t0 = time.perf_counter()
            raw = sparse_lib.sparse_knn(*args, **kwargs)
            n = len(ids)

            def finalize(r):
                return (r.dists[:n].cpu().numpy(), r.ids[:n].cpu().numpy(),
                        r.certified[:n].cpu().numpy())

            return queue_lib.AsyncEngineCall(raw, finalize, device=self.device,
                                             t_dispatch=t0)

        return sparse_fn

    def _brute_over(self, corpus: torch.Tensor, metric: str, k: int, queries_p,
                    exclude_self: bool):
        """The brute engine over ``corpus`` (its own rows as the queries when
        ``queries_p`` is None) in kernel metric ``metric``."""
        cfg = self.config

        def brute_fn(ids: np.ndarray):
            qp = hybrid_lib._pad_ids(ids, cfg.query_block, self.device)
            queries = corpus if queries_p is None else queries_p
            args = (corpus, qp) + (() if queries_p is None else (queries_p,))
            kwargs = dict(k=k, corpus_chunk=cfg.brute_chunk,
                          exclude_self=exclude_self, metric=metric)
            run_engine(self, "brute", args, kwargs)
            # Only the real rows are scored: the pow2 padding keys the
            # bucket, and brute work grows with every padding row.
            live = qp[: len(ids)]
            safe = torch.clamp(live, 0, queries.shape[0] - 1).long()
            d, i = brute_lib.brute_knn(
                corpus, queries[safe], dense_lib._exclusion_ids(live, exclude_self),
                k=k, corpus_chunk=cfg.brute_chunk, metric=metric)
            return d.cpu().numpy(), i.cpu().numpy()

        return brute_fn

    def _brute_fn(self, gen: _Generation, k: int, queries_rp, exclude_self: bool):
        return self._brute_over(gen.points_r, self._grid_metric(gen), k, queries_rp,
                                exclude_self)

    def _full_brute_fn(self, gen: _Generation, k: int, queries_fp, exclude_self: bool):
        """Brute engine over the full-dimension corpus in the true kernel
        metric — the projected path's exact fallback and its calibration
        reference (the projected grid's own brute lane runs in projected l2
        space)."""
        return self._brute_over(gen.points_full, met_lib.kernel_metric(self.config.metric),
                                k, queries_fp, exclude_self)

    # -- work split --------------------------------------------------------

    def _self_split(self, gen: _Generation, k: int, rho: float):
        """Dense/sparse assignment of the indexed cloud itself (cached per
        (k, ρ): home-cell densities never change between compactions)."""
        hit = gen.self_splits.get((k, rho))
        if hit is not None:
            return hit
        cfg = self.config
        split = split_lib.split_from_counts(
            torch.as_tensor(gen.home_counts), k, gen.grid.m, cfg.gamma, rho)
        to_dense = split.to_dense.numpy()
        out = (np.nonzero(to_dense)[0].astype(np.int32),
               np.nonzero(~to_dense)[0].astype(np.int32),
               float(split.threshold))
        gen.self_splits[(k, rho)] = out
        return out

    def _query_split(self, gen: _Generation, queries_r, k: int, net_cells=None,
                     rho: Optional[float] = None):
        """The §V-D split of a foreign query batch by reference-grid
        density: (dense_ids, sparse_ids, home_counts, threshold).
        ``net_cells`` — (live delta rows, tombstoned base rows), both in the
        REORDER frame — corrects the densities to the net corpus; ``rho``
        overrides the config's ρ floor."""
        cfg = self.config
        rho = cfg.rho if rho is None else rho
        q_coords = grid_lib.compute_cell_coords(gen.grid, queries_r[:, : gen.grid.m])
        net_adjust = None
        if net_cells is not None:
            q_cells = grid_lib.linearize(q_coords, gen.grid.radices).cpu().numpy()
            net_adjust = torch.as_tensor(
                mut_lib.net_cell_adjustment(gen.grid, q_cells, *net_cells), device=self.device)
        split = split_lib.split_queries(gen.grid, q_coords, k, cfg.gamma, rho,
                                        net_adjust=net_adjust)
        to_dense = split.to_dense.cpu().numpy()
        return (np.nonzero(to_dense)[0].astype(np.int32),
                np.nonzero(~to_dense)[0].astype(np.int32),
                split.home_counts.cpu().numpy(), float(split.threshold))

    # -- the query pipeline ------------------------------------------------

    def _drain(self, gen: _Generation, kq: int, n_q: int, queries_rp, dense_ids,
               sparse_ids, home_counts, exclude_self: bool, rho: Optional[float] = None):
        """Steps 5–8 of Algorithm 1: the §V-A work queue over the three
        engines.  Returns raw scores (squared L2 / −q·c), so merge-time
        folds compare like with like.  ``rho`` overrides the config's ρ
        floor."""
        cfg = self.config
        rho = cfg.rho if rho is None else rho
        return queue_lib.run_work_queue(
            npts=n_q, k=kq, dense_ids=dense_ids, sparse_ids=sparse_ids,
            home_counts=home_counts,
            dense_fn=self._dense_fn(gen, kq, queries_rp, exclude_self),
            sparse_fn=self._sparse_fn(gen, kq, queries_rp, exclude_self),
            brute_fn=self._brute_fn(gen, kq, queries_rp, exclude_self),
            n_batches=cfg.n_batches, online_rebalance=cfg.online_rebalance,
            sync_t1_after=cfg.rebalance_sync_batches,
            min_sparse=int(math.ceil(rho * n_q)), demote_quantum=cfg.query_block,
        )

    def _stats(self, gen: _Generation, n_dense: int, n_sparse: int, threshold: float,
               report, compiles_before: int, t_delta: float = 0.0):
        return hybrid_lib.JoinStats(
            epsilon=gen.eps, epsilon_beta=gen.eps_beta,
            n_dense=n_dense, n_sparse=n_sparse,
            n_failed=report.n_failed, n_uncertified=report.n_uncertified,
            n_thresh=threshold,
            t_dense=report.t_dense, t_sparse=report.t_sparse,
            t_brute=report.t_brute, t_delta=t_delta, t_wall=report.t_wall + t_delta,
            t1_per_query=report.t1_per_query, t2_per_query=report.t2_per_query,
            rho_model=split_lib.rho_model(report.t1_per_query, report.t2_per_query),
            n_batches=report.n_dense_batches,
            batch_sizes=list(report.batch_sizes),
            t_dense_batches=list(report.t_batches),
            n_rebalanced=report.n_rebalanced,
            n_sparse_rounds=report.n_sparse_rounds,
            n_sparse_engine_total=report.n_sparse_engine_total,
            rho_online=report.rho_online,
            n_engine_compiles=self.total_compiles - compiles_before,
        )

    def _reordered(self, gen: _Generation, q_np: np.ndarray):
        """(queries in the REORDER frame, the same rows padded to the
        query-shape bucket) on the index's device."""
        q = torch.as_tensor(q_np, device=self.device)
        queries_r = q[:, gen.dim_perm] if gen.dim_perm is not None else q
        return queries_r, pad_rows_pow2(queries_r, self.config.query_block).contiguous()

    def query(self, queries=None, k: Optional[int] = None, exclude_self: bool = False, *,
              _net_cells=None, _rho: Optional[float] = None) -> "hybrid_lib.KNNResult":
        """Hybrid KNN of ``queries`` (original dim order; ``None`` or the
        indexed array itself selects the self-join path) against the
        indexed reference cloud: the §V-D split by reference-grid density,
        the §V-A work queue over both engines, §V-E failure reassignment
        and the brute backstop — exact for arbitrary R≠S query sets.
        ``exclude_self`` masks reference point i for query row i (with
        ``queries=None`` on a mutated index, each live point's own global
        id).

        Routing, in the reference's order: a mutated index folds the delta
        buffer and tombstones in at merge time (``_query_mutated``, exact);
        a projected generation runs the projection front stage and the
        full-dimension rescore (``_query_projected``); an un-projected ip
        index serves through the exact brute lane; ``recall_target < 1``
        serves the calibrated lean pass (``_query_approx``); everything
        else takes the exact path, which ``recall_target=1.0`` leaves
        bit-identical.

        ``_net_cells`` is internal (sharded serving): reordered (delta,
        tombstone) point arrays whose home cells adjust this grid's density
        split to the net corpus.  ``_rho`` overrides the config's ρ floor for
        this call (the sharded layer's online Eq. 6 re-suggestion) — work
        routing only; results are exact either way."""
        gen, mut = self._live
        if not mut.is_clean:
            assert _net_cells is None
            return self._query_mutated(gen, mut, queries, k, exclude_self)
        cfg = self.config
        rho = cfg.rho if _rho is None else float(np.clip(_rho, 0.0, 1.0))
        npts_ref = gen.n_base
        max_k = npts_ref - 1 if exclude_self else npts_ref
        kq = validate_k(cfg.k if k is None else k, max_k,
                        context=" after self-exclusion" if exclude_self else "")
        compiles_before = self.total_compiles

        is_self = queries is None or queries is gen.points_ref
        q_np = None
        queries_rp = None
        if is_self:
            n_q = npts_ref
        else:
            q_np = met_lib.prepare_rows(validate_points(queries, self.n_dims),
                                        cfg.metric, "queries", context="KNNIndex.query")
            n_q = int(q_np.shape[0])
        if gen.projection is not None:
            return self._query_projected(gen, kq, n_q, q_np, exclude_self,
                                         compiles_before, rho)
        if not is_self:
            queries_r, queries_rp = self._reordered(gen, q_np)
        if cfg.metric == "ip":
            return self._query_brute_all(gen, kq, n_q, queries_rp, exclude_self,
                                         compiles_before)

        if is_self:
            dense_ids, sparse_ids, threshold = self._self_split(gen, kq, rho)
            home_counts = gen.home_counts
        else:
            dense_ids, sparse_ids, home_counts, threshold = self._query_split(
                gen, queries_r, kq, _net_cells, rho)
        if cfg.recall_target < 1.0 and _net_cells is None:
            return self._query_approx(gen, kq, n_q, queries_rp, dense_ids, sparse_ids,
                                      home_counts, threshold, exclude_self,
                                      compiles_before, rho)

        final_d, final_i, source, report = self._drain(
            gen, kq, n_q, queries_rp, dense_ids, sparse_ids, home_counts, exclude_self, rho)
        stats = self._stats(gen, len(dense_ids), len(sparse_ids), threshold, report,
                            compiles_before)
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(final_d, cfg.metric), ids=final_i,
            source=source, stats=stats)

    def _brute_result(self, gen: _Generation, n_q: int, d, i, dt: float,
                      compiles_before: int) -> "hybrid_lib.KNNResult":
        """A result served whole by one brute engine call, source 2."""
        stats = hybrid_lib.JoinStats(
            epsilon=gen.eps, epsilon_beta=gen.eps_beta, t_brute=dt, t_wall=dt,
            n_engine_compiles=self.total_compiles - compiles_before)
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(d, self.config.metric), ids=i,
            source=np.full((n_q,), 2, np.int32), stats=stats)

    def _query_brute_all(self, gen: _Generation, kq: int, n_q: int, queries_rp,
                         exclude_self: bool, compiles_before: int):
        """Raw inner-product serving: neither the grid's routing nor the
        sparse certificates bound ip, so every query serves through the
        exact brute lane (one padded batch).  Approximate ip wants the
        projection front stage."""
        t0 = time.perf_counter()
        d, i = self._brute_fn(gen, kq, queries_rp, exclude_self)(
            np.arange(n_q, dtype=np.int32))
        return self._brute_result(gen, n_q, d, i, time.perf_counter() - t0,
                                  compiles_before)

    def _query_full_brute(self, gen: _Generation, kq: int, n_q: int, q_np,
                          exclude_self: bool, compiles_before: int):
        """The projected path's exact fallback: no candidate rung met
        ``recall_target`` on the held-out sample, so serve exact
        full-dimension brute (estimate 1.0) — the engine calibration used
        for its reference."""
        qfp = (None if q_np is None else pad_rows_pow2(
            torch.as_tensor(q_np, device=self.device), self.config.query_block).contiguous())
        t0 = time.perf_counter()
        d, i = self._full_brute_fn(gen, kq, qfp, exclude_self)(
            np.arange(n_q, dtype=np.int32))
        return self._brute_result(gen, n_q, d, i, time.perf_counter() - t0,
                                  compiles_before)

    def _lean_pass(self, gen: _Generation, kq: int, n_q: int, queries_rp,
                   dense_ids: np.ndarray, sparse_ids: np.ndarray, exclude_self: bool,
                   eps_scale: float):
        """One-shot approximate candidate stage: the sparse engine dispatched
        first, the dense engine once at scaled ε (a device operand: the
        exact path's bucket), then no failure reassignment and no brute
        certification — the missing backstops are what the calibrated
        tier's measured recall pays for."""
        d_out = np.full((n_q, kq), np.inf, np.float32)
        i_out = np.full((n_q, kq), -1, np.int32)
        source = np.zeros((n_q,), np.int32)
        t0 = time.perf_counter()
        t_dense = t_sparse = 0.0
        n_failed = n_uncert = 0
        call = None
        if len(sparse_ids):
            call = self._sparse_fn(gen, kq, queries_rp, exclude_self)(sparse_ids)
        if len(dense_ids):
            dd, di, dfail, t_dense = self._dense_fn(
                gen, kq, queries_rp, exclude_self, eps_scale=eps_scale)(dense_ids)
            d_out[dense_ids] = dd
            i_out[dense_ids] = di
            n_failed = int(np.sum(dfail))
        if call is not None:
            sd, si, cert = call.get()
            t_sparse = call.elapsed or 0.0
            d_out[sparse_ids] = sd
            i_out[sparse_ids] = si
            source[sparse_ids] = 1
            n_uncert = int(np.sum(~cert))
        report = queue_lib.QueueReport(
            batch_sizes=[len(dense_ids)] if len(dense_ids) else [],
            t_batches=[t_dense] if len(dense_ids) else [],
            n_dense_batches=1 if len(dense_ids) else 0,
            n_sparse_rounds=1 if len(sparse_ids) else 0,
            n_failed=n_failed, n_uncertified=n_uncert,
            n_sparse_engine_total=len(sparse_ids),
            t_dense=t_dense, t_sparse=t_sparse, t_wall=time.perf_counter() - t0)
        return d_out, i_out, source, report

    def _query_approx(self, gen: _Generation, kq: int, n_q: int, queries_rp, dense_ids,
                      sparse_ids, home_counts, threshold: float, exclude_self: bool,
                      compiles_before: int, rho: Optional[float] = None
                      ) -> "hybrid_lib.KNNResult":
        """``recall_target < 1``: serve the calibrated lean tier, or the
        exact pipeline (estimate 1.0) when no lean tier met the target on
        the held-out sample."""
        eps_scale, est = cal_lib.grid_tier(self, gen, kq)
        if eps_scale is None:
            final_d, final_i, source, report = self._drain(
                gen, kq, n_q, queries_rp, dense_ids, sparse_ids, home_counts, exclude_self,
                rho)
        else:
            final_d, final_i, source, report = self._lean_pass(
                gen, kq, n_q, queries_rp, dense_ids, sparse_ids, exclude_self, eps_scale)
        stats = self._stats(gen, len(dense_ids), len(sparse_ids), threshold, report,
                            compiles_before)
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(final_d, self.config.metric), ids=final_i,
            source=source, stats=stats, recall_estimate=est)

    def _projected_pass(self, gen: _Generation, kq: int, k_cand: int, n_q: int,
                        queries_rp, qf: torch.Tensor, exclude_self: bool,
                        rho: Optional[float] = None):
        """Projection front stage, one batch: the full exact pipeline (work
        queue and brute certification) in projected space at ``k_cand``,
        then the ``"rescore"`` engine reduces each candidate pool to the k
        best in the full dimension.  ``queries_rp`` is the padded projected
        batch (None = the self-join over the projected corpus); ``qf`` the
        full-width query rows the rescore reads."""
        cfg = self.config
        rho = cfg.rho if rho is None else rho
        if queries_rp is None:
            dense_ids, sparse_ids, threshold = self._self_split(gen, k_cand, rho)
            home_counts = gen.home_counts
        else:
            dense_ids, sparse_ids, home_counts, threshold = self._query_split(
                gen, queries_rp[:n_q], k_cand, rho=rho)
        _, ci, source, report = self._drain(
            gen, k_cand, n_q, queries_rp, dense_ids, sparse_ids, home_counts, exclude_self,
            rho)
        t0 = time.perf_counter()
        dev = self.device
        metric = met_lib.kernel_metric(cfg.metric)
        qb = pow2_bucket(n_q, cfg.query_block)

        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        # The bucket is keyed on the padded batch, as the reference's
        # engine is; only the real rows are rescored.
        run_engine(self, "rescore", (gen.points_full, meta(qb, gen.n_dims),
                                     meta(qb, k_cand, dtype=torch.int32),
                                     meta(qb, dtype=torch.int32)),
                   dict(k=kq, metric=metric))
        excl = (torch.arange(n_q, dtype=torch.int32, device=dev) if exclude_self
                else torch.full((n_q,), -2, dtype=torch.int32, device=dev))
        rd, ri = rescore_topk(gen.points_full, qf, torch.as_tensor(ci, device=dev), excl,
                              k=kq, metric=metric)
        rd, ri = rd.cpu().numpy(), ri.cpu().numpy()
        t_rescore = time.perf_counter() - t0
        return (rd, ri, source, report, threshold, len(dense_ids), len(sparse_ids),
                t_rescore)

    def _query_projected(self, gen: _Generation, kq: int, n_q: int, q_np,
                         exclude_self: bool, compiles_before: int,
                         rho: Optional[float] = None) -> "hybrid_lib.KNNResult":
        """Projection-fronted query: the candidate pool's size comes from
        the calibrated rung ladder (``retrieval/calibrate.py``); when no
        rung met the target on the held-out sample, serve exact
        full-dimension brute instead."""
        cfg = self.config
        cand_mult, est = cal_lib.projected_tier(self, gen, kq)
        if cand_mult is None:
            return self._query_full_brute(gen, kq, n_q, q_np, exclude_self,
                                          compiles_before)
        if q_np is None:
            queries_rp = None
            qf = gen.points_full
        else:
            qproj = torch.as_tensor(gen.projection.apply(q_np), device=self.device)
            queries_rp = pad_rows_pow2(qproj, cfg.query_block).contiguous()
            qf = torch.as_tensor(q_np, device=self.device)
        max_k = gen.n_base - 1 if exclude_self else gen.n_base
        k_cand = max(kq, min(cand_mult * kq, max_k))
        rd, ri, source, report, threshold, n_dense, n_sparse, t_rescore = (
            self._projected_pass(gen, kq, k_cand, n_q, queries_rp, qf, exclude_self, rho))
        stats = self._stats(gen, n_dense, n_sparse, threshold, report, compiles_before)
        stats.t_merge += t_rescore
        stats.t_wall += t_rescore
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(rd, cfg.metric), ids=ri, source=source,
            stats=stats, recall_estimate=est)

    def _query_mutated(self, gen: _Generation, mut: mut_lib.MutationState, queries,
                       k: Optional[int], exclude_self: bool) -> "hybrid_lib.KNNResult":
        """The dirty-index query path: the main hybrid pipeline over the
        base corpus at tombstone-headroomed k (no engine-level exclusion),
        a brute top-K over the delta buffer (engine kind ``"delta"``), then
        one merge-time fold (kind ``"merge"``) that masks tombstones and
        self by global id and folds the delta block in — exact for any
        mutation state."""
        cfg = self.config
        n_base = gen.n_base
        n_live = mut.n_live(n_base)
        max_k = n_live - 1 if exclude_self else n_live
        kq = validate_k(cfg.k if k is None else k, max_k,
                        context=(" (live, after self-exclusion)" if exclude_self
                                 else " (live)"))
        compiles_before = self.total_compiles

        if queries is None:
            q_np, net_gids = mut.net_corpus(gen.points_np())
            excl = (net_gids.astype(np.int32) if exclude_self
                    else np.full((len(q_np),), -2, np.int32))
        else:
            q_np = met_lib.prepare_rows(validate_points(queries, self.n_dims),
                                        cfg.metric, "queries", context="KNNIndex.query")
            excl = (np.arange(q_np.shape[0], dtype=np.int32) if exclude_self
                    else np.full((q_np.shape[0],), -2, np.int32))
        n_q = int(q_np.shape[0])
        queries_r, queries_rp = self._reordered(gen, q_np)
        qb = int(queries_rp.shape[0])
        dim_perm = gen.dim_perm_np()

        # Main pipeline, widened so merge-time masking cannot starve the
        # top-k; engine-level exclusion is off (exclusion is by global id in
        # the fold: the engines' positional identity means nothing against
        # net-corpus queries).
        k_main = min(kq + mut_lib.headroom_bucket(mut.n_base_tombs, exclude_self), n_base)
        if cfg.metric == "ip":
            # No triangle inequality: the widened main pipeline IS the brute lane.
            dense_ids = sparse_ids = np.empty((0,), np.int32)
            threshold = 0.0
            t0 = time.perf_counter()
            final_d, final_i = self._brute_fn(gen, k_main, queries_rp, False)(
                np.arange(n_q, dtype=np.int32))
            dt = time.perf_counter() - t0
            source = np.full((n_q,), 2, np.int32)
            report = queue_lib.QueueReport(t_brute=dt, t_wall=dt)
        else:
            # §V-D split against the NET density: base grid counts corrected
            # by the delta / tombstone cell populations.
            tombs = torch.as_tensor(mut.base_tombs, device=self.device).long()
            net_cells = (mut.delta_r(dim_perm)[mut.delta_live],
                         gen.points_r[tombs].cpu().numpy())
            dense_ids, sparse_ids, home_counts, threshold = self._query_split(
                gen, queries_r, kq, net_cells)
            final_d, final_i, source, report = self._drain(
                gen, k_main, n_q, queries_rp, dense_ids, sparse_ids, home_counts, False)

        # Delta top-K + fold, over the padded query bucket as the engine
        # shapes are keyed.
        t0 = time.perf_counter()
        dev = self.device
        delta_pts_p, delta_gids = mut.padded_delta(dim_perm, n_base)
        k_delta = min(kq, delta_pts_p.shape[0])
        excl_p = np.full((qb,), -2, np.int32)
        excl_p[:n_q] = excl
        excl_t = torch.as_tensor(excl_p, device=dev)
        dargs = (queries_rp, torch.as_tensor(delta_pts_p, device=dev), excl_t,
                 torch.as_tensor(delta_gids, device=dev))
        dkw = dict(k=k_delta, metric=self._grid_metric(gen))
        run_engine(self, "delta", dargs, dkw)
        dd, di = mut_lib.delta_topk(*dargs, **dkw)

        md = np.full((qb, k_main), np.inf, np.float32)
        mi = np.full((qb, k_main), -1, np.int32)
        md[:n_q] = final_d
        mi[:n_q] = final_i
        fargs = (torch.as_tensor(md, device=dev), torch.as_tensor(mi, device=dev), dd, di,
                 torch.as_tensor(mut.tombstone_table(), device=dev), excl_t)
        fkw = dict(k=kq)
        run_engine(self, "merge", fargs, fkw)
        fd, fi = mut_lib.fold_topk(*fargs, **fkw)
        fd, fi = fd[:n_q].cpu().numpy(), fi[:n_q].cpu().numpy()
        t_delta = time.perf_counter() - t0

        stats = self._stats(gen, len(dense_ids), len(sparse_ids), threshold, report,
                            compiles_before, t_delta=t_delta)
        # Source labels the main-pipeline engine; delta-buffer hits don't
        # relabel (the fold is uniform merge work).
        return hybrid_lib.KNNResult(dists=met_lib.finalize(fd, cfg.metric), ids=fi,
                                    source=source, stats=stats)
