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
rows; an ip index serves every query through the exact brute lane (ip has
no triangle inequality to bound a grid search); raw scores become reported
distances once, in ``finalize``, at this boundary.

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
from repro_torch.retrieval import metrics as met_lib
from repro_torch.runtime import mutation as mut_lib
from repro_torch.utils import pad_to, pow2_bucket, resolve_device, unported

# Process-global engine shape-bucket keys (the JAX AOT cache's keys).
_ENGINE_CACHE: set = set()


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
    # Self-split cache per (k, ρ): (dense_ids, sparse_ids, threshold).
    self_splits: Dict[Tuple[int, float], Tuple[np.ndarray, np.ndarray, float]] = (
        dataclasses.field(default_factory=dict))

    @property
    def n_base(self) -> int:
        return int(self.points_r.shape[0])

    def points_np(self) -> np.ndarray:
        """The base cloud in original dim order as float32 numpy."""
        p = self.points_ref
        return np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p, np.float32)

    def dim_perm_np(self) -> Optional[np.ndarray]:
        return None if self.dim_perm is None else self.dim_perm.cpu().numpy()


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
                 t_build: float = 0.0,
                 compile_counts: Optional[Dict[str, int]] = None,
                 epsilon_arg: Optional[float] = None):
        self.config = config
        self.backend = backend
        self.device = device
        # The atomic (generation, mutations) pair; delta rows arrive in the
        # corpus' original dim order.
        self._live: Tuple[_Generation, mut_lib.MutationState] = (
            generation, mut_lib.MutationState.empty(int(generation.points_r.shape[1])))
        self.generation = 0
        # The ε argument build() was given (None = re-select), replayed by
        # compact() so a rebuilt generation is bit-identical to
        # KNNIndex.build(net_corpus, config, epsilon_arg).
        self._epsilon_arg = epsilon_arg
        self.t_select_eps = t_select_eps
        self.t_build = t_build
        self.compile_counts = (
            compile_counts if compile_counts is not None
            else {"dense": 0, "sparse": 0, "brute": 0})

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, points, config, epsilon: Optional[float] = None, *,
              device="cuda", backend: Optional[str] = None,
              compile_counts: Optional[Dict[str, int]] = None, mesh=None,
              _prebuilt: Optional[tuple] = None):
        """Steps 1–3 of Algorithm 1, once per database: REORDER, ε
        selection (skipped when ``epsilon`` is pinned), grid + pyramid.
        Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU;
        a missing card raises).

        ``_prebuilt`` is internal (``load``): a ``(points_r, dim_perm, eps,
        eps_beta)`` tuple replaying a saved generation's REORDER and ε
        verbatim, so a load never recomputes either."""
        if mesh is not None:
            raise unported("KNNIndex.build(mesh=...)", "queue A item 15")
        dev = resolve_device(device)
        cfg = config
        pts_np = met_lib.prepare_rows(
            validate_points(points, None, what="indexed points"),
            cfg.metric, "indexed points", context="KNNIndex.build")
        npts, ndim = pts_np.shape
        validate_k(cfg.k, npts - 1, what="config.k",
                   context=" (build needs k < |D|)")

        if _prebuilt is not None:
            points_r, dim_perm, eps, eps_beta = _prebuilt
            points_r = torch.as_tensor(np.asarray(points_r, np.float32), device=dev)
            if dim_perm is not None:
                dim_perm = torch.as_tensor(np.asarray(dim_perm), device=dev).long()
            t_select = 0.0
        else:
            pts = torch.as_tensor(pts_np, device=dev)
            if cfg.reorder:
                points_r, dim_perm = grid_lib.reorder_by_variance(pts)
                points_r = points_r.contiguous()
            else:
                points_r, dim_perm = pts, None
            eps, eps_beta, t_select = select_epsilon(points_r, cfg, epsilon, npts)
        m = min(cfg.m, ndim)

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
                          home_counts=home_counts)
        return cls(cfg,
                   backend=dense_lib.resolve_backend(
                       backend if backend is not None else cfg.backend, dev),
                   device=dev, generation=gen, t_select_eps=t_select,
                   t_build=t_build, compile_counts=compile_counts,
                   epsilon_arg=epsilon)


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
        return int(self._live[0].points_r.shape[1])

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
             compile_counts: Optional[Dict[str, int]] = None, mesh=None):
        """Rebuild a served index from a saved generation on ``device``:
        REORDER and ε selection are replayed, not recomputed."""
        from repro_torch.runtime import persistence
        return persistence.load_index(directory, step=step, device=device,
                                      backend=backend, compile_counts=compile_counts,
                                      mesh=mesh)

    # -- mutations (DESIGN.md §6) ------------------------------------------

    def insert(self, points) -> np.ndarray:
        """Add points to the corpus (delta buffer).  Returns the global ids
        assigned to them, valid as of this call's return (post-compaction
        ids when the insert tripped the auto-compact threshold)."""
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
        gen, mut = self._live
        self._live = (gen, mut.with_delete(ids, gen.n_base))
        self._maybe_autocompact()

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

    def _grid_metric(self) -> str:
        """The kernel metric of the grid-space engines: cosine rides the l2
        kernels over unit rows."""
        return met_lib.kernel_metric(self.config.metric)

    def _dense_fn(self, gen: _Generation, k: int, queries_rp, exclude_self: bool):
        cfg = self.config
        eps_arg = torch.tensor(gen.eps, dtype=torch.float32, device=self.device)

        def dense_fn(ids: np.ndarray):
            qp = hybrid_lib._pad_ids(ids, cfg.query_block, self.device)
            args = (gen.grid, gen.points_r, qp, eps_arg)
            if queries_rp is not None:
                args = args + (queries_rp,)
            kwargs = dict(
                k=k, budget=cfg.dense_budget, query_block=cfg.query_block,
                block_c=cfg.block_c, backend=self.backend,
                exclude_self=exclude_self, metric=self._grid_metric(),
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
                exclude_self=exclude_self, metric=self._grid_metric(),
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

    def _brute_fn(self, gen: _Generation, k: int, queries_rp, exclude_self: bool):
        cfg = self.config

        def brute_fn(ids: np.ndarray):
            qp = hybrid_lib._pad_ids(ids, cfg.query_block, self.device)
            queries = gen.points_r if queries_rp is None else queries_rp
            args = (gen.points_r, qp) + (() if queries_rp is None else (queries_rp,))
            metric = self._grid_metric()
            kwargs = dict(k=k, corpus_chunk=cfg.brute_chunk,
                          exclude_self=exclude_self, metric=metric)
            run_engine(self, "brute", args, kwargs)
            # Only the real rows are scored: the pow2 padding keys the
            # bucket, and brute work grows with every padding row.
            live = qp[: len(ids)]
            safe = torch.clamp(live, 0, queries.shape[0] - 1).long()
            d, i = brute_lib.brute_knn(
                gen.points_r, queries[safe],
                dense_lib._exclusion_ids(live, exclude_self),
                k=k, corpus_chunk=cfg.brute_chunk, metric=metric)
            return d.cpu().numpy(), i.cpu().numpy()

        return brute_fn

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

    def _query_split(self, gen: _Generation, queries_r, k: int, net_cells=None):
        """The §V-D split of a foreign query batch by reference-grid
        density: (dense_ids, sparse_ids, home_counts, threshold).
        ``net_cells`` — (live delta rows, tombstoned base rows), both in the
        REORDER frame — corrects the densities to the net corpus."""
        cfg = self.config
        q_coords = grid_lib.compute_cell_coords(gen.grid, queries_r[:, : gen.grid.m])
        net_adjust = None
        if net_cells is not None:
            q_cells = grid_lib.linearize(q_coords, gen.grid.radices).cpu().numpy()
            net_adjust = torch.as_tensor(
                mut_lib.net_cell_adjustment(gen.grid, q_cells, *net_cells), device=self.device)
        split = split_lib.split_queries(gen.grid, q_coords, k, cfg.gamma, cfg.rho,
                                        net_adjust=net_adjust)
        to_dense = split.to_dense.cpu().numpy()
        return (np.nonzero(to_dense)[0].astype(np.int32),
                np.nonzero(~to_dense)[0].astype(np.int32),
                split.home_counts.cpu().numpy(), float(split.threshold))

    # -- the query pipeline ------------------------------------------------

    def _drain(self, gen: _Generation, kq: int, n_q: int, queries_rp, dense_ids,
               sparse_ids, home_counts, exclude_self: bool):
        """Steps 5–8 of Algorithm 1: the §V-A work queue over the three
        engines.  Returns raw scores (squared L2 / −q·c), so merge-time
        folds compare like with like."""
        cfg = self.config
        return queue_lib.run_work_queue(
            npts=n_q, k=kq, dense_ids=dense_ids, sparse_ids=sparse_ids,
            home_counts=home_counts,
            dense_fn=self._dense_fn(gen, kq, queries_rp, exclude_self),
            sparse_fn=self._sparse_fn(gen, kq, queries_rp, exclude_self),
            brute_fn=self._brute_fn(gen, kq, queries_rp, exclude_self),
            n_batches=cfg.n_batches, online_rebalance=cfg.online_rebalance,
            sync_t1_after=cfg.rebalance_sync_batches,
            min_sparse=int(math.ceil(cfg.rho * n_q)), demote_quantum=cfg.query_block,
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

    def query(self, queries=None, k: Optional[int] = None,
              exclude_self: bool = False) -> "hybrid_lib.KNNResult":
        """Exact hybrid KNN of ``queries`` (original dim order; ``None`` or
        the indexed array itself selects the self-join path) against the
        indexed reference cloud: the §V-D split by reference-grid density,
        the §V-A work queue over both engines, §V-E failure reassignment
        and the brute backstop.  ``exclude_self`` masks reference point i
        for query row i (with ``queries=None`` on a mutated index, each
        live point's own global id).  With mutations pending the delta
        buffer and tombstones fold in at merge time (``_query_mutated``);
        a clean index takes this path untouched."""
        gen, mut = self._live
        if not mut.is_clean:
            return self._query_mutated(gen, mut, queries, k, exclude_self)
        cfg = self.config
        npts_ref = gen.n_base
        max_k = npts_ref - 1 if exclude_self else npts_ref
        kq = validate_k(cfg.k if k is None else k, max_k,
                        context=" after self-exclusion" if exclude_self else "")
        compiles_before = self.total_compiles

        is_self = queries is None or queries is gen.points_ref
        if is_self:
            n_q = npts_ref
            queries_rp = None
        else:
            q_np = met_lib.prepare_rows(validate_points(queries, self.n_dims),
                                        cfg.metric, "queries", context="KNNIndex.query")
            n_q = int(q_np.shape[0])
            queries_r, queries_rp = self._reordered(gen, q_np)
        if cfg.metric == "ip":
            return self._query_brute_all(gen, kq, n_q, queries_rp, exclude_self,
                                         compiles_before)

        if is_self:
            dense_ids, sparse_ids, threshold = self._self_split(gen, kq, cfg.rho)
            home_counts = gen.home_counts
        else:
            dense_ids, sparse_ids, home_counts, threshold = self._query_split(
                gen, queries_r, kq)

        final_d, final_i, source, report = self._drain(
            gen, kq, n_q, queries_rp, dense_ids, sparse_ids, home_counts, exclude_self)
        stats = self._stats(gen, len(dense_ids), len(sparse_ids), threshold, report,
                            compiles_before)
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(final_d, cfg.metric), ids=final_i,
            source=source, stats=stats)

    def _query_brute_all(self, gen: _Generation, kq: int, n_q: int, queries_rp,
                         exclude_self: bool, compiles_before: int):
        """Raw inner-product serving: neither the grid's routing nor the
        sparse certificates bound ip, so every query serves through the
        exact brute lane (one padded batch), source 2."""
        t0 = time.perf_counter()
        d, i = self._brute_fn(gen, kq, queries_rp, exclude_self)(
            np.arange(n_q, dtype=np.int32))
        dt = time.perf_counter() - t0
        stats = hybrid_lib.JoinStats(
            epsilon=gen.eps, epsilon_beta=gen.eps_beta, t_brute=dt, t_wall=dt,
            n_engine_compiles=self.total_compiles - compiles_before)
        return hybrid_lib.KNNResult(
            dists=met_lib.finalize(d, self.config.metric), ids=i,
            source=np.full((n_q,), 2, np.int32), stats=stats)

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
        dkw = dict(k=k_delta, metric=self._grid_metric())
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
