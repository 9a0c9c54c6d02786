"""Index/query serving API: build once, query many — in PyTorch.

Port of ``repro/runtime/knn_index.py`` for one device, a clean (never
mutated) index and exact results in the l2, ip or cosine metric:

  * ``KNNIndex.build(points, config, device=...)`` runs the per-database
    steps once — REORDER by variance (§IV-D), ε selection (§V-C, the
    ``bin_hist`` kernel), ε-grid + pyramid construction;
  * ``index.query(queries, k=None, exclude_self=False)`` runs the hybrid
    dense/sparse/brute pipeline through the §V-A work queue for an
    arbitrary (R≠S) query set; ``index.query(exclude_self=True)`` is the
    classic self-join.

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
    """The built snapshot of the reference cloud that ``query`` reads."""

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


class KNNIndex:
    """A built reference cloud plus everything needed to serve queries.

    >>> index = KNNIndex.build(db_points, HybridConfig(k=10), device="cuda")
    >>> r = index.query(batch)                     # R≠S join, k=10
    >>> r = index.query(exclude_self=True)         # the classic self-join
    """

    def __init__(self, config, *, backend: str, device: torch.device,
                 generation: _Generation, t_select_eps: float = 0.0,
                 t_build: float = 0.0,
                 compile_counts: Optional[Dict[str, int]] = None):
        self.config = config
        self.backend = backend
        self.device = device
        self._gen = generation
        self.t_select_eps = t_select_eps
        self.t_build = t_build
        self.compile_counts = (
            compile_counts if compile_counts is not None
            else {"dense": 0, "sparse": 0, "brute": 0})

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, points, config, epsilon: Optional[float] = None, *,
              device="cuda", backend: Optional[str] = None,
              compile_counts: Optional[Dict[str, int]] = None, mesh=None):
        """Steps 1–3 of Algorithm 1, once per database: REORDER, ε
        selection (skipped when ``epsilon`` is pinned), grid + pyramid.
        Runs on ``device`` (``"cuda"`` unless the caller asks for the CPU;
        a missing card raises)."""
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
                   t_build=t_build, compile_counts=compile_counts)

    # -- introspection -----------------------------------------------------

    @property
    def points(self):
        """The array ``build`` was given (original dim order)."""
        return self._gen.points_ref

    @property
    def points_r(self):
        return self._gen.points_r

    @property
    def dim_perm(self):
        return self._gen.dim_perm

    @property
    def eps(self) -> float:
        return self._gen.eps

    @property
    def eps_beta(self) -> float:
        return self._gen.eps_beta

    @property
    def grid(self):
        return self._gen.grid

    @property
    def home_counts(self):
        return self._gen.home_counts

    @property
    def n_dims(self) -> int:
        return int(self._gen.points_r.shape[1])

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    # -- not in this slice ---------------------------------------------------

    def insert(self, points):
        raise unported("KNNIndex.insert", "queue A item 12")

    def delete(self, ids):
        raise unported("KNNIndex.delete", "queue A item 12")

    def compact(self):
        raise unported("KNNIndex.compact", "queue A item 12")

    def save(self, directory, **kw):
        raise unported("KNNIndex.save", "queue A item 12")

    @classmethod
    def load(cls, directory, **kw):
        raise unported("KNNIndex.load", "queue A item 12")

    # -- engine callables for the work queue -------------------------------

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
        (k, ρ): home-cell densities never change)."""
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

    # -- the query pipeline ------------------------------------------------

    def query(self, queries=None, k: Optional[int] = None,
              exclude_self: bool = False) -> "hybrid_lib.KNNResult":
        """Exact hybrid KNN of ``queries`` (original dim order; ``None`` or
        the indexed array itself selects the self-join path) against the
        indexed reference cloud: the §V-D split by reference-grid density,
        the §V-A work queue over both engines, §V-E failure reassignment
        and the brute backstop.  ``exclude_self`` masks reference point i
        for query row i."""
        gen = self._gen
        cfg = self.config
        rho = cfg.rho
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
            q = torch.as_tensor(q_np, device=self.device)
            queries_r = q[:, gen.dim_perm] if gen.dim_perm is not None else q
            queries_rp = pad_rows_pow2(queries_r, cfg.query_block).contiguous()
        if cfg.metric == "ip":
            return self._query_brute_all(gen, kq, n_q, queries_rp, exclude_self,
                                         compiles_before)

        if is_self:
            dense_ids, sparse_ids, threshold = self._self_split(gen, kq, rho)
            home_counts = gen.home_counts
        else:
            q_coords = grid_lib.compute_cell_coords(gen.grid, queries_r[:, : gen.grid.m])
            split = split_lib.split_queries(gen.grid, q_coords, kq, cfg.gamma, rho)
            to_dense = split.to_dense.cpu().numpy()
            dense_ids = np.nonzero(to_dense)[0].astype(np.int32)
            sparse_ids = np.nonzero(~to_dense)[0].astype(np.int32)
            home_counts = split.home_counts.cpu().numpy()
            threshold = float(split.threshold)

        final_d, final_i, source, report = queue_lib.run_work_queue(
            npts=n_q, k=kq, dense_ids=dense_ids, sparse_ids=sparse_ids,
            home_counts=home_counts,
            dense_fn=self._dense_fn(gen, kq, queries_rp, exclude_self),
            sparse_fn=self._sparse_fn(gen, kq, queries_rp, exclude_self),
            brute_fn=self._brute_fn(gen, kq, queries_rp, exclude_self),
            n_batches=cfg.n_batches, online_rebalance=cfg.online_rebalance,
            sync_t1_after=cfg.rebalance_sync_batches,
            min_sparse=int(math.ceil(rho * n_q)), demote_quantum=cfg.query_block,
        )
        stats = hybrid_lib.JoinStats(
            epsilon=gen.eps, epsilon_beta=gen.eps_beta,
            n_dense=len(dense_ids), n_sparse=len(sparse_ids),
            n_failed=report.n_failed, n_uncertified=report.n_uncertified,
            n_thresh=threshold,
            t_dense=report.t_dense, t_sparse=report.t_sparse,
            t_brute=report.t_brute, t_wall=report.t_wall,
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
