"""Sharded KNNIndex: one hybrid pipeline from one device to a mesh
(DESIGN.md §5) — port of ``repro/runtime/sharded_index.py``.

Placement is a layer, not a fork:

  * ``ShardedKNNIndex.build(points, config, mesh=...)`` partitions the
    reference cloud into P equal shards along the cell-sorted order of a
    global ε-grid over the REORDERed points (row ranges of that order cover
    compact cell ranges, so each shard's local grid stays dense), builds
    each shard's grid and pyramid on its slot device
    (``distributed.build_shard_indices``), and wraps each shard in a plain
    ``KNNIndex`` over its sub-cloud.

  * ``index.query(queries, k, exclude_self)`` runs the existing hybrid
    dense/sparse/brute pipeline per shard — the same engines, pow2 query
    buckets and backends; equal shard shapes mean P shards share one set
    of engine buckets — and merges the P shard-local top-K candidate sets
    with ``distributed.collective_topk_merge`` on slot 0's device.  The
    merge's bucket is counted under engine kind ``"merge"``, so the
    zero-bucket steady state covers it too.

The mesh's slots are logical: one process drives them all (on one card
every slot shares ``cuda:0``), and the "collective" is tensor code over the
shards' result tensors.

Exactness bookkeeping: each shard answers with ``k_eff = k (+1 if
exclude_self) (+1 if the shard count padded |D|)`` candidates —
self-exclusion happens at merge time by global id, and an uneven |D| pads
each of the first ``n_pad`` shards with ONE duplicated resident row whose
repeated global id the merge dedups.  A shard's block therefore always
holds its k nearest distinct, non-excluded points (or its whole sub-cloud),
so the merged top-k is exact.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import repro_torch.core.hybrid as hybrid_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.core import distributed as dist_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core import splitter as split_lib
from repro_torch.launch.mesh import Mesh, check_mesh
from repro_torch.retrieval import metrics as met_lib
from repro_torch.runtime import mutation as mut_lib
from repro_torch.runtime.faults import FaultInjector
from repro_torch.runtime.knn_index import (
    KNNIndex, _Generation, _sync, pad_rows_pow2, run_engine, select_epsilon, validate_k,
    validate_points,
)
from repro_torch.runtime.serving import ServingConfig, ServingSupervisor
from repro_torch.runtime.stragglers import OnlineRho
from repro_torch.utils import cdiv, pow2_bucket

#: Mesh axis name reserved for replica groups (``launch.make_serving_mesh``):
#: index state is replicated along it, so it is never a shard axis.
REPLICA_AXIS = "replica"


def _resolve_axes(mesh: Mesh, mesh_axis) -> Tuple[str, ...]:
    if mesh_axis is None:
        axes = tuple(a for a in mesh.axis_names if a != REPLICA_AXIS)
        return axes if axes else tuple(mesh.axis_names)
    if isinstance(mesh_axis, str):
        return (mesh_axis,)
    return tuple(mesh_axis)


@dataclasses.dataclass
class _ShardedGeneration:
    """One immutable built snapshot of the sharded reference cloud — the
    sharded counterpart of ``knn_index._Generation``: the index holds
    ``self._live = (generation, mutations)`` and ``compact()`` swaps that
    one reference atomically (DESIGN.md §6)."""

    points_ref: object
    points_r: torch.Tensor            # on slot 0's device
    points_r_host: np.ndarray         # the same rows as float32 numpy
    dim_perm: Optional[torch.Tensor]
    eps: float
    eps_beta: float
    shards: List[KNNIndex]
    gids: np.ndarray                  # (P, shard_n) i32 global ids
    gids_dev: torch.Tensor            # the same on slot 0's device
    n_pad: int

    @property
    def n_base(self) -> int:
        return int(self.points_r.shape[0])

    @property
    def shard_n(self) -> int:
        return int(self.gids.shape[1])

    def points_np(self) -> np.ndarray:
        p = self.points_ref
        return np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p, np.float32)

    def dim_perm_np(self) -> Optional[np.ndarray]:
        return None if self.dim_perm is None else self.dim_perm.cpu().numpy()


class ShardedKNNIndex:
    """A reference cloud sharded over a slot mesh, served by P shard-local
    hybrid pipelines plus one collective top-K merge.

    >>> mesh = make_serving_mesh(4)                  # launch.mesh
    >>> index = KNNIndex.build(db, cfg, mesh=mesh)   # -> ShardedKNNIndex
    >>> r = index.query(batch)                       # R≠S, exact
    >>> r = index.query(exclude_self=True)           # sharded self-join
    >>> index.compile_counts                         # incl. "merge"
    """

    def __init__(self, config, *, backend: str, mesh: Mesh, axes: Tuple[str, ...],
                 merge: str, generation: _ShardedGeneration, t_select_eps: float = 0.0,
                 t_build: float = 0.0, compile_counts: Optional[Dict[str, int]] = None,
                 epsilon_arg: Optional[float] = None):
        self.config = config
        self.backend = backend
        self.mesh = mesh
        self.axes = axes
        self.n_shards = len(generation.shards)
        self.merge = dist_lib.merge_strategy(self.n_shards, merge)
        self.device = generation.points_r.device
        # Replica groups: every mesh axis NOT in the shard axes multiplies
        # into serving lanes over the same shard state — routing, health and
        # hedging run per (replica, shard) lane (DESIGN.md §7).
        self.n_replicas = int(np.prod(
            [mesh.shape[a] for a in mesh.axis_names if a not in axes]
        )) if set(mesh.axis_names) - set(axes) else 1
        # Fault-tolerant serving state (configure_serving): auto-enabled on
        # the first query when replica groups exist.
        self._supervisor: Optional[ServingSupervisor] = None
        self._faults: FaultInjector = FaultInjector()
        self._serve_step = 0
        self._rho_online = OnlineRho(alpha=0.3, warmup=1)
        self._live: Tuple[_ShardedGeneration, mut_lib.MutationState] = (
            generation, mut_lib.MutationState.empty(int(generation.points_r.shape[1])))
        self.generation = 0
        self._epsilon_arg = epsilon_arg
        self.t_select_eps = t_select_eps
        self.t_build = t_build
        if compile_counts is None:
            compile_counts = {"dense": 0, "sparse": 0, "brute": 0}
        compile_counts.setdefault("merge", 0)
        self.compile_counts = compile_counts
        # Keyed (k_out, dedup): dedup depends on the live generation's
        # n_pad, which compaction may change.
        self._merge_fns: Dict[Tuple[int, bool], object] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, points, config, epsilon: Optional[float] = None, *, mesh: Mesh,
              mesh_axis: Union[str, Sequence[str], None] = None, merge: str = "auto",
              backend: Optional[str] = None, compile_counts: Optional[Dict[str, int]] = None,
              _prebuilt: Optional[tuple] = None) -> "ShardedKNNIndex":
        """Per-database steps, placement-aware: global REORDER + ε selection
        (one geometry for every shard), cell-sorted row-range partition, then
        each shard's grid + pyramid on its slot device.  ``_prebuilt``
        replays a saved generation's REORDER + ε (``runtime/persistence.py``)
        so a restart recomputes neither."""
        cfg = config
        if cfg.projection_dim > 0:
            raise ValueError(
                "projection_dim > 0 is single-device in this release — the projection "
                "front stage and the sharded cell-order partition do not compose yet.  "
                "Build without a mesh, or drop the projection.")
        mesh = check_mesh(mesh)
        axes = _resolve_axes(mesh, mesh_axis)
        n_shards = int(np.prod([mesh.shape[a] for a in axes]))
        devs = dist_lib.shard_devices(mesh, axes)
        dev0 = devs[0]
        # Metric contract on the corpus (DESIGN.md §9.2), before anything is
        # partitioned.
        pts_np = met_lib.prepare_rows(
            validate_points(points, None, what="indexed points"),
            cfg.metric, "indexed points", context="KNNIndex.build")
        npts, ndim = pts_np.shape
        validate_k(cfg.k, npts - 1, what="config.k", context=" (build needs k < |D|)")
        # The ≤1-pad-row-per-shard invariant (merge dedup + k_eff headroom)
        # needs every shard to own at least one real point.
        if npts < n_shards:
            raise ValueError(f"|D|={npts} cannot shard over {n_shards} slots "
                             "(need at least one reference point per shard)")
        m = min(cfg.m, ndim)

        if _prebuilt is not None:
            points_r, dim_perm, eps, eps_beta = _prebuilt[:4]
            points_r = torch.as_tensor(np.asarray(points_r, np.float32), device=dev0)
            if dim_perm is not None:
                dim_perm = torch.as_tensor(np.asarray(dim_perm), device=dev0).long()
            t_select = 0.0
        else:
            # (1) REORDER — once, globally: every shard shares the permutation.
            if cfg.reorder:
                points_r, dim_perm = grid_lib.reorder_by_variance(
                    torch.as_tensor(pts_np, device=dev0))
                points_r = points_r.contiguous()
            else:
                points_r, dim_perm = torch.as_tensor(pts_np, device=dev0), None
            # (2) ε selection — once, globally: one grid geometry class, so P
            # equal-shape shards share one set of engine buckets.
            eps, eps_beta, t_select = select_epsilon(points_r, cfg, epsilon, npts)

        t0 = time.perf_counter()
        # (3) partition: row ranges of the cell-sorted order of a global
        # ε-grid — the grid-partitioned self-join layout.
        eps_t = torch.tensor(eps, dtype=torch.float32, device=dev0)
        pgrid = grid_lib.build_grid(points_r, eps_t, m, materialize_points=False)
        cell_order = pgrid.order.cpu().numpy()
        shard_n = cdiv(npts, n_shards)
        n_pad = shard_n * n_shards - npts
        # Uneven |D|: at most ONE duplicated row per shard — shards
        # 0..n_pad−1 take shard_n−1 real rows and repeat their last one.
        gids = np.empty((n_shards, shard_n), np.int32)
        off = 0
        for p in range(n_shards):
            real = shard_n - (1 if p < n_pad else 0)
            rows = cell_order[off:off + real]
            if real < shard_n:
                rows = np.concatenate([rows, rows[-1:]])
            gids[p] = rows
            off += real
        assert off == npts
        gids_dev = torch.as_tensor(gids, device=dev0)
        blocks = [points_r[gids_dev[p].long()].to(devs[p]) for p in range(n_shards)]

        # (4) shard-local grid + pyramid, each on its slot device.
        grids, pyramids = dist_lib.build_shard_indices(
            mesh, axes, blocks, eps, m, n_levels=cfg.n_levels, level_scale=cfg.level_scale)
        for dev in set(devs):
            _sync(dev)

        bk = dense_lib.resolve_backend(backend if backend is not None else cfg.backend, dev0)
        counts = (compile_counts if compile_counts is not None
                  else {"dense": 0, "sparse": 0, "brute": 0})

        # (5) each shard is a plain KNNIndex over its sub-cloud: REORDER
        # already applied, ε pinned, grid/pyramid prebuilt, counters shared
        # so P shards look like one serving engine.
        shard_cfg = dataclasses.replace(cfg, reorder=False)
        shards = []
        for p in range(n_shards):
            g = grids[p]
            gen = _Generation(points_ref=blocks[p], points_r=blocks[p], dim_perm=None,
                              eps=eps, eps_beta=eps_beta, grid=g, pyramid=pyramids[p],
                              home_counts=g.cell_counts[g.point_cell_pos.long()].cpu().numpy())
            shards.append(KNNIndex(shard_cfg, backend=bk, device=devs[p], generation=gen,
                                   compile_counts=counts))
        t_build = time.perf_counter() - t0

        gen = _ShardedGeneration(
            points_ref=points, points_r=points_r, points_r_host=points_r.cpu().numpy(),
            dim_perm=dim_perm, eps=eps, eps_beta=eps_beta, shards=shards, gids=gids,
            gids_dev=gids_dev, n_pad=n_pad)
        return cls(cfg, backend=bk, mesh=mesh, axes=axes, merge=merge, generation=gen,
                   t_select_eps=t_select, t_build=t_build, compile_counts=counts,
                   epsilon_arg=epsilon)

    # -- introspection -----------------------------------------------------
    # Generation-owned state reads the LIVE generation; compact() swaps it.

    @property
    def points_ref(self):
        return self._live[0].points_ref

    @property
    def points(self):
        return self.points_ref

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
    def shards(self) -> List[KNNIndex]:
        return self._live[0].shards

    @property
    def gids(self) -> np.ndarray:
        return self._live[0].gids

    @property
    def shard_n(self) -> int:
        return self._live[0].shard_n

    @property
    def n_pad(self) -> int:
        return self._live[0].n_pad

    @property
    def n_base(self) -> int:
        return self._live[0].n_base

    @property
    def n_points(self) -> int:
        """LIVE corpus size (= ``n_base`` on a clean index)."""
        gen, mut = self._live
        return mut.n_live(gen.n_base)

    @property
    def n_delta(self) -> int:
        return self._live[1].n_delta_live

    @property
    def n_tombstones(self) -> int:
        return self._live[1].n_base_tombs

    @property
    def is_clean(self) -> bool:
        return self._live[1].is_clean

    @property
    def n_dims(self) -> int:
        return int(self._live[0].points_r.shape[1])

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return tuple(self.mesh.shape[a] for a in self.axes)

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    @property
    def placement_shape(self) -> Tuple[int, int]:
        """(replicas, shards) — the serving placement, independent of how the
        mesh spells its axes."""
        return (self.n_replicas, self.n_shards)

    # -- fault-tolerant serving (DESIGN.md §7) -----------------------------

    def configure_serving(self, serving: Optional[ServingConfig] = None,
                          faults: Optional[FaultInjector] = None) -> ServingSupervisor:
        """Install (or replace) the fault policy of this index's query path:
        straggler-driven hedging, retry across replicas, health marking,
        degraded coverage.  ``faults`` puts a deterministic
        ``FaultInjector`` in front of every sub-query.  Returns the
        ``ServingSupervisor``."""
        self._supervisor = ServingSupervisor(self.n_replicas, self.n_shards, serving)
        if faults is not None:
            self._faults = faults
        return self._supervisor

    @property
    def supervisor(self) -> Optional[ServingSupervisor]:
        """The active fault policy — auto-created on first use when the mesh
        has replica groups, else None until ``configure_serving``."""
        if self._supervisor is None and self.n_replicas > 1:
            self.configure_serving()
        return self._supervisor

    @property
    def rho_suggestion(self) -> Optional[float]:
        """Online Eq. 6 re-suggestion from the serve-time EWMA of the
        per-engine times — None before the first serve."""
        return self._rho_online.suggestion

    def _note_engine_times(self, t1: float, t2: float) -> None:
        self._rho_online.note(t1, t2)

    def _rho_override(self) -> Optional[float]:
        sup = self._supervisor
        if sup is None or not sup.cfg.adapt_rho:
            return None
        return self.rho_suggestion

    # -- persistence (DESIGN.md §7) ----------------------------------------

    def save(self, directory: str, *, manager=None) -> int:
        """Checkpoint the live *global* generation (placement is a load-time
        choice): ``KNNIndex.load(dir, mesh=...)`` rebuilds it onto any mesh
        shape, or none (``runtime/persistence.py``)."""
        from repro_torch.runtime import persistence
        return persistence.save_index(self, directory, manager=manager)

    # -- collective merge --------------------------------------------------

    def _merge(self, k_out: int, dists: torch.Tensor, ids: torch.Tensor, excl: torch.Tensor,
               n_pad: int):
        """The collective merge, its bucket counted under engine kind
        ``"merge"`` and keyed as the JAX package keys its executable.
        ``n_pad`` is the LIVE generation's pad count (dedup only matters
        when a shard carries a duplicated pad row)."""
        dedup = n_pad > 0
        fn = self._merge_fns.get((k_out, dedup))
        if fn is None:
            fn = dist_lib.collective_topk_merge(self.mesh, self.axes, k=k_out,
                                                strategy=self.merge, dedup=dedup)
            self._merge_fns[(k_out, dedup)] = fn
        run_engine(self, "merge", (dists, ids, excl),
                   dict(k=k_out, strategy=self.merge, dedup=dedup, axes=self.axes,
                        mesh=self.mesh))
        return fn(dists, ids, excl)

    # -- mutations (DESIGN.md §6) ------------------------------------------
    # Mutations live at the sharded level: shards stay clean single-device
    # indexes, the delta buffer and tombstones fold in after the collective
    # merge, and compact() re-partitions the net corpus.

    def insert(self, points) -> np.ndarray:
        """Add points (delta buffer).  Returns their global ids, valid as of
        this call's return (post-compaction ids if the insert tripped the
        auto-compact threshold)."""
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
        """The LIVE corpus in original dim order, ascending global id."""
        gen, mut = self._live
        return mut.net_corpus(gen.points_np())[0]

    def _maybe_autocompact(self) -> Optional[np.ndarray]:
        gen, mut = self._live
        frac = self.config.mutation_compact_frac
        if mut.n_delta_rows > frac * gen.n_base or mut.n_base_tombs > frac * gen.n_base:
            return self.compact()
        return None

    def compact(self) -> np.ndarray:
        """Rebuild the sharded index over the net corpus — global REORDER +
        ε (replaying build()'s ε argument), re-partition, shard-local
        grid/pyramid build — into a fresh generation, swapped atomically.
        Returns the old-id → new-id remap (−1 deleted).  Same mesh, axes and
        merge strategy; the bucket counters carry over."""
        gen, mut = self._live
        if mut.is_clean:
            return np.arange(gen.n_base, dtype=np.int64)
        net, _ = mut.net_corpus(gen.points_np())
        if self.config.k >= len(net):
            raise ValueError(f"cannot compact: k={self.config.k} needs more than the "
                             f"{len(net)} live points")
        if len(net) < self.n_shards:
            raise ValueError(f"cannot compact: {len(net)} live points cannot shard over "
                             f"{self.n_shards} slots")
        remap = mut.remap_after_compact(gen.n_base)
        fresh = ShardedKNNIndex.build(
            net, self.config, self._epsilon_arg, mesh=self.mesh, mesh_axis=self.axes,
            merge=self.merge, backend=self.backend, compile_counts=self.compile_counts)
        self._live = (fresh._live[0], mut_lib.MutationState.empty(self.n_dims))
        self.generation += 1
        self.t_select_eps = fresh.t_select_eps
        self.t_build = fresh.t_build
        return remap

    # -- the query pipeline ------------------------------------------------

    def query(self, queries=None, k: Optional[int] = None, exclude_self: bool = False, *,
              _serve_shards: Optional[Tuple[int, ...]] = None) -> "hybrid_lib.KNNResult":
        """Hybrid KNN of ``queries`` against the sharded reference cloud —
        the single-device ``KNNIndex.query`` contract, mesh-placed.

        Every shard serves the full batch as an R≠S join against its
        resident sub-cloud (the per-shard pipeline IS ``KNNIndex.query``),
        then the P shard-local top-k_eff candidate sets meet in the
        collective merge.  ``exclude_self`` masks global reference id i for
        query row i at merge time.  With mutations pending the delta buffer
        and tombstones fold in after the merge (``_query_mutated``).

        ``_serve_shards`` is internal (the overload server's partial rung,
        DESIGN.md §8): only the listed shard ids run their sub-query; the
        result is the exact top-K over the SERVED shards, flagged via
        ``coverage`` (skipped columns False) and ``stats.shards_skipped``."""
        gen, mut = self._live
        if not mut.is_clean:
            return self._query_mutated(gen, mut, queries, k, exclude_self,
                                       _serve_shards=_serve_shards)
        cfg = self.config
        npts = gen.n_base
        max_k = npts - 1 if exclude_self else npts
        kq = validate_k(cfg.k if k is None else k, max_k,
                        context=" after self-exclusion" if exclude_self else "")
        compiles_before = self.total_compiles

        if queries is None or queries is gen.points_ref:
            queries_r = gen.points_r_host
            n_q = npts
        else:
            q = met_lib.prepare_rows(validate_points(queries, self.n_dims), cfg.metric,
                                     "queries", context="KNNIndex.query")
            n_q = int(q.shape[0])
            perm = gen.dim_perm_np()
            queries_r = q[:, perm] if perm is not None else q

        # Candidate head-room: +1 when the merge masks the self id, +1 when a
        # shard may carry one duplicated pad row — capped at the shard size,
        # where a shard returns its whole sub-cloud.
        k_extra = (1 if exclude_self else 0) + (1 if gen.n_pad else 0)
        k_eff = min(kq + k_extra, gen.shard_n)
        excl = (np.arange(n_q, dtype=np.int32) if exclude_self
                else np.full((n_q,), -2, np.int32))
        md, mi, sources, shard_stats, t_merge, serve, skipped, ests = self._shard_serve(
            gen, kq, k_eff, n_q, queries_r, excl, serve_shards=_serve_shards)
        stats = self._stats(gen, shard_stats, t_merge, compiles_before, serve=serve,
                            skipped=skipped)
        return hybrid_lib.KNNResult(
            dists=md[:n_q].cpu().numpy(),
            ids=mi[:n_q].cpu().numpy(),
            # Per-query source over P pipelines: the most expensive path any
            # shard took (0 dense < 1 sparse < 2 brute).
            source=np.max(sources, axis=0),
            stats=stats,
            coverage=self._coverage(n_q, serve, skipped),
            # Approximate shards bound the merged result from below by the
            # weakest shard's measurement.
            recall_estimate=min(ests) if ests else 1.0,
        )

    def _query_mutated(self, gen: _ShardedGeneration, mut: mut_lib.MutationState, queries,
                       k: Optional[int], exclude_self: bool,
                       _serve_shards: Optional[Tuple[int, ...]] = None):
        """The dirty sharded query path: per-shard pipelines + the collective
        merge over the BASE corpus at tombstone-headroomed k (exclusion
        deferred), then the delta-buffer top-K and merge-time fold of the
        single-device path mask tombstones and self by global id and fold
        the inserts in — exact for any mutation state."""
        cfg = self.config
        n_base = gen.n_base
        n_live = mut.n_live(n_base)
        max_k = n_live - 1 if exclude_self else n_live
        kq = validate_k(cfg.k if k is None else k, max_k,
                        context=(" (live, after self-exclusion)" if exclude_self
                                 else " (live)"))
        compiles_before = self.total_compiles

        if queries is None:
            q, net_gids = mut.net_corpus(gen.points_np())
            excl = (net_gids.astype(np.int32) if exclude_self
                    else np.full((len(q),), -2, np.int32))
        else:
            q = met_lib.prepare_rows(validate_points(queries, self.n_dims), cfg.metric,
                                     "queries", context="KNNIndex.query")
            excl = (np.arange(q.shape[0], dtype=np.int32) if exclude_self
                    else np.full((int(q.shape[0]),), -2, np.int32))
        n_q = int(q.shape[0])
        perm = gen.dim_perm_np()
        queries_r = q[:, perm] if perm is not None else q

        # Net-density correction per shard: every shard's split sees all live
        # delta points plus its OWN tombstoned rows.
        delta_live_r = mut.delta_r(perm)[mut.delta_live]
        shard_net_cells = []
        for p in range(self.n_shards):
            own = mut.base_tombs[np.isin(mut.base_tombs, gen.gids[p])]
            shard_net_cells.append((delta_live_r, gen.points_r_host[own]))

        # Headroom so merge-time masking cannot starve the top-k; the merge
        # runs at k_out with no exclusion (deferred to the fold), each shard
        # at k_out + the usual pad-row slack.
        k_out = min(kq + mut_lib.headroom_bucket(mut.n_base_tombs, exclude_self), n_base)
        k_eff = min(k_out + (1 if gen.n_pad else 0), gen.shard_n)
        md, mi, sources, shard_stats, t_merge, serve, skipped, ests = self._shard_serve(
            gen, k_out, k_eff, n_q, queries_r, np.full((n_q,), -2, np.int32),
            shard_net_cells, serve_shards=_serve_shards)
        qb = int(md.shape[0])

        # Delta top-K + fold, counted under the shared engine kinds ("delta",
        # "merge").
        t0 = time.perf_counter()
        dev = self.device
        queries_rp = pad_rows_pow2(torch.as_tensor(queries_r, device=dev),
                                   cfg.query_block).contiguous()
        delta_pts_p, delta_gids = mut.padded_delta(perm, n_base)
        k_delta = min(kq, delta_pts_p.shape[0])
        excl_p = np.full((qb,), -2, np.int32)
        excl_p[:n_q] = excl
        excl_t = torch.as_tensor(excl_p, device=dev)
        dargs = (queries_rp, torch.as_tensor(delta_pts_p, device=dev), excl_t,
                 torch.as_tensor(delta_gids, device=dev))
        dkw = dict(k=k_delta, metric=met_lib.kernel_metric(cfg.metric))
        run_engine(self, "delta", dargs, dkw)
        dd, di = mut_lib.delta_topk(*dargs, **dkw)
        # Shard distances are FINALIZED while the delta engine returns raw
        # scores: bring the delta block into the merged space before folding
        # (finalize is monotone per metric).
        dd = torch.as_tensor(met_lib.finalize(dd.cpu().numpy(), cfg.metric), device=dev)
        fargs = (md, mi, dd, di, torch.as_tensor(mut.tombstone_table(), device=dev), excl_t)
        fkw = dict(k=kq)
        run_engine(self, "merge", fargs, fkw)
        fd, fi = mut_lib.fold_topk(*fargs, **fkw)
        fd, fi = fd[:n_q].cpu().numpy(), fi[:n_q].cpu().numpy()
        t_delta = time.perf_counter() - t0

        stats = self._stats(gen, shard_stats, t_merge, compiles_before, t_delta=t_delta,
                            serve=serve, skipped=skipped)
        return hybrid_lib.KNNResult(
            dists=fd, ids=fi, source=np.max(sources, axis=0), stats=stats,
            coverage=self._coverage(n_q, serve, skipped),
            recall_estimate=min(ests) if ests else 1.0)

    def _shard_serve(self, gen: _ShardedGeneration, k_out: int, k_eff: int, n_q: int,
                     queries_r: np.ndarray, excl: np.ndarray, shard_net_cells=None,
                     serve_shards: Optional[Tuple[int, ...]] = None):
        """Per-shard hybrid serves + the collective top-K merge: shard p
        answers k_eff candidates over its sub-cloud (equal shapes ⇒ shards
        1..P−1 ride shard 0's engine buckets), its local ids map to global
        ones, and its result tensors are stacked on slot 0's device over the
        query-shape bucket — (inf, −1) for rows past |Q| and for a shard that
        contributed nothing.  The merge reduces the P blocks to k_out.
        Returns the merged (qb, k_out) tensors (finalized distances),
        per-shard sources / stats, the merge time and the serve record
        (fault accounting; None without a fault policy).

        With a ``ServingSupervisor`` active every sub-query runs through its
        retry / hedge loop; a shard no replica could serve keeps the
        (inf, −1) baseline and is reported in ``serve["shards_lost"]``."""
        cfg = self.config
        dev = self.device
        sup = self.supervisor
        rho_over = self._rho_override()
        step = self._serve_step
        self._serve_step += 1
        qb = pow2_bucket(n_q, cfg.query_block)
        dpad = torch.full((self.n_shards, qb, k_eff), float("inf"), device=dev)
        ipad = torch.full((self.n_shards, qb, k_eff), -1, dtype=torch.int32, device=dev)
        sources = np.zeros((self.n_shards, n_q), np.int32)
        shard_stats = []
        estimates = []
        serve = None if sup is None else {
            "n_hedged": 0, "n_hedge_wins": 0, "n_subquery_retries": 0,
            "n_subquery_failures": 0, "shards_lost": [], "t_effective": 0.0,
        }
        lane_times: Dict[int, float] = {}
        if serve_shards is not None:
            want = set(int(p) for p in serve_shards)
            if not want or not want <= set(range(self.n_shards)):
                raise ValueError(
                    f"_serve_shards={serve_shards!r}: need a non-empty subset of shard ids "
                    f"0..{self.n_shards - 1}")
        skipped = [] if serve_shards is None else sorted(set(range(self.n_shards)) - want)

        def take(p, res):
            dpad[p, :n_q] = torch.as_tensor(res.dists, device=dev)
            li = torch.as_tensor(res.ids, device=dev)
            gid = gen.gids_dev[p]
            ipad[p, :n_q] = torch.where(li >= 0, gid[li.clamp(min=0).long()],
                                        torch.full_like(li, -1))
            sources[p] = res.source
            shard_stats.append(res.stats)
            estimates.append(res.recall_estimate)

        for p, shard in enumerate(gen.shards):
            if p in skipped:
                continue            # deliberate partial serve: the baseline stays
            nc = None if shard_net_cells is None else shard_net_cells[p]
            if sup is None:
                take(p, shard.query(queries_r, k=k_eff, _net_cells=nc, _rho=rho_over))
                continue

            def attempt(replica, p=p, shard=shard, nc=nc):
                extra = self._faults.subquery(replica, p, step)
                t0 = time.perf_counter()
                res = shard.query(queries_r, k=k_eff, _net_cells=nc, _rho=rho_over)
                return res, time.perf_counter() - t0 + extra

            out = sup.run_subquery(p, step, attempt)
            serve["n_hedged"] += int(out.hedged)
            serve["n_hedge_wins"] += int(out.hedge_won)
            serve["n_subquery_retries"] += out.retries
            serve["n_subquery_failures"] += out.failures
            lane_times.update(out.times)
            if not out.served:
                serve["shards_lost"].append(p)
                continue
            serve["t_effective"] += out.t_effective
            take(p, out.result)

        if sup is not None:
            sup.observe(lane_times)
        if shard_stats:
            self._note_engine_times(float(np.mean([s.t1_per_query for s in shard_stats])),
                                    float(np.mean([s.t2_per_query for s in shard_stats])))

        epad = np.full((qb,), -2, np.int32)
        epad[:n_q] = excl
        _sync(dev)
        t0 = time.perf_counter()
        md, mi = self._merge(k_out, dpad, ipad, torch.as_tensor(epad, device=dev), gen.n_pad)
        _sync(dev)
        t_merge = time.perf_counter() - t0
        return md, mi, sources, shard_stats, t_merge, serve, tuple(skipped), estimates

    def _coverage(self, n_q: int, serve, skipped: Tuple[int, ...] = ()) -> Optional[np.ndarray]:
        """The degraded-result contract: (|Q|, n_shards) bool, column s False
        iff shard s contributed nothing — every replica failed it
        (``shards_lost``) or the caller skipped it (``_serve_shards``).  None
        when no fault policy is active and nothing was skipped."""
        if serve is None and not skipped:
            return None
        cov = np.ones((n_q, self.n_shards), bool)
        for p in (serve["shards_lost"] if serve is not None else ()):
            cov[:, p] = False
        for p in skipped:
            cov[:, p] = False
        return cov

    def _stats(self, gen: _ShardedGeneration, shard_stats, t_merge: float,
               compiles_before: int, t_delta: float = 0.0, serve=None,
               skipped: Tuple[int, ...] = ()):
        if not shard_stats:
            # Every shard lost or skipped: no engine ran; report the serve
            # accounting so the caller still sees an honest record.
            serve_kw = {} if serve is None else dict(
                n_hedged=serve["n_hedged"], n_hedge_wins=serve["n_hedge_wins"],
                n_subquery_retries=serve["n_subquery_retries"],
                n_subquery_failures=serve["n_subquery_failures"],
                shards_lost=tuple(serve["shards_lost"]))
            return hybrid_lib.JoinStats(
                epsilon=gen.eps, epsilon_beta=gen.eps_beta, t_merge=t_merge, t_delta=t_delta,
                t_wall=t_merge + t_delta,
                n_engine_compiles=self.total_compiles - compiles_before,
                shards_skipped=skipped, t_effective=t_merge + t_delta, **serve_kw)
        t1 = float(np.mean([s.t1_per_query for s in shard_stats]))
        t2 = float(np.mean([s.t2_per_query for s in shard_stats]))
        t_wall = sum(s.t_wall for s in shard_stats) + t_merge + t_delta
        if serve is None:
            serve_kw = dict(t_effective=t_wall, shards_skipped=skipped)
        else:
            serve_kw = dict(
                n_hedged=serve["n_hedged"], n_hedge_wins=serve["n_hedge_wins"],
                n_subquery_retries=serve["n_subquery_retries"],
                n_subquery_failures=serve["n_subquery_failures"],
                shards_lost=tuple(serve["shards_lost"]), shards_skipped=skipped,
                t_effective=serve["t_effective"] + t_merge + t_delta)
        return hybrid_lib.JoinStats(
            epsilon=gen.eps, epsilon_beta=gen.eps_beta,
            # Engine-assignment counts sum over shards (each shard classifies
            # the full batch against ITS grid): totals are P·|Q|.
            n_dense=sum(s.n_dense for s in shard_stats),
            n_sparse=sum(s.n_sparse for s in shard_stats),
            n_failed=sum(s.n_failed for s in shard_stats),
            n_uncertified=sum(s.n_uncertified for s in shard_stats),
            n_thresh=shard_stats[0].n_thresh,
            t_dense=sum(s.t_dense for s in shard_stats),
            t_sparse=sum(s.t_sparse for s in shard_stats),
            t_brute=sum(s.t_brute for s in shard_stats),
            t_delta=t_delta, t_wall=t_wall, t_merge=t_merge,
            t1_per_query=t1, t2_per_query=t2, rho_model=split_lib.rho_model(t1, t2),
            n_batches=sum(s.n_batches for s in shard_stats),
            batch_sizes=[b for s in shard_stats for b in s.batch_sizes],
            t_dense_batches=[t for s in shard_stats for t in s.t_dense_batches],
            n_rebalanced=sum(s.n_rebalanced for s in shard_stats),
            n_sparse_rounds=sum(s.n_sparse_rounds for s in shard_stats),
            n_sparse_engine_total=sum(s.n_sparse_engine_total for s in shard_stats),
            rho_online=float(np.mean([s.rho_online for s in shard_stats])),
            n_engine_compiles=self.total_compiles - compiles_before,
            **serve_kw,
        )
