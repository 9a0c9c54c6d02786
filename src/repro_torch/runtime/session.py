"""Persistent join sessions: index ownership and engine-bucket accounting,
in PyTorch (port of ``repro/runtime/session.py``).

Each ``join(points)`` builds — or reuses, when the same array object is
joined again with an unchanged ε argument — a ``KNNIndex`` and runs the
self-join as ``index.query(exclude_self=True)``.  ``compile_counts`` is
shared with every index the session builds.  Callers must not mutate a
joined array in place (reuse is keyed on object identity).

Placement (DESIGN.md §5): a session constructed with ``mesh=`` owns
sharded indexes instead — ``index_for`` / ``join`` build a
``ShardedKNNIndex`` over the mesh, with the same shared counters; the
collective merge's buckets count under the ``"merge"`` kind."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

import repro_torch.core.hybrid as hybrid_lib
from repro_torch.core import dense_join as dense_lib
from repro_torch.runtime.knn_index import KNNIndex
from repro_torch.launch.mesh import check_mesh
from repro_torch.utils import resolve_device


class JoinSession:
    """Reusable entry point for the hybrid KNN self-join.

    >>> session = JoinSession(HybridConfig(k=5), device="cuda")
    >>> r1 = session.join(points)          # first join: new engine buckets
    >>> r2 = session.join(points2)         # same shapes: zero new buckets
    """

    def __init__(self, config: "hybrid_lib.HybridConfig", *, device="cuda",
                 mesh=None, mesh_axis=None, merge: str = "auto"):
        self.config = config
        # Placement: with a mesh the session serves sharded indexes on the
        # mesh's slot devices (KNNIndex.build dispatches on mesh=).
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.mesh_axis = mesh_axis
        self.merge = merge
        self.device = (resolve_device(device) if mesh is None
                       else torch.device(self.mesh.devices.flat[0]))
        self.backend = dense_lib.resolve_backend(config.backend, self.device)
        self.compile_counts: Dict[str, int] = {"dense": 0, "sparse": 0, "brute": 0}
        if mesh is not None:
            self.compile_counts["merge"] = 0
        self._index: Optional[KNNIndex] = None
        self._index_eps_arg: Optional[float] = None

    @property
    def total_compiles(self) -> int:
        return sum(self.compile_counts.values())

    def index_for(self, points, epsilon: Optional[float] = None) -> KNNIndex:
        """The session's ``KNNIndex`` for this point cloud — the serving
        entry point for foreign (R≠S) queries."""
        return self._get_index(points, epsilon)[0]

    def _get_index(self, points, epsilon: Optional[float]) -> Tuple[KNNIndex, bool]:
        idx = self._index
        # A mutated index no longer answers for the corpus it was built
        # from: pending inserts/deletes make its net corpus differ, so
        # rebuild rather than reuse.
        if (idx is not None and idx.points is points and self._index_eps_arg == epsilon
                and idx.is_clean):
            return idx, False
        idx = KNNIndex.build(points, self.config, epsilon, device=self.device,
                             backend=self.backend, compile_counts=self.compile_counts,
                             mesh=self.mesh, mesh_axis=self.mesh_axis, merge=self.merge)
        self._index = idx
        self._index_eps_arg = epsilon
        return idx, True

    def join(self, points, epsilon: Optional[float] = None) -> "hybrid_lib.KNNResult":
        """Algorithm 1 through the work queue: the self-join special case
        of ``KNNIndex.query``."""
        index, fresh = self._get_index(points, epsilon)
        result = index.query(exclude_self=True)
        if fresh:
            result.stats.t_select_eps = index.t_select_eps
            result.stats.t_build = index.t_build
        return result
