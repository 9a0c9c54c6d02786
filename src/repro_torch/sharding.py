"""Sharding context of the model code — the part of ``repro/sharding.py``
the serving path and the one-device trainer use.

The JAX package maps logical axis names onto a device mesh and pins
activations with ``with_sharding_constraint``.  The port's models run on
one device (the kNN-LM's datastore is what a mesh shards, through
``launch.mesh``), so ``ShardingCtx`` only carries its mesh: ``constrain``
returns its argument, as a sharding constraint never changes values.  The
logical-axis rules, ``spec``, ``named``, ``param_shardings`` and
``batch_sharding`` place the sharded train step's state and batches on a
mesh and come with it, ROADMAP queue A item 18.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import check_mesh
from repro_torch.utils import unported


def data_axis_names(mesh):
    raise unported("sharding.data_axis_names", "queue A item 18")


def axis_size(mesh, entry):
    raise unported("sharding.axis_size", "queue A item 18")


def logical_rules(mesh, *, fsdp: bool = False, seq_shard: bool = True):
    raise unported("sharding.logical_rules", "queue A item 18")


def resolve_spec(axes, shape, rules, mesh):
    raise unported("sharding.resolve_spec", "queue A item 18")


@dataclasses.dataclass
class ShardingCtx:
    """Carried through model code; ``mesh=None`` is the single-device
    context."""
    mesh: Optional[object]
    rules: Dict[str, object]

    @classmethod
    def for_mesh(cls, mesh, *, fsdp: bool = False, seq_shard: bool = True) -> "ShardingCtx":
        """A context over the port's ``launch.mesh.Mesh`` (or ``None``).
        The logical rules are not ported, so ``rules`` stays empty."""
        if mesh is None:
            return cls(None, {})
        return cls(check_mesh(mesh), {})

    def constrain(self, x, *axes: Optional[str]):
        """A sharding constraint by logical dim names: the value unchanged."""
        return x

    def spec(self, axes, shape):
        raise unported("ShardingCtx.spec (logical-axis sharding rules)", "queue A item 18")

    def named(self, axes, shape):
        raise unported("ShardingCtx.named", "queue A item 18")

    def param_shardings(self, params, specs):
        raise unported("ShardingCtx.param_shardings", "queue A item 18")

    def batch_sharding(self, ndim: int = 2):
        raise unported("ShardingCtx.batch_sharding", "queue A item 18")


def null_ctx() -> ShardingCtx:
    return ShardingCtx(None, {})
