"""Serving meshes — port of ``repro/launch/mesh.py``.

The JAX package is single-controller: one process drives every device of a
``jax.sharding.Mesh`` and ``shard_map`` runs a local body once per device.
The port keeps that shape with one process driving P logical *slots*: a
``Mesh`` here is a grid of named axes whose every slot names the
``torch.device`` that holds that slot's tensors, and the collectives of
``core/distributed.py`` are plain tensor operations over the slots' tensors.
No ``torch.distributed`` process group is involved.

Slot (r, s) of an (r × n) mesh lives on card ``(r·n + s) mod
torch.cuda.device_count()``, so on a machine with one card every slot is
``cuda:0``; ``device="cpu"`` puts every slot on the CPU (tests).

``make_production_mesh`` gives the reference's 256-slot (16, 16) and
512-slot (2, 16, 16) meshes.  The mesh constructors also take
``device="meta"``: every slot then holds tensors without storage, which is
how the dry run (``launch/dryrun.py``) traces a step for a pod's worth of
slots on one host.  Only these constructors accept ``"meta"``; every entry
point that computes resolves its device through ``utils.resolve_device``,
which refuses it.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over logical slots, each slot pinned to a device.

    ``shape`` is the ordered name → size mapping of ``jax.sharding.Mesh``;
    ``devices`` the numpy object array of ``torch.device`` of that shape."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    slot_devices: Tuple[str, ...]       # row-major, one per slot

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.sizes)} sizes")
        if int(np.prod(self.sizes)) != len(self.slot_devices):
            raise ValueError(f"mesh of shape {self.sizes} needs {int(np.prod(self.sizes))} "
                             f"slot devices, got {len(self.slot_devices)}")

    @property
    def shape(self) -> "OrderedDict[str, int]":
        return OrderedDict(zip(self.axis_names, self.sizes))

    @property
    def devices(self) -> np.ndarray:
        out = np.empty(len(self.slot_devices), dtype=object)
        out[:] = [torch.device(d) for d in self.slot_devices]
        return out.reshape(self.sizes)


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a ``TypeError`` naming what was passed instead."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh (see "
                        f"make_serving_mesh), got {type(mesh).__name__}")
    return mesh


def _card_count(dev: torch.device) -> int:
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def _mesh_device(device) -> torch.device:
    """``resolve_device``, and ``"meta"`` for the dry run's slots."""
    return torch.device("meta") if str(device) == "meta" else resolve_device(device)


def _slots(dev: torch.device, n_slots: int) -> Tuple[str, ...]:
    if dev.type in ("cpu", "meta"):
        return (dev.type,) * n_slots
    count = _card_count(dev)
    return tuple(f"cuda:{i % count}" for i in range(n_slots))


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's pod meshes: (16, 16) ``("data", "model")``, or with
    ``multi_pod`` (2, 16, 16) ``("pod", "data", "model")``, as logical
    slots wrapped onto ``device``'s cards (``"meta"`` for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape, _slots(_mesh_device(device), int(np.prod(shape))))


def make_host_mesh(model: int = 1, *, device="cuda", slots=None) -> Mesh:
    """A ("data", "model") mesh of ``(slots // model, model)``.

    ``slots=None`` takes one slot per device that exists (the cards of this
    host, or one CPU slot), as the reference takes ``jax.devices()``.  An
    explicit ``slots`` stands in for the JAX tests'
    ``--xla_force_host_platform_device_count``: the slots wrap onto the
    cards as ``make_serving_mesh``'s do, so ``make_host_mesh(4, slots=8)``
    on one card is a 2 × 4 mesh of eight ``cuda:0`` slots."""
    dev = _mesh_device(device)
    n = _card_count(dev) if slots is None else int(slots)
    data = n // model
    if data < 1 or (slots is not None and n % model):
        raise ValueError(f"model={model} does not divide {n} slots into a data axis")
    return Mesh(("data", "model"), (data, model), _slots(dev, data * model))


def make_serving_mesh(n_shards=None, axis: str = "shard", replicas: int = 1, *,
                      device="cuda") -> Mesh:
    """Mesh for the sharded ``KNNIndex`` (DESIGN.md §5/§7).

    ``replicas == 1`` gives the 1-D shape ``(n_shards,)`` along ``axis``;
    ``replicas > 1`` the 2-D ``(replicas, n_shards)`` serving mesh with axes
    ``("replica", axis)``: index state is sharded along ``axis`` and
    replicated along ``"replica"``.  ``n_shards=None`` means one shard per
    card (per replica group).

    One departure from the JAX function: an explicit ``n_shards`` above the
    card count puts several slots on one card instead of raising — a
    one-card machine has no other way to hold a 2 × 2 mesh, and the JAX
    tests' fake CPU devices play the same part."""
    dev = resolve_device(device)
    r = int(replicas)
    if r < 1:
        raise ValueError(f"replicas must be >= 1, got {r}")
    n = (_card_count(dev) // r) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"serving mesh wants {r}x{n} slots: n_shards must be >= 1 "
                         f"({_card_count(dev)} devices for {r} replica groups)")
    if r == 1:
        return Mesh((axis,), (n,), _slots(dev, n))
    return Mesh(("replica", axis), (r, n), _slots(dev, r * n))


def mesh_chip_count(mesh: Mesh) -> int:
    return int(np.prod(list(mesh.shape.values())))
