"""Logical-axis → mesh-axis resolution and placement on a slot mesh — port
of ``repro/sharding.py``.

Every parameter of ``models/`` has a tuple of *logical* names per dim
(``layers.*_table``, ``transformer.param_specs``).  This module maps those
names onto a mesh, with the reference's table, its two passes (weight dims
first, then ``act_`` dims), its ``_FALLBACK_TO_MODEL`` pass and its
one-use-per-mesh-axis rule:

  * TP  : "heads"/"mlp"/"vocab"/"experts"/"rnn" -> "model"
  * FSDP: "embed" -> "data" when ``cfg.fsdp``
  * DP  : activation batch dim -> ("pod", "data")

Resolution is divisibility-checked per tensor: a logical dim that does not
divide its mesh axis replicates (GQA kv_heads=8 on model=16; qwen3's 40
heads on 16).

The JAX package hands the resolved ``PartitionSpec`` to GSPMD.  The port's
mesh (``launch/mesh.py``) is one process driving P logical slots, so it
keeps the placement itself: ``NamedSharding(mesh, spec)`` cuts a global
tensor into each slot's block (``place``) and joins blocks back
(``gather``, ``local_view``), and a ``SlotArray`` holds one block per slot —
replicas along the axes a spec leaves unused are real copies, so a slot
holds the bytes GSPMD's ``in_shardings`` put on that device.  The sharded
train and serving steps (``models/spmd.py``, ``launch/steps.py``) run on
such arrays, on the card's slots, CPU slots or ``meta`` slots alike.

Activations are not placed.  ``ShardingCtx.constrain`` returns its
argument, as a sharding constraint never changes values: the port keeps
the residual stream replicated across the model axis (no sequence
sharding for ``act_seq``), so its activation bytes per slot differ from
GSPMD's; the batch dim is split over the data axes by the step itself.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, check_mesh

AxisEntry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One mesh-axis entry per dim (``None``, an axis name, or a tuple of
    names).  Equal as tuples, as ``jax.sharding.PartitionSpec`` compares:
    ``P(None, None) != P()``."""

    def __new__(cls, *parts: AxisEntry):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"



def _names(entry: AxisEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def data_axis_names(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch (DP): ("pod","data") or ("data",)."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def axis_size(mesh, entry: AxisEntry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    return int(np.prod([mesh.shape[a] for a in entry]))


def logical_rules(mesh, *, fsdp: bool = False, seq_shard: bool = True) -> Dict[str, AxisEntry]:
    """Primary logical-name -> mesh-axis table."""
    model = "model" if "model" in mesh.shape else None
    data = data_axis_names(mesh) or None
    fsdp_ax = "data" if (fsdp and "data" in mesh.shape) else None
    return {
        # ---- parameters -------------------------------------------------
        "embed": fsdp_ax,          # FSDP shards the embed dim of every weight
        "vocab": model,
        "heads": model,
        "kv_heads": model,
        "head_dim": None,
        "mlp": model,
        "experts": model,          # EP
        "expert_mlp": None,
        "rnn": model,
        "rnn_heads": model,
        "conv": None,
        "layers": None,            # scan-stacked leading dim
        # ---- activations -------------------------------------------------
        "act_batch": data,
        "act_seq": model if seq_shard else None,   # SP (residual stream)
        "act_embed": None,
        "act_heads": model,
        "act_kv_seq": model,       # decode KV cache sequence dim
        "act_vocab": model,
        "act_experts": model,
        None: None,
    }


# Second-chance mapping: if a tensor got no "model" shard in the first pass
# (e.g. an odd vocab), these dims may take it instead.  head_dim is
# deliberately not here: sharding K/V projections by head_dim while Q shards
# by heads mismatches the attention contraction.
_FALLBACK_TO_MODEL = ("expert_mlp", "mlp", "rnn")


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Dict[str, AxisEntry], mesh) -> PartitionSpec:
    """Map per-dim logical names to a PartitionSpec, enforcing divisibility
    and one-use-per-mesh-axis.  Reads only ``mesh.shape``."""
    if len(axes) != len(shape):
        raise ValueError(f"spec {axes} does not match shape {shape}")
    parts: List[AxisEntry] = [None] * len(shape)
    used: set = set()

    def try_assign(i: int, entry: AxisEntry) -> bool:
        names = _names(entry)
        if not names or any(a in used for a in names):
            return False
        size = axis_size(mesh, entry)
        if size <= 1 or shape[i] % size != 0:
            return False
        parts[i] = entry if len(names) > 1 else names[0]
        used.update(names)
        return True

    # Weight-style dims first, activation dims second — e.g. a KV cache
    # (B, T, kv_heads, hd) shards kv_heads over "model" when divisible and
    # only falls back to sequence sharding when not.
    for i, name in enumerate(axes):
        if name is not None and not str(name).startswith("act_"):
            try_assign(i, rules.get(name))
    for i, name in enumerate(axes):
        if parts[i] is None and name is not None and str(name).startswith("act_"):
            try_assign(i, rules.get(name))

    # Fallback pass: claim the model axis through an alternate dim if the
    # primary assignment failed to use it anywhere on this tensor.
    if "model" in mesh.shape and "model" not in used:
        for i, name in enumerate(axes):
            if parts[i] is None and name in _FALLBACK_TO_MODEL:
                if try_assign(i, "model"):
                    break
    return PartitionSpec(*parts)


def _map_specs(params: Any, specs: Any, fn):
    """Recurse matching (params, specs) trees; specs leaves are tuples."""
    if isinstance(params, dict):
        return {k: _map_specs(params[k], specs[k], fn) for k in params}
    if isinstance(params, list):
        return [_map_specs(p, s, fn) for p, s in zip(params, specs)]
    return fn(params, specs)


# --------------------------------------------------------------------------
# placement on the slots
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a slot mesh: which block of a global tensor
    each slot holds.  Slots are numbered row-major over ``mesh.axis_names``;
    a dim whose entry names several axes is split with the first one major,
    as JAX splits it."""

    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        check_mesh(self.mesh)
        for entry in self.spec:
            for a in _names(entry):
                if a not in self.mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, not one of the "
                                     f"mesh's {self.mesh.axis_names}")

    @property
    def n_slots(self) -> int:
        return len(self.mesh.slot_devices)

    @property
    def shard_factor(self) -> int:
        """How many distinct blocks a tensor is cut into."""
        return int(np.prod([axis_size(self.mesh, e) for e in self.spec]))

    def _entries(self, ndim: int) -> Tuple[Tuple[str, ...], ...]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than a {ndim}-d tensor")
        return tuple(_names(e) for e in self.spec) + ((),) * (ndim - len(self.spec))

    def coords(self, slot: int) -> Dict[str, int]:
        idx = np.unravel_index(slot, self.mesh.sizes)
        return dict(zip(self.mesh.axis_names, (int(i) for i in idx)))

    def slot_of(self, coords: Dict[str, int]) -> int:
        return int(np.ravel_multi_index([coords[a] for a in self.mesh.axis_names],
                                        self.mesh.sizes))

    def device(self, slot: int) -> torch.device:
        return torch.device(self.mesh.slot_devices[slot])

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        out = []
        for n, names in zip(global_shape, self._entries(len(global_shape))):
            size = int(np.prod([self.mesh.shape[a] for a in names])) if names else 1
            if n % size:
                raise ValueError(f"dim of size {n} does not divide over {names} ({size})")
            out.append(n // size)
        return tuple(out)

    def block_index(self, slot: int, ndim: int) -> Tuple[int, ...]:
        """Per dim, which of its shards ``slot`` holds."""
        c = self.coords(slot)
        out = []
        for names in self._entries(ndim):
            i = 0
            for a in names:
                i = i * self.mesh.shape[a] + c[a]
            out.append(i)
        return tuple(out)

    def slices(self, slot: int, global_shape: Sequence[int]) -> Tuple[slice, ...]:
        """The index of ``slot``'s block in the global tensor."""
        local = self.shard_shape(global_shape)
        return tuple(slice(i * n, (i + 1) * n)
                     for i, n in zip(self.block_index(slot, len(global_shape)), local))

    def replica_groups(self, ndim: int) -> List[List[int]]:
        """The slots holding each distinct block, the groups in block order."""
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for s in range(self.n_slots):
            groups.setdefault(self.block_index(s, ndim), []).append(s)
        return [groups[k] for k in sorted(groups)]

    def place(self, x) -> "SlotArray":
        """Each slot's block of the global ``x`` (a tensor or numpy array),
        copied onto that slot's device."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        blocks = [t[self.slices(s, t.shape)].to(self.device(s), copy=True,
                                                memory_format=torch.contiguous_format)
                  for s in range(self.n_slots)]
        return SlotArray(self, tuple(t.shape), blocks)

    def local_view(self, blocks: Sequence[torch.Tensor], slot: int, keep: Sequence[str] = (),
                   device=None) -> torch.Tensor:
        """The tensor ``slot`` sees once the axes not in ``keep`` are
        gathered: the blocks of the slots that differ from it only along
        those axes, joined in order on ``device`` (``slot``'s by default).
        ``keep=()`` gives the global tensor; ``keep=("model",)`` the FSDP
        gather of a weight over the data axes.  Differentiable: its
        gradient reaches each block it read."""
        dev = self.device(slot) if device is None else torch.device(device)
        entries = self._entries(blocks[slot].dim())
        dims = []
        for i, names in enumerate(entries):
            gather = [a for a in names if a not in keep]
            if gather and len(gather) != len(names):
                raise ValueError(f"dim {i} of {self.spec} mixes kept and gathered axes")
            if gather:
                dims.append((i, names))
        base = self.coords(slot)

        def build(c, k):
            if k == len(dims):
                return blocks[self.slot_of(c)].to(dev)
            i, names = dims[k]
            parts = [build({**c, **dict(zip(names, idx))}, k + 1)
                     for idx in itertools.product(*(range(self.mesh.shape[a]) for a in names))]
            return torch.cat(parts, dim=i)

        return build(base, 0)


@dataclasses.dataclass
class SlotArray:
    """A global tensor of ``shape`` placed by ``sharding``: ``blocks[s]`` is
    slot s's block, on slot s's device — the counterpart of a ``jax.Array``
    with a ``NamedSharding``."""

    sharding: NamedSharding
    shape: Tuple[int, ...]
    blocks: List[torch.Tensor]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @torch.no_grad()
    def gather(self, device=None) -> torch.Tensor:
        """The global tensor (a new one, outside autograd), on ``device``
        (slot 0's by default)."""
        return self.sharding.local_view(self.blocks, 0, keep=(), device=device).clone()

    def slot_nbytes(self, slot: int) -> int:
        b = self.blocks[slot]
        return b.numel() * b.element_size()


# --------------------------------------------------------------------------
# context carried through the model and step code
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingCtx:
    """Carried through model code; ``mesh=None`` is the single-device
    context."""
    mesh: Optional[Mesh]
    rules: Dict[str, AxisEntry]

    @classmethod
    def for_mesh(cls, mesh, *, fsdp: bool = False, seq_shard: bool = True) -> "ShardingCtx":
        if mesh is None:
            return cls(None, {})
        return cls(check_mesh(mesh), logical_rules(mesh, fsdp=fsdp, seq_shard=seq_shard))

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> PartitionSpec:
        if self.mesh is None:
            return PartitionSpec()
        return resolve_spec(axes, shape, self.rules, self.mesh)

    def constrain(self, x, *axes: Optional[str]):
        """A sharding constraint by logical dim names: the value unchanged
        (the port keeps activations replicated across the model axis)."""
        return x

    def named(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> NamedSharding:
        assert self.mesh is not None
        return NamedSharding(self.mesh, self.spec(axes, shape))

    def param_shardings(self, params: Any, specs: Any):
        """NamedSharding tree for a (params, specs) pair (tensors, ``meta``
        tensors or ``SlotArray``s — only ``.shape`` is read)."""
        assert self.mesh is not None
        return _map_specs(params, specs, lambda p, s: self.named(s, tuple(p.shape)))

    def batch_sharding(self, ndim: int = 2) -> NamedSharding:
        """Sharding for (batch, seq, ...) token arrays."""
        assert self.mesh is not None
        axes = ["act_batch"] + [None] * (ndim - 1)
        return NamedSharding(self.mesh, PartitionSpec(*(self.rules.get(a) for a in axes)))


def null_ctx() -> ShardingCtx:
    return ShardingCtx(None, {})
