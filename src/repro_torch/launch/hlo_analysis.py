"""Collective bytes, per-slot memory and roofline terms of a traced cell —
the port's counterpart of ``repro/launch/hlo_analysis.py``.

The port has no HLO.  The reference parses the optimized HLO text of a
compiled cell for its collectives; the port's slot program
(``models/spmd.py``) records its own while ``launch/dryrun.py`` traces a
cell on ``meta`` slots (``spmd.record_collectives``).  Each collective
records the kind it stands for in the reference's terms and its per-slot
operand bytes by ``_line_collective_bytes``'s rules (an all-gather's
operand is the slot's own block, a reduce-scatter's the whole gathered
gradient, an all-reduce's its whole operand).  One more key,
``"broadcast"``, holds the copies of a data group's residual stream to its
model slots (and the gradient handed back to each part of a row-parallel
sum): GSPMD keeps an activation where the next op wants it, so the
reference has no such transfer, but the slot program makes it, and it
counts in ``"total"``.  The figures are those of the busiest slot (the most
bytes in all).

``memory_analysis_dict`` gives the per-slot argument and output bytes from
the placement itself.  No temp figure is given: a trace on ``meta`` tensors
allocates nothing, so it cannot say what a slot's program holds at its
peak.

Hardware model — one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
    989 TFLOP/s bf16  ·  3.35 TB/s HBM3  ·  450 GB/s each way over NVLink
    in all (900 GB/s bidirectional), shared by the host's other cards
    through NVSwitch, so the collective term counts one such port
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.spmd import BROADCAST, KINDS, CollectiveRecord
from repro_torch.utils import tree_leaves

PEAK_FLOPS = 989e12        # bf16 dense, per card
HBM_BW = 3.35e12           # bytes/s per card
LINK_BW = 450e9            # bytes/s each way, a card's NVLink in all


def _busiest(per_kind: Dict[str, np.ndarray]) -> int:
    total = sum(per_kind[k] for k in KINDS + (BROADCAST,))
    return int(np.argmax(total))


def _per_slot(per_kind: Dict[str, np.ndarray], slot: int, total: bool) -> Dict[str, int]:
    out = {k: int(per_kind[k][slot]) for k in KINDS + (BROADCAST,)}
    if total:
        out["total"] = sum(out.values())
    return out


def collective_bytes(record: CollectiveRecord) -> Dict[str, int]:
    """Operand bytes per collective kind on the busiest slot, a scanned
    layer group's body counted once (the reference's ``collective_bytes``
    counts each HLO instruction once)."""
    return _per_slot(record.bytes_once, _busiest(record.bytes_once), True)


def collective_counts(record: CollectiveRecord) -> Dict[str, int]:
    """Collectives per kind on the busiest slot, a scan body counted once."""
    return _per_slot(record.counts_once, _busiest(record.bytes_once), False)


def collective_bytes_weighted(record: CollectiveRecord) -> Dict[str, int]:
    """Operand bytes per kind on the busiest slot over every execution (every
    layer): the number the roofline's collective term uses."""
    return _per_slot(record.bytes, _busiest(record.bytes), True)


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one traced (arch × shape × mesh) cell."""
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    links_per_chip: float = 1.0       # NVLink through NVSwitch: one port's rate to all

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / (LINK_BW * self.links_per_chip)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def slot_bytes(specs, shardings) -> int:
    """Bytes one slot holds of a tree of ``meta`` specs placed by the
    matching ``NamedSharding`` tree: every slot holds one block of each
    leaf, the leaf's shape over its shard factor."""
    total = 0
    for x, sh in zip(tree_leaves(specs), tree_leaves(shardings)):
        total += int(np.prod(sh.shard_shape(tuple(x.shape)))) * x.element_size()
    return total


def memory_analysis_dict(arg_bytes: int, out_bytes: int) -> dict:
    """Per-slot ``argument_size_in_bytes`` (``slot_bytes`` of the cell's
    inputs) and ``output_size_in_bytes`` (the largest over slots of the traced
    outputs' blocks)."""
    return {"argument_size_in_bytes": int(arg_bytes), "output_size_in_bytes": int(out_bytes)}


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N·D for inference
    (N = active params, D = processed tokens)."""
    n_active = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch            # decode: one token per sequence
    return 2.0 * n_active * tokens
