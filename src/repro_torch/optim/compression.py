"""Int8 error-feedback gradient compression for the data-parallel mean —
port of ``repro/optim/compression.py``.

Quantizing a gradient to int8 with a per-tensor scale cuts the bytes a
gradient mean moves 4× against float32; the quantization error is kept in
a per-slot *residual* and added back before the next quantization (error
feedback), so the long-run sum of applied updates equals the sum of the
true gradients.  ``quantize`` / ``ef_quantize`` give the reference's bits
(``torch.round`` and ``jnp.round`` both round half to even).

The reference's ``compressed_grad_mean`` runs inside ``shard_map``: each
device quantizes its gradient and all-gathers the int8 payload and the
scales.  Here one process drives the logical data slots, as in
``core/distributed.py``: the gradient trees of every slot come in as a
list, each is quantized on its own slot's device, and only the int8
payload and the scales cross to slot 0's device, where the mean is
formed.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch

from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

_Q = 127.0


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q int8, scale f32)."""
    g32 = g.float()
    scale = torch.amax(torch.abs(g32)) / _Q
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -_Q, _Q).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_quantize(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback quantize: q(g + r); r' = (g + r) − deq(q)."""
    corrected = g.float() + residual
    q, scale = quantize(corrected)
    new_residual = corrected - dequantize(q, scale)
    return q, scale, new_residual


def init_residuals(grads) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_grad_mean(grads: Sequence[Any], residuals: Sequence[Any]) -> Tuple[Any, List[Any]]:
    """The mean over the data slots of ``grads`` (one gradient tree per
    slot, on that slot's device) with int8 on the wire.

    Returns (the mean tree on slot 0's device, in each gradient's dtype;
    the list of each slot's new residual tree, on its own device)."""
    if len(grads) != len(residuals) or not grads:
        raise ValueError(f"{len(grads)} gradient trees for {len(residuals)} residual trees")
    n = len(grads)
    home = tree_leaves(grads[0])[0].device
    wire, new_res = [], []           # wire[p]: slot p's (q, scale) per leaf, on slot 0's device
    for g_tree, r_tree in zip(grads, residuals):
        out = [ef_quantize(g, r) for g, r in zip(tree_leaves(g_tree), tree_leaves(r_tree))]
        wire.append([(q.to(home), scale.to(home)) for q, scale, _ in out])
        new_res.append(tree_unflatten(r_tree, [r for _, _, r in out]))
    means = []
    for i, g in enumerate(tree_leaves(grads[0])):
        q_all = torch.stack([w[i][0] for w in wire])               # (n, *shape) int8
        s_all = torch.stack([w[i][1] for w in wire]).reshape((-1,) + (1,) * g.ndim)
        means.append((torch.sum(q_all.float() * s_all, dim=0) / n).to(g.dtype))
    return tree_unflatten(grads[0], means), new_res


def compression_ratio(dtype=torch.float32) -> float:
    """Wire-byte reduction vs the uncompressed mean."""
    return dtype.itemsize / torch.int8.itemsize
