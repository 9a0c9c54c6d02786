"""AdamW with dtype-configurable moments and a warmup-cosine schedule —
port of ``repro/optim/adamw.py``.

Plain functions on trees (nested dicts and lists) of tensors, as the
reference's are on pytrees.  The update is the reference's, step for step:
clip by the global norm first, ``count + 1`` sets the learning rate, the
moments and the bias corrections ``1 − b**c`` in float32, ``step = m̂ /
(√v̂ + eps) + wd·p``, ``p − lr·step``, and the moments stored in
``moment_dtype`` (bfloat16 for ``llama3_405b``: only storage is cast
down).  ``torch.optim.AdamW`` applies the decay in another order and
cannot store bf16 moments, so it is not used.  Where the reference returns
new trees (its state is donated), ``adamw_update`` writes the parameters
and the moments in place under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import torch_dtype
from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def warmup_cosine(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to end_lr_frac·peak; a float32 0-d
    tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments shaped like ``params`` (on each leaf's device) in
    ``moment_dtype`` and an int32 step count."""
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    first = tree_leaves(params)[0]
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in tree_leaves(tree):
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """``tree`` scaled so its global norm is at most ``max_norm``, and that
    norm (``norm`` when the caller has it: the sharded step counts each
    element once where ``tree`` holds replicas)."""
    norm = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale.to(g.device)).to(g.dtype), tree), norm


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig, *, grad_norm=None):
    """One AdamW step.  Writes ``params`` and the moments in place and
    returns (params, new_opt_state, metrics) as the reference does.

    The update is elementwise, so the sharded step passes flat lists of
    every slot's blocks (replicas included) with ``grad_norm``, the global
    norm counting each element once; the clip and the ``grad_norm`` metric
    use it.  The learning rate lives on ``count``'s device and is moved to
    each block's."""
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    else:
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
    count = opt_state["count"] + 1
    lr = warmup_cosine(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(torch.float32)
    bc1 = 1.0 - b1 ** c
    bc2 = 1.0 - b2 ** c

    def upd(p, g, mu, nu):
        g32 = g.float()
        mu32 = b1 * mu.float() + (1 - b1) * g32
        nu32 = b2 * nu.float() + (1 - b2) * g32 * g32
        step = (mu32 / bc1.to(p.device)) / (torch.sqrt(nu32 / bc2.to(p.device)) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr.to(p.device) * step)
        mu.copy_(mu32)
        nu.copy_(nu32)

    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])):
        upd(p, g, mu, nu)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
