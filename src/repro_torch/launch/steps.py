"""Step functions of the trainer — port of ``repro/launch/steps.py``.

``make_train_step`` builds the reference's ``(state, batch) -> (state,
metrics)`` step: the gradient of ``transformer.loss_fn`` with respect to
every master (``cfg.micro_steps`` micro-batches accumulated as float32
sums of ``g / micro``, the metrics those of the last micro-batch), then
``adamw_update``.  The state is ``{"params": <the Transformer>, "opt":
{"mu", "nu", "count"}}``, the moments shaped like ``Transformer.tree()``;
the step writes the masters and the moments in place, as the reference
donates its state.

The reference's other builders return ``ShapeDtypeStruct`` specs and
shardings for ``jax.jit(...).lower`` — the multi-pod dry run and the
sharded step.  ``batch_specs`` gives the batch's shapes as tensors on the
``meta`` device (no storage); ``build_train``, ``build_prefill``,
``build_decode`` and ``build_cell`` raise until ROADMAP queue A item 18.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.utils import tree_map, unported


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                *, with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """One global batch of this cell as ``meta`` tensors: the shapes and
    dtypes ``TokenPipeline.next_batch`` gives (token ids int64)."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s - cfg.n_patches if cfg.n_patches else s
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    out = {"tokens": meta((b, s_text), torch.int64)}
    if with_labels:
        out["labels"] = meta((b, s_text), torch.int64)
    if cfg.n_encoder_layers:
        out["frames"] = meta((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.n_patches:
        out["patches"] = meta((b, cfg.n_patches, cfg.patch_dim), torch.float32)
    return out


def loss_and_grads(model: transformer.Transformer, cfg: ModelConfig, batch, shd=None):
    """``loss_fn`` and its gradient with respect to every master: (loss,
    metrics, grads), the loss and metrics detached, ``grads`` a tree shaped
    like ``model.tree()`` in the masters' dtypes.  Marks the masters as
    requiring gradients (the inference entry points run without them)."""
    masters = list(model.parameters())
    for p in masters:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(model, cfg, batch, shd)
        grads = torch.autograd.grad(loss, masters, allow_unused=True, materialize_grads=True)
    by_id = {id(p): g for p, g in zip(masters, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: by_id[id(p)], model.tree()))


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, shd=None, grad_shardings=None):
    """(state, batch) -> (state, metrics) with ``cfg.micro_steps`` gradient
    accumulation.  ``metrics``: ``loss``, ``xent``, ``moe_aux``,
    ``grad_norm``, ``lr`` (0-d tensors on the model's device).

    ``grad_shardings`` pins the reference's gradients to the parameter
    layout, a layout constraint that never changes values; one device has
    no layout to pin, so it is accepted and the gradients pass unchanged,
    as ``ShardingCtx.constrain`` passes activations."""
    micro = max(cfg.micro_steps, 1)

    def train_step(state, batch):
        model = state["params"]
        if micro == 1:
            loss, metrics, grads = loss_and_grads(model, cfg, batch, shd)
        else:
            rows = next(iter(batch.values())).shape[0] // micro
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), model.tree())
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(micro):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, metrics, g = loss_and_grads(model, cfg, mb, shd)
                tree_map(lambda a, gi: a.add_(gi.float() / micro), grads, g)
                loss = loss + l / micro
        _, opt, om = adamw_update(grads, state["opt"], model.tree(), opt_cfg)
        return {"params": model, "opt": opt}, {"loss": loss, **metrics, **om}

    return train_step


def build_train(cfg: ModelConfig, shape: ShapeConfig, mesh, opt_cfg: Optional[OptConfig] = None):
    raise unported("build_train (the dry run's lowering, the sharded train step)",
                   "queue A item 18")


def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh):
    raise unported("build_prefill (the dry run's lowering)", "queue A item 18")


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh):
    raise unported("build_decode (the dry run's lowering)", "queue A item 18")


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    raise unported("build_cell (the dry run's lowering)", "queue A item 18")
