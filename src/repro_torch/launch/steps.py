"""Step functions of the trainer — port of ``repro/launch/steps.py``.

``make_train_step`` builds the reference's ``(state, batch) -> (state,
metrics)`` step: the gradient of ``transformer.loss_fn`` with respect to
every master (``cfg.micro_steps`` micro-batches accumulated as float32
sums of ``g / micro``, the metrics those of the last micro-batch), then
``adamw_update``.  The state is ``{"params": <the Transformer>, "opt":
{"mu", "nu", "count"}}``, the moments shaped like ``Transformer.tree()``;
the step writes the masters and the moments in place, as the reference
donates its state.

A state placed on a slot mesh (every leaf a ``sharding.SlotArray``: the
params tree ``Transformer.tree()``'s shape, ``count`` replicated) takes the
sharded step, the reference's jitted step under GSPMD: each data group runs
``models/spmd.loss_fn`` on its rows, each block's gradient is summed over
the slots holding that block (the data-axis mean of the loss's gradient,
as the loss is the global mean), and AdamW runs per block with the global
gradient norm counting each element once.

``build_train``, ``build_prefill`` and ``build_decode`` return a step
with its input specs (``meta`` tensors: shapes and dtypes, no storage) and
``NamedSharding`` trees, as the reference's do for ``jax.jit``;
``params_specs`` / ``state_specs`` / ``cache_shapes_and_shardings`` give the
specs, ``place`` lays a tree onto its shardings, and ``build_cell``
dispatches on the shape's kind.  The serving steps take parameters placed
on a slot mesh (``models/spmd.prefill`` / ``decode_step``: logits placed as
``("act_batch", "act_vocab")``, the cache placed by
``transformer.cache_specs``).  Every step runs alike on concrete placed
tensors (the card's
slots, CPU slots) and on ``meta`` slots, which is how ``launch/dryrun.py``
traces a cell.  The MoE presets run there too, their experts placed by the
``"experts"`` rule: under expert parallelism each expert block's replicas
are the slots of one model index across the data groups, and the gradient
sum over replicas covers them as any other block.  An encoder-decoder's
frames and a VLM's patches are batch inputs placed by ``act_batch``
(``batch_specs``); a decode state holds the cross K/V placed by
``transformer.cache_specs``.  The three builders refuse, before any
placement, what the one-device model lacks (``spmd.check_supported``).
Token ids are int64 here, where the reference's are int32
(``TokenPipeline`` gives int64).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, torch_dtype
from repro_torch.models import spmd, transformer
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.sharding import NamedSharding, PartitionSpec, ShardingCtx, SlotArray
from repro_torch.utils import tree_leaves, tree_map


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


def params_specs(cfg: ModelConfig) -> Tuple[Any, Any]:
    """(``meta`` tensor tree, logical-spec tree), shaped like
    ``Transformer.tree()``, without allocation."""
    return transformer.param_shapes(cfg), transformer.param_specs(cfg)


def state_specs(cfg: ModelConfig, opt_cfg: OptConfig):
    """Train state = params + AdamW moments, as specs."""
    p_shapes, p_specs = params_specs(cfg)
    moments = lambda: transformer.param_shapes(cfg, torch_dtype(opt_cfg.moment_dtype))
    count = torch.empty((), dtype=torch.int32, device="meta")
    return ({"params": p_shapes, "opt": {"mu": moments(), "nu": moments(), "count": count}},
            {"params": p_specs, "opt": {"mu": p_specs, "nu": p_specs, "count": ()}})


def _batch_shardings(shd: ShardingCtx, batch):
    return {k: shd.named(["act_batch"] + [None] * (len(v.shape) - 1), tuple(v.shape))
            for k, v in batch.items()}


def place(tree, shardings):
    """Each leaf of ``tree`` placed by the matching ``NamedSharding``."""
    return tree_map(lambda x, s: s.place(x), tree, shardings)


def init_placed_state(params, opt_cfg: OptConfig, shardings):
    """The train state on a slot mesh: ``params`` (``Transformer.tree()``)
    placed by ``shardings["params"]``, the moments zero blocks in
    ``moment_dtype`` laid out as the params, and the step count 0 placed by
    ``shardings["opt"]["count"]`` — ``init_opt_state`` without a global
    copy of the moments."""
    placed = place(params, shardings["params"])
    dt = torch_dtype(opt_cfg.moment_dtype)
    zeros = lambda a: SlotArray(a.sharding, a.shape,
                                [torch.zeros(b.shape, dtype=dt, device=b.device)
                                 for b in a.blocks])
    count = torch.zeros((), dtype=torch.int32)
    return {"params": placed, "opt": {"mu": tree_map(zeros, placed),
                                      "nu": tree_map(zeros, placed),
                                      "count": shardings["opt"]["count"].place(count)}}


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def _repeats(params, cfg: ModelConfig) -> list:
    """Per leaf of ``params`` (``tree_leaves`` order): whether it belongs to
    a scanned layer past the first group — the decoder's, or the
    encoder's — whose gradient sum repeats the scan body's in the record of
    collectives."""
    def flags(layers, plan):
        lp = len(plan.pattern)
        return [tree_map(lambda _: plan.n_groups > 0 and lp <= i < plan.n_groups * lp, layer)
                for i, layer in enumerate(layers)]

    tree = {k: tree_map(lambda _: False, v) for k, v in params.items()}
    tree["layers"] = flags(params["layers"], transformer.layer_plan(cfg))
    if "encoder" in params:
        tree["encoder"]["layers"] = flags(params["encoder"]["layers"],
                                          transformer.encoder_plan(cfg))
    return tree_leaves(tree)


def _slot_grads(params, cfg: ModelConfig, batch):
    """The sharded step's loss, metrics and gradients: per leaf of
    ``params``, one gradient per slot, each the sum over the block's
    replicas (holders of one block share the tensor)."""
    arrs = tree_leaves(params)
    masters = [b for a in arrs for b in a.blocks]
    for b in masters:
        b.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = spmd.loss_fn(params, cfg, batch)
        flat = list(torch.autograd.grad(loss, masters, allow_unused=True,
                                        materialize_grads=True))
    repeats = _repeats(params, cfg)
    out = []
    with torch.no_grad(), torch.profiler.record_function(spmd.COLLECTIVE):
        for a, repeat in zip(arrs, repeats):
            g, flat[:len(a.blocks)] = flat[:len(a.blocks)], []
            for group in a.sharding.replica_groups(len(a.shape)):
                if len(group) > 1:
                    spmd.note("all-reduce", g[group[0]].numel() * g[group[0]].element_size(),
                              group, repeat)
                acc = g[group[0]]
                for s in group[1:]:
                    acc = acc + g[s].to(acc.device)
                for s in group:
                    g[s] = acc.to(a.sharding.device(s))
            out.append(g)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, out


def _slot_norm(arrs, grads) -> torch.Tensor:
    """The global norm of the gradient, each element counted once: one
    holder per block."""
    dev = arrs[0].sharding.device(0)
    spmd.note("all-reduce", 4, range(arrs[0].sharding.n_slots))
    total = None
    for a, g in zip(arrs, grads):
        for group in a.sharding.replica_groups(len(a.shape)):
            sq = torch.sum(torch.square(g[group[0]].float())).to(dev)
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _slot_train_step(cfg: ModelConfig, opt_cfg: OptConfig, state, batch):
    micro = max(cfg.micro_steps, 1)
    params = state["params"]
    arrs = tree_leaves(params)
    batch = {k: (v.gather() if isinstance(v, SlotArray) else v) for k, v in batch.items()
             if v is not None}
    if micro == 1:
        loss, metrics, grads = _slot_grads(params, cfg, batch)
    else:
        rows = next(iter(batch.values())).shape[0] // micro
        grads = [[torch.zeros(b.shape, dtype=torch.float32, device=b.device) for b in a.blocks]
                 for a in arrs]
        loss = None
        for i in range(micro):
            mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
            l, metrics, g = _slot_grads(params, cfg, mb)
            with torch.no_grad():
                for acc, gi in zip(grads, g):
                    for a, b in zip(acc, gi):
                        a.add_(b.float() / micro)
            loss = l / micro if loss is None else loss + l / micro
    gnorm = _slot_norm(arrs, grads)
    count = state["opt"]["count"]
    slots = spmd.program_slots(arrs[0].sharding)
    flat = lambda t: [a.blocks[s] for a in tree_leaves(t) for s in slots]
    _, opt, om = adamw_update([g[s] for g in grads for s in slots],
                              {"mu": flat(state["opt"]["mu"]), "nu": flat(state["opt"]["nu"]),
                               "count": count.blocks[0]},
                              flat(params), opt_cfg, grad_norm=gnorm)
    new_opt = {"mu": state["opt"]["mu"], "nu": state["opt"]["nu"],
               "count": count.sharding.place(opt["count"])}
    return {"params": params, "opt": new_opt}, {"loss": loss, **metrics, **om}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, shd=None, grad_shardings=None):
    """(state, batch) -> (state, metrics) with ``cfg.micro_steps`` gradient
    accumulation.  ``metrics``: ``loss``, ``xent``, ``moe_aux``,
    ``grad_norm``, ``lr`` (0-d tensors on the model's device, or slot 0's).

    A state whose params are a ``Transformer`` runs on its device; one
    placed on a slot mesh (``SlotArray`` leaves) takes the sharded step.
    ``grad_shardings`` pins the reference's gradients to the parameter
    layout, a layout constraint that never changes values: the port's
    gradients come out in their parameters' layout already (one block per
    slot), so it is accepted and changes nothing."""
    micro = max(cfg.micro_steps, 1)

    def train_step(state, batch):
        model = state["params"]
        if not isinstance(model, transformer.Transformer):
            return _slot_train_step(cfg, opt_cfg, state, batch)
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
    """(step, (state specs, batch specs), (state shardings, batch
    shardings)): the specs ``meta`` tensors, the shardings trees of
    ``NamedSharding`` over ``mesh`` by the logical rules (``cfg.fsdp``,
    ``cfg.seq_shard``).  Place a state with ``place(tree, shardings)``."""
    spmd.check_supported(cfg)
    opt_cfg = opt_cfg or OptConfig(moment_dtype=cfg.opt_state_dtype)
    shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)
    st_shapes, st_specs = state_specs(cfg, opt_cfg)
    st_shard = shd.param_shardings(st_shapes, st_specs)
    b_specs = batch_specs(cfg, shape)
    b_shard = _batch_shardings(shd, b_specs)
    fn = make_train_step(cfg, opt_cfg, shd, grad_shardings=st_shard["params"])
    return fn, (st_shapes, b_specs), (st_shard, b_shard)


# --------------------------------------------------------------------------
# serve: prefill and decode
# --------------------------------------------------------------------------

def build_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(prefill_fn, (param specs, batch specs), (param shardings, batch
    shardings)): ``prefill_fn(params, batch)`` runs the prompt
    ``batch["tokens"]`` (``shape.global_batch`` rows; with an encoder-decoder's
    ``frames``, or a VLM's ``patches`` before ``shape.seq_len`` − P text
    tokens) into a cache of ``shape.seq_len`` positions and returns (last
    logits, cache)."""
    spmd.check_supported(cfg)
    shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)
    p_shapes, p_specs = params_specs(cfg)
    p_shard = shd.param_shardings(p_shapes, p_specs)
    b = batch_specs(cfg, shape, with_labels=False)
    b_shard = _batch_shardings(shd, b)
    cache_len = shape.seq_len

    def prefill_fn(params, batch):
        return spmd.prefill(params, cfg, batch["tokens"], cache_len, frames=batch.get("frames"),
                            patches=batch.get("patches"))

    return prefill_fn, (p_shapes, b), (p_shard, b_shard)


def cache_shapes_and_shardings(cfg: ModelConfig, batch: int, cache_len: int, shd: ShardingCtx):
    """(the decode state as ``meta`` tensors, its ``NamedSharding`` tree)."""
    shapes = transformer.cache_shapes(cfg, batch, cache_len)
    return shapes, shd.param_shardings(shapes, transformer.cache_specs(cfg))


def build_decode(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """decode_* cells: one new token against a cache of ``shape.seq_len``.
    (serve_step, (param specs, token, cache specs, pos), (their shardings)):
    ``serve_step(params, token, cache, pos)`` -> (logits, cache), the cache
    written in place; the token is placed by ``act_batch``, ``pos``
    replicated."""
    spmd.check_supported(cfg)
    shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)
    p_shapes, p_specs = params_specs(cfg)
    p_shard = shd.param_shardings(p_shapes, p_specs)
    b = shape.global_batch
    c_shapes, c_shard = cache_shapes_and_shardings(cfg, b, shape.seq_len, shd)
    tok = torch.empty((b,), dtype=torch.int64, device="meta")
    tok_shard = shd.named(["act_batch"], (b,))
    pos = torch.empty((), dtype=torch.int32, device="meta")
    pos_shard = NamedSharding(mesh, PartitionSpec())

    def serve_step(params, token, cache, pos):
        return spmd.decode_step(params, cfg, token, cache, pos)

    return serve_step, (p_shapes, tok, c_shapes, pos), (p_shard, tok_shard, c_shard, pos_shard)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Dispatch on the cell kind: train / prefill / decode."""
    if shape.kind == "train":
        return build_train(cfg, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    return build_decode(cfg, shape, mesh)
