"""The slot program of the sharded train step: ``transformer.loss_fn`` over
parameters placed on a slot mesh (``sharding.SlotArray`` leaves, shaped like
``Transformer.tree()``).

The reference jits ``loss_fn`` under GSPMD, which partitions it by the
parameters' ``NamedSharding``s.  Here one process runs every slot's part
with the one-device layer code on that slot's blocks, and the collectives
are tensor operations across the slots' tensors (``_Broadcast`` and
``_Reduce``, autograd functions, so ``torch.autograd`` carries each block's
gradient back through them):

  * DP — data group d (one index over the mesh's data axes) takes its rows
    of the batch; the loss is the global masked mean, Σ NLL over Σ mask.
  * FSDP — a weight sharded over a data axis is gathered over it before use
    (``NamedSharding.local_view``); the gather's gradient is the
    reduce-scatter.
  * TP over "model", where a weight's spec shards it.  ``wq``/``wk``/``wv``
    are column-parallel by heads: a slot runs ``_qkv`` and ``self_attend``
    with its head counts in a local config.  Where K/V replicate while Q
    shards (kv_heads % m ≠ 0), K/V are repeated to one head per query head
    before the slot's heads are sliced, so a slot straddling KV groups
    computes the same values.  ``wo`` and ``w_down`` are row-parallel:
    their outputs are summed over the model slots (in float32, rounded
    once to the activation dtype) before the residual add.  The embedding
    lookup is masked per vocab shard and summed; the unembedding gives each
    slot its vocab slice of the logits, and the cross-entropy combines each
    chunk's max and sum of exponentials across the model slots and takes
    the gold logit from the shard that owns it.
  * A sublayer whose weights the spec leaves whole over "model" (qwen3's 40
    heads on 16) is computed whole by every model slot, as GSPMD would, and
    slot 0's output is taken once, not summed.

The residual stream of a data group is one tensor on its first slot's
device, broadcast to the group's slots before each sublayer.  Each block's
gradient is the sum over every slot's use of that block; the step
(``launch/steps.py``) then sums it over the block's replicas.  Collectives
run under ``torch.profiler.record_function("spmd.collective")``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import SlotArray, data_axis_names
from repro_torch.utils import tree_leaves, tree_map, unported

COLLECTIVE = "spmd.collective"


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

class _Broadcast(torch.autograd.Function):
    """x onto each of ``devices``; backward sums the copies' gradients (in
    float32) back onto x's device."""

    @staticmethod
    def forward(ctx, x, *devices):
        with torch.profiler.record_function(COLLECTIVE):
            ctx.device = x.device
            return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(COLLECTIVE):
            acc = None
            for g in grads:
                g = g.to(device=ctx.device, dtype=torch.float32)
                acc = g if acc is None else acc + g
            return (acc.to(grads[0].dtype),) + (None,) * len(grads)


class _Reduce(torch.autograd.Function):
    """The sum of ``parts`` on ``device``, accumulated in float32 and
    rounded once to ``dtype``; backward hands each part the gradient."""

    @staticmethod
    def forward(ctx, device, dtype, *parts):
        with torch.profiler.record_function(COLLECTIVE):
            ctx.metas = [(p.device, p.dtype) for p in parts]
            acc = None
            for p in parts:
                p = p.to(device=device, dtype=torch.float32)
                acc = p if acc is None else acc + p
            return acc.to(dtype)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(COLLECTIVE):
            return (None, None) + tuple(g.to(device=d, dtype=dt) for d, dt in ctx.metas)


def broadcast(x: torch.Tensor, devices) -> tuple:
    return _Broadcast.apply(x, *devices)


def reduce_sum(parts: List[torch.Tensor], device, dtype=None) -> torch.Tensor:
    return _Reduce.apply(torch.device(device), dtype or parts[0].dtype, *parts)


# --------------------------------------------------------------------------
# the mesh as the step sees it
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Groups:
    """The mesh's slots by data group: ``slots[d][m]`` is the slot at data
    index d (row-major over the data axes) and model index m."""
    slots: tuple
    devices: tuple

    @property
    def n_data(self) -> int:
        return len(self.slots)

    @property
    def n_model(self) -> int:
        return len(self.slots[0])


def groups_of(sharding) -> Groups:
    """The data groups of ``sharding``'s mesh, whose axes must be data axes
    and ``"model"``."""
    mesh = sharding.mesh
    data = data_axis_names(mesh)
    extra = [a for a in mesh.axis_names if a not in data and a != "model"]
    if extra:
        raise ValueError(f"the train step runs on data and model axes; the mesh has {extra}")
    n_data = int(np.prod([mesh.shape[a] for a in data])) if data else 1
    n_model = mesh.shape.get("model", 1)
    slots = [[0] * n_model for _ in range(n_data)]
    for s in range(sharding.n_slots):
        c = sharding.coords(s)
        d = int(np.ravel_multi_index([c[a] for a in data], [mesh.shape[a] for a in data])) \
            if data else 0
        slots[d][c.get("model", 0)] = s
    return Groups(tuple(tuple(r) for r in slots),
                  tuple(tuple(sharding.device(s) for s in r) for r in slots))


def model_dim(arr: SlotArray):
    """The dim of ``arr`` sharded over "model" (alone), or None."""
    for i, entry in enumerate(arr.sharding.spec):
        if entry == "model":
            return i
        if isinstance(entry, tuple) and "model" in entry:
            raise ValueError(f"a dim sharded over {entry}: the slot program splits a dim "
                             f"over 'model' alone")
    return None


def _check_model_dim(arr: SlotArray, name: str, want: int) -> bool:
    got = model_dim(arr)
    if got not in (None, want):
        raise ValueError(f"{name} is sharded over 'model' on dim {got} ({arr.sharding.spec}); "
                         f"the slot program shards it on dim {want} or not at all")
    return got is not None


class _Placed:
    """A sublayer's placed leaves and their compute copies; ``local(k, s)``
    is leaf k as slot s's program sees it (gathered over the data axes)."""

    def __init__(self, arrs: Dict[str, SlotArray], blocks: Dict[str, list]):
        self.arrs, self.blocks = arrs, blocks

    def local(self, k: str, s: int) -> torch.Tensor:
        return self.arrs[k].sharding.local_view(self.blocks[k], s, keep=("model",))

    def slot(self, s: int) -> dict:
        return {k: self.local(k, s) for k in self.arrs}


# --------------------------------------------------------------------------
# the slot program
# --------------------------------------------------------------------------

def _embed(tok: _Placed, cfg: ModelConfig, tokens, groups: Groups, d: int):
    """Data group d's embedded tokens, on its first slot's device."""
    sharded = _check_model_dim(tok.arrs["tok"], "embed/tok", 0)
    outs = []
    for m, s in enumerate(groups.slots[d]):
        w = tok.local("tok", s)
        t = tokens.to(w.device)
        if not sharded:
            outs.append(L.embed({"tok": w}, cfg, t))
            continue
        lo = m * w.shape[0]
        local = t - lo
        ok = (local >= 0) & (local < w.shape[0])
        e = w[local.clamp(0, w.shape[0] - 1)]
        outs.append(torch.where(ok[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device)))
    return reduce_sum(outs, groups.devices[d][0]) if sharded else outs[0]


def _attention(p: dict, cfg: ModelConfig, h, kind: str, m: int, n_model: int,
               q_sharded: bool, kv_sharded: bool):
    """Slot m's part of self-attention: its query heads, its share of
    ``wo``'s output (the whole output where nothing shards)."""
    hd = cfg.hd
    hl = cfg.n_heads // n_model if q_sharded else cfg.n_heads
    gl = cfg.n_kv_heads // n_model if kv_sharded else cfg.n_kv_heads
    pos = torch.arange(h.shape[1], device=h.device)[None, :]
    q, k, v = L._qkv(p, cfg, h, h, pos, pos)
    if q_sharded and not kv_sharded:
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=2)[:, :, m * hl:(m + 1) * hl]
        v = v.repeat_interleave(rep, dim=2)[:, :, m * hl:(m + 1) * hl]
        gl = hl
    lcfg = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=gl, head_dim=hd)
    out = L.self_attend(lcfg, q, k, v, kind=kind)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _layer(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str, groups: Groups, d: int, x):
    """One decoder layer for data group d: x -> x + attn, then + mlp."""
    attn, mlp = lp["attn"], lp["mlp"]
    n_model = groups.n_model
    q_sh = _check_model_dim(attn.arrs["wq"], "wq", 1)
    kv_sh = _check_model_dim(attn.arrs["wk"], "wk", 1)
    if _check_model_dim(attn.arrs["wo"], "wo", 0) != q_sh or (kv_sh and not q_sh):
        raise ValueError("wq and wo shard their heads together, and K/V only with them")
    down = "w_out" if cfg.gelu_mlp else "w_down"
    f_sh = _check_model_dim(mlp.arrs[down], down, 0)
    for k in mlp.arrs:
        if k != down and _check_model_dim(mlp.arrs[k], k, 1) != f_sh:
            raise ValueError("the MLP's weights must shard d_ff together")
    devs = groups.devices[d]
    dev0 = devs[0]

    outs = []
    for m, (s, xs) in enumerate(zip(groups.slots[d], broadcast(x, devs))):
        hn = L.apply_norm(lp["norm1"].slot(s), cfg, xs)
        outs.append(_attention(attn.slot(s), cfg, hn, kind, m, n_model, q_sh, kv_sh))
    x = x + (reduce_sum(outs, dev0) if q_sh else outs[0])

    outs = []
    for s, xs in zip(groups.slots[d], broadcast(x, devs)):
        hn = L.apply_norm(lp["norm2"].slot(s), cfg, xs)
        outs.append(L.apply_mlp(mlp.slot(s), cfg, hn))
    return x + (reduce_sum(outs, dev0) if f_sh else outs[0])


def _nll_fn(emb: _Placed, cfg: ModelConfig, groups: Groups, d: int):
    """A chunk's per-token NLL from the group's hidden copies (one per model
    slot): vocab-parallel where the embedding shards its vocab."""
    key = "tok" if cfg.tie_embeddings else "unembed"
    sharded = _check_model_dim(emb.arrs[key], key, 0 if cfg.tie_embeddings else 1)
    slots, dev0 = groups.slots[d], groups.devices[d][0]

    def nll(*args):
        *hs, labels = args
        if not sharded:
            w = emb.local(key, slots[0])
            logits = L.unembed({key: w}, cfg, hs[0]).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
            return lse - gold
        logits = [L.unembed({key: emb.local(key, s)}, cfg, h).float() for s, h in zip(slots, hs)]
        with torch.profiler.record_function(COLLECTIVE):
            mx = torch.stack([lg.detach().amax(-1).to(dev0) for lg in logits]).amax(0)
        ses, golds = [], []
        for m, lg in enumerate(logits):
            mxm = mx.to(lg.device)
            ses.append(torch.exp(lg - mxm[..., None]).sum(-1))
            vl = lg.shape[-1]
            local = labels.to(lg.device) - m * vl
            ok = (local >= 0) & (local < vl)
            g = torch.gather(lg, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
            golds.append(torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device)))
        lse = mx + torch.log(reduce_sum(ses, dev0))
        return lse - reduce_sum(golds, dev0)

    return nll


def loss_fn(params, cfg: ModelConfig, batch):
    """``transformer.loss_fn`` over placed parameters: (loss, {"xent",
    "moe_aux"}) on slot 0's device.  ``batch`` holds global tensors
    (``tokens``, ``labels``, optional ``loss_mask``) whose rows split evenly
    over the data groups.  Each scanned layer of a data group runs under a
    checkpoint when ``cfg.remat`` is set and gradients are on, as the
    one-device forward does in training.  An unsharded vocabulary's logits are
    computed on the group's slot 0 alone (no other copy would reach the
    loss)."""
    T._check_supported(cfg)
    if batch.get("frames") is not None or batch.get("patches") is not None:
        raise unported("the slot program's frames / patches", "queue A item 21")
    first = tree_leaves(params)[0]
    groups = groups_of(first.sharding)
    dt = cfg.activation_dtype()

    def cast(b):
        return b.to(dt) if b.is_floating_point() and b.dtype != dt else b

    compute = tree_map(lambda a: [cast(b) for b in a.blocks], params)
    emb_c = _Placed(params["embed"], compute["embed"])
    emb_m = _Placed(params["embed"], {k: a.blocks for k, a in params["embed"].items()})
    fnorm = _Placed(params["final_norm"], compute["final_norm"])
    layers = [{k: _Placed(lp[k], lc[k]) for k in T._SUBLAYERS}
              for lp, lc in zip(params["layers"], compute["layers"])]

    tokens = T._tokens(batch["tokens"], groups.devices[0][0])
    labels = T._tokens(batch["labels"], groups.devices[0][0])
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device) if mask is None
            else torch.as_tensor(mask, device=labels.device).float())
    rows = tokens.shape[0]
    if rows % groups.n_data:
        raise ValueError(f"{rows} rows do not split over {groups.n_data} data groups")
    r = rows // groups.n_data
    plan = T.layer_plan(cfg)
    n_scanned = plan.n_groups * len(plan.pattern)
    use_remat = cfg.remat and torch.is_grad_enabled()

    tots, cnts = [], []
    for d in range(groups.n_data):
        dev0 = groups.devices[d][0]
        cut = slice(d * r, (d + 1) * r)
        x = _embed(emb_c, cfg, tokens[cut], groups, d)
        for i, kind in enumerate(plan.kinds):
            fn = functools.partial(_layer, layers[i], cfg, kind, groups, d)
            x = T._remat(cfg, fn)(x) if (use_remat and i < n_scanned) else fn(x)
        hs = [L.apply_norm(fnorm.slot(s), cfg, xs)
              for s, xs in zip(groups.slots[d], broadcast(x, groups.devices[d]))]
        tot, cnt = L.chunked_nll(_nll_fn(emb_m, cfg, groups, d), hs, labels[cut].to(dev0),
                                 mask[cut].to(dev0), cfg.xent_chunk)
        tots.append(tot)
        cnts.append(cnt)
    dev = groups.devices[0][0]
    xent = sum(t.to(dev) for t in tots) / torch.clamp(sum(c.to(dev) for c in cnts), min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}
