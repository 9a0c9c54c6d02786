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

The serving steps, ``prefill`` and ``decode_step``, run the same slot
program without gradients over a cache placed by ``transformer.cache_specs``
(each slot holds one block of each layer's K and V).  Their logits come back
placed as ``("act_batch", "act_vocab")``: each slot keeps its rows and its
vocab slice, the whole vocabulary where it does not shard.  The cache's
``kv_heads`` dim takes "model" where the KV heads divide the model axis
(each slot attends over its own heads); otherwise its sequence dim does
(``act_kv_seq``): a slot holds a block of positions for every head, prefill
writes each slot's block, decode writes the new K/V on the slot owning
``pos`` alone, every slot attends its query heads (gathered from the model
group where Q shards) over its positions, and the group combines the
partial softmax terms (max, sum of exponentials, weighted values) in
float32.

``record_collectives`` records, while a step runs, each collective the
slot program performs: its kind in the reference's HLO terms
(``all-reduce`` for a row-parallel sum or a gradient sum, ``all-gather``
for an FSDP gather and for Q gathered over the model group, its backward a
``reduce-scatter``) and its per-slot operand bytes, by the rules of
``hlo_analysis._line_collective_bytes``.  The residual stream's copy to
the model slots of its group, which GSPMD would not make, goes under
``"broadcast"``.  ``launch/dryrun.py`` reads the record.

The recurrent layers split their channels over "model" as their specs
say.  An ``rglru`` mixer is channel-parallel over ``rnn_d``: ``w_in`` and
``w_gate`` column-parallel, the conv, gates and scan on the slot's channels,
``w_out`` row-parallel; its state blocks are the slot's channels, so no
collective touches them.  An ``rwkv`` layer takes its ``(d,)`` mixes and norm
scales whole (``_Placed.local(whole=True)``, an all-gather whose backward
is the reduce-scatter) and r/k/v/g/w column-parallel; where ``u`` shards by
heads each slot scans and group-norms its own heads, and where the heads
straddle the slots (``u`` whole: 40 heads on 16) r/k/v/g/w are gathered
over the model group and every model slot runs the whole-head scan and
holds the whole ``wkv`` state, as the spec replicates it.  ``wo`` and
``cm_r`` shard their output (residual) channels: each slot's slice of the
time-mix output and of the receptance is gathered (``all_gather``) into
the replicated residual; ``cm_v`` is row-parallel.  A ``local`` layer's
ring is placed like any cache; prefill writes its rolled tail by block.

A global batch whose rows do not split over the data groups (``act_batch``
unresolved, as ``long_500k``'s one row on 16 data groups) is replicated:
every data group runs all of it, and the loss counts data group 0's once.

An MoE layer (``moe`` in place of ``mlp``) runs in one of three layouts,
by its spec: expert parallel (``"experts"`` on "model": slot m holds e/M
whole experts and the router's columns for them), the ``expert_mlp``
fallback where the experts do not divide the model axis (``d_expert``
split, ``w_down`` row-parallel; the router whole), or whole.  A
column-sharded router's (T_d, e/M) logits are gathered over the model group
in float32 (``all-gather``) before the softmax, and every model slot takes
the same stable top-k, sort and keep mask (``layers._route``, ``_sort``,
``_keep``).  Under EP slot m fills and runs the rows of its own experts, a
static slice of the expert-major buffer; the group's slices joined in slot
order on its first slot (recorded as ``all-to-all``, GSPMD's EP exchange)
are the one-device buffer's output rows, and the combine
(``layers._combine``) runs there unchanged, so a token's adds keep their
order.  Under the fallback the ``w_down`` partials are summed in float32
and rounded once (an all-reduce), as an MLP's are.  The global dispatch
(the reference's default) keeps an assignment by its position among the
whole batch's assignments to its expert: where a config has MoE layers, the
data groups advance together, one layer at a time; at an MoE layer each
group counts its assignments per expert, the counts are gathered over the
data groups (an ``(e,)`` integer vector a slot, ``all-gather``), group d's
offset for an expert is the sum of the groups' before it, and an assignment
is kept where offset + its position in the group is below the global
capacity.  A group's buffer holds min(cap, T_d) rows an expert (a token
picks an expert once).  The aux takes the means over every token: each
group's sums of one_hot(top-1) and of the probabilities are all-reduced
(``reduce_sum``, so the router's gradient flows back).  Where the batch
does not split, every group dispatches all of it: no exchange, group 0's
aux.  The per-data-shard dispatch (``cfg.moe_sharded_dispatch``, the
reference's ``apply_moe`` with its sharding context): each group's rows are
one chunk with the capacity of a chunk, no count crosses groups, and the
aux is the mean of the groups' (an all-reduce of one scalar); where the
rows do not split, each group cuts all of them into the data groups' count
of chunks, as ``layers.apply_moe`` does.  A decode step always takes the
global dispatch and drops the aux, as the reference does; a prefill drops
it too (nothing reads it).  No buffer's shape depends on the data, so an
MoE step traces on ``meta`` slots as any other.

An encoder-decoder's encoder runs per data group over its rows of the
frames (``act_batch``): its ``enc-attn`` layers split over "model" as the
decoder's attention and MLP do, its norm on the group's first slot, the
output copied to the group's slots once a step.  Each decoder layer's
cross-attention (``normx``, ``xattn``) follows its mixer: queries from the
residual stream, K/V of the encoder output, unroped, the heads split as
self-attention's, ``wo`` row-parallel.  A prefill with frames writes each
slot's block of the cross K/V by ``kv_heads`` (whole on every slot where
the KV heads do not divide the model axis); a decode step reads them and
writes nothing.  A VLM's patches (``act_batch``) go through the projector
per data group — ``w1``'s columns and ``w2``'s rows on "model", the
partials summed in float32 — and are prepended to the embeddings, so
positions 0 … P−1 are the patches' and ``loss_fn`` scores the text.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.models import transformer as T
from repro_torch.sharding import ShardingCtx, SlotArray, _names, data_axis_names
from repro_torch.utils import tree_leaves, tree_map

COLLECTIVE = "spmd.collective"


# --------------------------------------------------------------------------
# the record of collectives
# --------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
BROADCAST = "broadcast"     # the residual stream copied to its group's slots


@dataclasses.dataclass
class CollectiveRecord:
    """Per kind, per slot: operand bytes and calls of the collectives a
    traced step made.  ``bytes`` / ``counts`` count every execution;
    ``bytes_once`` / ``counts_once`` count a scanned layer group's body once
    (the layers past the first group of ``layer_plan``'s ``n_groups`` left
    out), as the reference's HLO text holds a scan body once."""
    n_slots: int
    bytes: Dict[str, np.ndarray]
    counts: Dict[str, np.ndarray]
    bytes_once: Dict[str, np.ndarray]
    counts_once: Dict[str, np.ndarray]

    @classmethod
    def empty(cls, n_slots: int) -> "CollectiveRecord":
        z = lambda: {k: np.zeros(n_slots, dtype=np.int64) for k in KINDS + (BROADCAST,)}
        return cls(n_slots, z(), z(), z(), z())

    def note(self, kind: str, nbytes: int, slots, repeat: bool) -> None:
        for s in slots:
            self.bytes[kind][s] += nbytes
            self.counts[kind][s] += 1
            if not repeat:
                self.bytes_once[kind][s] += nbytes
                self.counts_once[kind][s] += 1

    def combine(self, other: "CollectiveRecord", k: int) -> "CollectiveRecord":
        """``self + k · (other - self)``, field by field: with ``self`` and
        ``other`` the records of traces one layer group apart, the record
        ``k`` groups past ``self``'s."""
        lin = lambda a, b: {n: a[n] + k * (b[n] - a[n]) for n in a}
        return CollectiveRecord(self.n_slots, lin(self.bytes, other.bytes),
                                lin(self.counts, other.counts),
                                lin(self.bytes_once, other.bytes_once),
                                lin(self.counts_once, other.counts_once))


_REC: Optional[CollectiveRecord] = None
_REPEAT = False             # inside a scanned layer past the first group
_ONE_GROUP = False          # run data group 0's program alone (``one_data_group``)


@contextlib.contextmanager
def record_collectives(n_slots: int):
    """Record the collectives of the slot program run inside the block."""
    global _REC
    prev, _REC = _REC, CollectiveRecord.empty(n_slots)
    try:
        yield _REC
    finally:
        _REC = prev


@contextlib.contextmanager
def one_data_group():
    """Run only data group 0's program; every other group's outputs are
    group 0's (the dry run's trace: each data group runs the same program on
    blocks of the same shapes, so its record and output bytes are group 0's;
    the values are not)."""
    global _ONE_GROUP
    prev, _ONE_GROUP = _ONE_GROUP, True
    try:
        yield
    finally:
        _ONE_GROUP = prev


def _data_groups(groups) -> range:
    return range(1 if _ONE_GROUP else groups.n_data)


def program_slots(sharding) -> list:
    """The slots whose programs run: all of ``sharding``'s mesh, or data
    group 0's under ``one_data_group``."""
    if _ONE_GROUP:
        return list(groups_of(sharding).slots[0])
    return list(range(sharding.n_slots))


def _fill_groups(groups, per_slot: list) -> list:
    """``per_slot`` with each slot no data group wrote given its model
    index's slot of group 0's."""
    for row in groups.slots[1:]:
        for m, s in enumerate(row):
            if per_slot[s] is None:
                per_slot[s] = per_slot[groups.slots[0][m]]
    return per_slot


def note(kind: str, nbytes: int, slots, repeat: Optional[bool] = None) -> None:
    """One collective over ``slots``, each with an operand of ``nbytes``."""
    if _REC is not None:
        _REC.note(kind, int(nbytes), slots, _REPEAT if repeat is None else repeat)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _scoped(i: int, plan, fn):
    """``fn`` run as layer i: collectives past the first scanned group are
    marked repeated (also when a checkpoint recomputes it)."""
    lp = len(plan.pattern)
    repeat = plan.n_groups > 0 and lp <= i < plan.n_groups * lp

    def run(*args):
        global _REPEAT
        prev, _REPEAT = _REPEAT, repeat
        try:
            return fn(*args)
        finally:
            _REPEAT = prev

    return run


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

class _Broadcast(torch.autograd.Function):
    """x onto each of ``devices``; backward sums the copies' gradients (in
    float32) back onto x's device.  Recorded as a ``"broadcast"`` of x over
    ``slots``; its backward as an all-reduce."""

    @staticmethod
    def forward(ctx, x, slots, *devices):
        with torch.profiler.record_function(COLLECTIVE):
            ctx.device, ctx.slots, ctx.repeat = x.device, slots, _REPEAT
            note(BROADCAST, _nbytes(x), slots)
            return tuple(x.view_as(x) if d == x.device else x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(COLLECTIVE):
            note("all-reduce", _nbytes(grads[0]), ctx.slots, ctx.repeat)
            acc = None
            for g in grads:
                g = g.to(device=ctx.device, dtype=torch.float32)
                acc = g if acc is None else acc + g
            return (acc.to(grads[0].dtype), None) + (None,) * len(grads)


class _Reduce(torch.autograd.Function):
    """The sum of ``parts`` on ``device``, accumulated in float32 and
    rounded once to ``dtype``; backward hands each part the gradient.
    Recorded as an all-reduce over ``slots``; its backward, a copy GSPMD
    would not make, as a ``"broadcast"``."""

    @staticmethod
    def forward(ctx, device, dtype, slots, *parts):
        with torch.profiler.record_function(COLLECTIVE):
            ctx.metas, ctx.slots, ctx.repeat = [(p.device, p.dtype) for p in parts], slots, _REPEAT
            note("all-reduce", _nbytes(parts[0]), slots)
            acc = None
            for p in parts:
                p = p.to(device=device, dtype=torch.float32)
                acc = p if acc is None else acc + p
            return acc.to(dtype)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(COLLECTIVE):
            note(BROADCAST, _nbytes(g), ctx.slots, ctx.repeat)
            return (None, None, None) + tuple(g.to(device=d, dtype=dt) for d, dt in ctx.metas)


class _Gathered(torch.autograd.Function):
    """Marks an FSDP-gathered weight (the value unchanged): its backward is
    recorded as the reduce-scatter of the gathered gradient."""

    @staticmethod
    def forward(ctx, w, slot):
        ctx.slot, ctx.repeat = slot, _REPEAT
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        note("reduce-scatter", _nbytes(g), (ctx.slot,), ctx.repeat)
        return g, None


_BACKWARD_KIND = {"all-gather": "reduce-scatter", "all-to-all": "all-to-all"}


class _AllGather(torch.autograd.Function):
    """The concatenation of ``parts`` (one a model slot, in model order)
    along ``dim`` onto each of ``devices``; backward sums the copies'
    gradients in float32, rounds once and hands each part its slice.
    Recorded as ``kind`` (an all-gather, or the all-to-all of an EP
    exchange) of a part over ``slots``; its backward as a reduce-scatter of
    the gathered gradient (an all-to-all)."""

    @staticmethod
    def forward(ctx, dim, slots, devices, kind, *parts):
        with torch.profiler.record_function(COLLECTIVE):
            ctx.dim, ctx.slots, ctx.repeat, ctx.kind = dim, slots, _REPEAT, kind
            ctx.metas = [(p.device, p.dtype, p.shape[dim]) for p in parts]
            note(kind, _nbytes(parts[0]), slots)
            return tuple(torch.cat([p.to(d) for p in parts], dim=dim) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function(COLLECTIVE):
            note(_BACKWARD_KIND[ctx.kind], _nbytes(grads[0]), ctx.slots, ctx.repeat)
            acc = None
            for g in grads:
                g = g.to(device=ctx.metas[0][0], dtype=torch.float32)
                acc = g if acc is None else acc + g
            pieces = acc.split([n for _, _, n in ctx.metas], dim=ctx.dim)
            return (None,) * 4 + tuple(p.to(device=d, dtype=dt)
                                       for p, (d, dt, _) in zip(pieces, ctx.metas))


def all_gather(parts: List[torch.Tensor], dim: int, devices, slots=(),
               kind: str = "all-gather") -> tuple:
    """``parts`` (those of ``slots``) joined along ``dim`` onto each of
    ``devices``, recorded as ``kind``."""
    return _AllGather.apply(dim, tuple(slots), tuple(devices), kind, *parts)


def broadcast(x: torch.Tensor, devices, slots=()) -> tuple:
    """x onto each of ``devices`` (those of ``slots``, recorded as such)."""
    return _Broadcast.apply(x, tuple(slots), *devices)


def reduce_sum(parts: List[torch.Tensor], device, dtype=None, slots=()) -> torch.Tensor:
    """The float32 sum of ``parts`` (those of ``slots``) on ``device``."""
    return _Reduce.apply(torch.device(device), dtype or parts[0].dtype, tuple(slots), *parts)


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


def model_dim(arr):
    """The dim of ``arr`` (a ``SlotArray`` or a ``NamedSharding``) sharded
    over "model" (alone), or None."""
    spec = getattr(arr, "sharding", arr).spec
    for i, entry in enumerate(spec):
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
    is leaf k as slot s's program sees it: gathered over the data axes, and
    with ``whole`` over "model" too (a leaf every model slot needs whole),
    recorded as an all-gather of slot s's block.  The gather joins the
    blocks of slot s's group in autograd, so each block's gradient is the
    sum of every model slot's for it; the backward is recorded as the
    reduce-scatter of the gathered gradient."""

    def __init__(self, arrs: Dict[str, SlotArray], blocks: Dict[str, list]):
        self.arrs, self.blocks = arrs, blocks

    def local(self, k: str, s: int, whole: bool = False) -> torch.Tensor:
        sh = self.arrs[k].sharding
        keep = () if whole else ("model",)
        if not any(a not in keep for e in sh.spec for a in _names(e)):
            return sh.local_view(self.blocks[k], s, keep=keep)
        with torch.profiler.record_function(COLLECTIVE):
            note("all-gather", _nbytes(self.blocks[k][s]), (s,))
            return _Gathered.apply(sh.local_view(self.blocks[k], s, keep=keep), s)

    def slot(self, s: int, whole=()) -> dict:
        return {k: self.local(k, s, k in whole) for k in self.arrs}


# --------------------------------------------------------------------------
# the slot program
# --------------------------------------------------------------------------

def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the one-device model lacks: the slot program runs
    every preset the one-device model runs."""
    T._check_supported(cfg)


def _placed_layers(params: list, compute: list, kinds) -> list:
    """Each layer's sublayers as ``_Placed`` (an ``rwkv`` layer's flat dict
    as one)."""
    return [{"rwkv": _Placed(lp, lc)} if kind == "rwkv" else {k: _Placed(lp[k], lc[k]) for k in lp}
            for kind, lp, lc in zip(kinds, params, compute)]


class _Program:
    """Placed parameters as the slot programs read them: the mesh's data
    groups, each sublayer's leaves with their compute copies (float leaves
    cast to the activation dtype), and the embedding's masters, which the
    unembedding uses uncast, as the reference's does; an encoder-decoder's
    encoder layers and norm (``enc_layers``, ``enc_norm``) and a VLM's
    projector (``proj``), None elsewhere."""

    def __init__(self, params, cfg: ModelConfig):
        check_supported(cfg)
        first = tree_leaves(params)[0]
        self.mesh = first.sharding.mesh
        self.groups = groups_of(first.sharding)
        self.plan = T.layer_plan(cfg)
        dt = cfg.activation_dtype()

        def cast(b):
            return b.to(dt) if b.is_floating_point() and b.dtype != dt else b

        compute = tree_map(lambda a: [cast(b) for b in a.blocks], params)
        self.emb_c = _Placed(params["embed"], compute["embed"])
        self.emb_m = _Placed(params["embed"], {k: a.blocks for k, a in params["embed"].items()})
        self.fnorm = _Placed(params["final_norm"], compute["final_norm"])
        self.layers = _placed_layers(params["layers"], compute["layers"], self.plan.kinds)
        self.enc_layers = self.enc_norm = self.proj = None
        if cfg.n_encoder_layers:
            enc, enc_c = params["encoder"], compute["encoder"]
            self.enc_plan = T.encoder_plan(cfg)
            self.enc_layers = _placed_layers(enc["layers"], enc_c["layers"], self.enc_plan.kinds)
            self.enc_norm = _Placed(enc["norm"], enc_c["norm"])
        if cfg.n_patches:
            self.proj = _Placed(params["mm_projector"], compute["mm_projector"])

    def rows(self, cfg: ModelConfig, n: int) -> List[slice]:
        """Each data group's rows of a global batch of ``n``: its share where
        ``act_batch`` resolves for ``n``, else all of them (replicated)."""
        if self.ctx(cfg).spec(("act_batch",), (n,))[0] is None:
            return [slice(0, n)] * self.groups.n_data
        r = n // self.groups.n_data
        return [slice(d * r, (d + 1) * r) for d in range(self.groups.n_data)]

    def ctx(self, cfg: ModelConfig) -> ShardingCtx:
        return ShardingCtx.for_mesh(self.mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)


def _global(x):
    """A global tensor from a placed input, or the input itself."""
    return x.gather() if isinstance(x, SlotArray) else x


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
    return reduce_sum(outs, groups.devices[d][0], slots=groups.slots[d]) if sharded else outs[0]


def _rep_heads(kv, cfg: ModelConfig, m: int, hl: int):
    """K or V repeated to one head per query head, slot m's ``hl`` sliced."""
    return kv.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=2)[:, :, m * hl:(m + 1) * hl]


def _attention(p: dict, cfg: ModelConfig, h, kind: str, m: int, n_model: int,
               q_sharded: bool, kv_sharded: bool, kv_input=None):
    """Slot m's part of self-attention, or with ``kv_input`` (the encoder's
    output) of cross-attention: (its share of ``wo``'s output — the whole
    output where nothing shards —, its K, its V), K/V of the slot's KV heads
    (all of them where they replicate), roped for self-attention alone."""
    hd = cfg.hd
    hl = cfg.n_heads // n_model if q_sharded else cfg.n_heads
    gl = cfg.n_kv_heads // n_model if kv_sharded else cfg.n_kv_heads
    if kv_input is None:
        pos = torch.arange(h.shape[1], device=h.device)[None, :]
        q, k, v = L._qkv(p, cfg, h, h, pos, pos)
    else:
        q, k, v = L._qkv(p, cfg, h, kv_input, None, None, use_rope=False)
    ka, va = k, v
    if q_sharded and not kv_sharded:
        ka, va, gl = _rep_heads(k, cfg, m, hl), _rep_heads(v, cfg, m, hl), hl
    lcfg = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=gl, head_dim=hd)
    out = (L.self_attend(lcfg, q, ka, va, kind=kind) if kv_input is None else
           L.cross_attend(lcfg, q, ka, va))
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), k, v


def _mlp_layout(mlp: _Placed, cfg: ModelConfig) -> bool:
    """Whether the MLP shards d_ff over "model"."""
    down = "w_out" if cfg.gelu_mlp else "w_down"
    f_sh = _check_model_dim(mlp.arrs[down], down, 0)
    for k in mlp.arrs:
        if k != down and _check_model_dim(mlp.arrs[k], k, 1) != f_sh:
            raise ValueError("the MLP's weights must shard d_ff together")
    return f_sh


def _together(arrs: Dict[str, SlotArray], dims: Dict[str, int], what: str) -> bool:
    """Whether the leaves ``dims`` names shard over "model", each on its dim
    there, all or none of them."""
    got = {_check_model_dim(arrs[k], k, dim) for k, dim in dims.items()}
    if len(got) > 1:
        raise ValueError(f"{what} must shard over 'model' together")
    return got.pop()


_RWKV_CHANNELS = {**{k: 1 for k in ("wr", "wk", "wv", "wg", "wo", "cm_r", "wd_b")},
                  **{k: 0 for k in rwkv_lib._MU + ("w0", "ln_scale", "ln1", "ln2", "cm_mu_k",
                                                   "cm_mu_r")}}
_RWKV_WHOLE = rwkv_lib._MU + ("ln1", "ln2", "cm_mu_k", "cm_mu_r")   # every slot's, whole


_MOE_LAYOUTS = {"ep": {"router": 1, "w_gate": 0, "w_up": 0, "w_down": 0},
                "tp": {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1},
                None: {"router": None, "w_gate": None, "w_up": None, "w_down": None}}


def _moe_layout(moe: _Placed):
    """The MoE layer's split over "model": ``"ep"`` (e/M whole experts a
    slot, the router by columns), ``"tp"`` (the ``expert_mlp`` fallback:
    d_expert split, the router whole) or None (whole)."""
    got = {k: model_dim(a) for k, a in moe.arrs.items()}
    for layout, want in _MOE_LAYOUTS.items():
        if got == want:
            return layout
    raise ValueError(f"the MoE layer's weights split over 'model' on dims {got}; the slot "
                     f"program takes {list(_MOE_LAYOUTS.values())}")


def _ffn_layout(lp: Dict[str, _Placed], cfg: ModelConfig):
    """The MoE layer's layout, or whether the MLP shards d_ff."""
    return _moe_layout(lp["moe"]) if "moe" in lp else _mlp_layout(lp["mlp"], cfg)


def _layout(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str) -> tuple:
    """One layer's split over "model", the MLP's (``_ffn_layout``) last: (Q
    sharded, K/V sharded, MLP) for attention; (rnn_d sharded, MLP) for
    ``rglru``; (channels sharded, heads sharded, d_ff sharded) for
    ``rwkv``.  A leaf shards on the dim the program expects, or not at
    all."""
    if kind == "rwkv":
        arrs = lp["rwkv"].arrs
        tp = _together(arrs, _RWKV_CHANNELS, "the rwkv layer's channel leaves")
        heads = _check_model_dim(arrs["u"], "u", 0)
        _check_model_dim(arrs["wd_a"], "wd_a", -1)
        if heads and not tp:
            raise ValueError("rwkv's u shards its heads where its channels do not")
        return tp, heads, _together(arrs, {"cm_k": 1, "cm_v": 0}, "rwkv's cm_k and cm_v")
    if kind == "rglru":
        dims = {"w_in": 1, "w_gate": 1, "conv": 1, "w_out": 0,
                **{k: 0 for k in ("lam", "w_i", "b_i", "w_a", "b_a")}}
        return (_together(lp["rglru"].arrs, dims, "the RG-LRU's rnn_d leaves"),
                _ffn_layout(lp, cfg))
    return _attn_layout(lp["attn"]) + (_ffn_layout(lp, cfg),)


def _attn_layout(attn: _Placed) -> tuple:
    """(Q sharded, K/V sharded) over "model", by heads, of a self- or
    cross-attention."""
    q_sh = _check_model_dim(attn.arrs["wq"], "wq", 1)
    kv_sh = _check_model_dim(attn.arrs["wk"], "wk", 1)
    if _check_model_dim(attn.arrs["wo"], "wo", 0) != q_sh or (kv_sh and not q_sh):
        raise ValueError("wq and wo shard their heads together, and K/V only with them")
    return q_sh, kv_sh


def _attn_block(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str, groups: Groups, d: int, x,
                layout):
    """x + attention for data group d, and each slot's (K, V)."""
    q_sh, kv_sh, _ = layout
    slots, devs = groups.slots[d], groups.devices[d]
    outs, kvs = [], []
    for m, (s, xs) in enumerate(zip(slots, broadcast(x, devs, slots))):
        hn = L.apply_norm(lp["norm1"].slot(s), cfg, xs)
        out, k, v = _attention(lp["attn"].slot(s), cfg, hn, kind, m, groups.n_model, q_sh, kv_sh)
        outs.append(out)
        kvs.append((k, v))
    return x + (reduce_sum(outs, devs[0], slots=slots) if q_sh else outs[0]), kvs


def _cross_block(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, d: int, x, eos: list):
    """x + cross-attention for data group d over its encoder output ``eos``
    (one copy a slot), and each slot's cross (K, V) of its KV heads."""
    q_sh, kv_sh = _attn_layout(lp["xattn"])
    slots, devs = groups.slots[d], groups.devices[d]
    outs, kvs = [], []
    for m, (s, xs, eo) in enumerate(zip(slots, broadcast(x, devs, slots), eos)):
        hx = L.apply_norm(lp["normx"].slot(s), cfg, xs)
        out, k, v = _attention(lp["xattn"].slot(s), cfg, hx, "cross", m, groups.n_model, q_sh,
                               kv_sh, kv_input=eo)
        outs.append(out)
        kvs.append((k, v))
    return x + (reduce_sum(outs, devs[0], slots=slots) if q_sh else outs[0]), kvs


def _mlp_block(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, d: int, x, f_sh: bool):
    """x + the MLP for data group d."""
    slots, devs = groups.slots[d], groups.devices[d]
    outs = []
    for s, xs in zip(slots, broadcast(x, devs, slots)):
        hn = L.apply_norm(lp["norm2"].slot(s), cfg, xs)
        outs.append(L.apply_mlp(lp["mlp"].slot(s), cfg, hn))
    return x + (reduce_sum(outs, devs[0], slots=slots) if f_sh else outs[0])


# --------------------------------------------------------------------------
# the MoE sublayer
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _MoEPlan:
    """How a step dispatches its ``tokens`` (B·S of the global batch):
    ``cap`` an expert's capacity in a buffer; ``chunks`` the buffers a data
    group's tokens are cut into; ``exchange`` whether positions count over
    the data groups (the count exchange); ``aux`` ``"global"`` (the means
    over every token), ``"mean"`` (the mean of the buffers' aux values) or
    None (not computed)."""
    cap: int
    chunks: int
    exchange: bool
    aux: Optional[str]
    tokens: int


def _moe_plan(prog: "_Program", cfg: ModelConfig, tokens: int, split: bool, *, seq: bool,
              aux: bool) -> Optional[_MoEPlan]:
    """The dispatch of a step over ``tokens`` whose rows ``split`` over the
    data groups (else every group runs them all): a sequence step (``seq``)
    takes the per-data-shard dispatch where ``layers.moe_chunks`` says the
    reference does; a decode step never does."""
    if cfg.moe is None:
        return None
    n = L.moe_chunks(cfg, tokens, prog.groups.n_data) if seq else 1
    if n > 1:
        return _MoEPlan(L._moe_cap(cfg, tokens // n), 1 if split else n, False,
                        "mean" if aux else None, tokens)
    return _MoEPlan(L._moe_cap(cfg, tokens), 1, split, "global" if aux else None, tokens)


def _moe_probs(pl: _Placed, cfg: ModelConfig, groups: Groups, d: int, hns: list, ep: bool):
    """Each model slot's router probabilities (T_d, e), float32, of data
    group d's tokens ``hns`` (one copy a slot): the column blocks' logits
    gathered over the model group where the router shards."""
    slots, devs = groups.slots[d], groups.devices[d]
    if not ep:
        return [L._router_probs({"router": pl.local("router", s)}, h) for s, h in zip(slots, hns)]
    parts = [(h @ pl.local("router", s)).float() for s, h in zip(slots, hns)]
    return [torch.softmax(lg, dim=-1) for lg in all_gather(parts, -1, devs, slots)]


def _moe_rows(pl: _Placed, cfg: ModelConfig, groups: Groups, d: int, layout, hns, sorts, keeps,
              rows: int):
    """The experts' output rows (e·rows, d) of one buffer of data group d on
    its first slot: under EP each slot fills and runs its experts' slice of
    the expert-major buffer and the slices are joined in slot order; under
    the fallback the ``w_down`` partials are summed in float32; whole, slot
    0's."""
    k_top = cfg.moe.top_k
    slots, devs = groups.slots[d], groups.devices[d]
    dm = hns[0].shape[-1]
    outs = []
    for m, (s, h, (order, _, _), (_, slot)) in enumerate(zip(slots, hns, sorts, keeps)):
        p = {k: pl.local(k, s) for k in ("w_gate", "w_up", "w_down")}
        n_e = p["w_gate"].shape[0]
        if layout == "ep":
            lo = m * n_e * rows
            slot = torch.where((slot >= lo) & (slot < lo + n_e * rows), slot - lo, n_e * rows)
        buf = L._buffer(h, order, k_top, slot, n_e * rows).reshape(n_e, rows, dm)
        outs.append(L._experts(p, buf).reshape(n_e * rows, dm))
    if layout == "ep":
        return all_gather(outs, 0, (devs[0],), slots, kind="all-to-all")[0]
    if layout == "tp":
        return reduce_sum(outs, devs[0], slots=slots)
    return outs[0]


def _moe_block(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, ds, xs, layout,
               plan: _MoEPlan):
    """x + the MoE sublayer for each data group of ``ds`` (``xs`` their
    residual streams), the groups in lockstep as the count exchange needs.
    Returns (the new streams, the aux on group 0's first slot or None)."""
    pl = lp["moe"]
    e = cfg.moe.n_experts
    every = [s for row in groups.slots for s in row]
    routed = []                     # per group: the slots' tokens, probs, (gates, ids)
    for d, x in zip(ds, xs):
        slots, devs = groups.slots[d], groups.devices[d]
        hns = [L.apply_norm(lp["norm2"].slot(s), cfg, xb).reshape(-1, x.shape[-1])
               for s, xb in zip(slots, broadcast(x, devs, slots))]
        probs = _moe_probs(pl, cfg, groups, d, hns, layout == "ep")
        routed.append((hns, probs, [L._route(cfg, p) for p in probs]))

    # Each buffer's assignments sorted by expert on each slot; a group's
    # offsets from the counts of the groups before it.
    n_tok = routed[0][0][0].shape[0]
    tc = n_tok // plan.chunks
    cuts = [slice(c * tc, (c + 1) * tc) for c in range(plan.chunks)]
    sorts = [[[L._sort(cfg, eidx[cut]) for _, eidx in routes] for cut in cuts]
             for _, _, routes in routed]
    offsets = [None] * len(ds)
    if plan.exchange:
        with torch.profiler.record_function(COLLECTIVE):
            starts = [g[0][0][2] for g in sorts]      # each group's first slot's
            counts = [torch.diff(st, append=st.new_full((1,), tc * cfg.moe.top_k))
                      for st in starts]
            note("all-gather", _nbytes(counts[0]), every)
            dev0 = lambda j: groups.devices[ds[j]][0]
            offsets = [None] + [torch.stack([c.to(dev0(j)) for c in counts[:j]]).sum(0)
                                for j in range(1, len(ds))]
    rows = min(plan.cap, tc)
    outs, auxes = [], []
    for j, (d, x) in enumerate(zip(ds, xs)):
        hns, probs, routes = routed[j]
        parts = []
        for c, cut in enumerate(cuts):
            srt = sorts[j][c]
            keeps = [L._keep(cfg, se, starts, plan.cap, rows,
                             None if offsets[j] is None else offsets[j].to(se.device))
                     for _, se, starts in srt]
            of = _moe_rows(pl, cfg, groups, d, layout, [h[cut] for h in hns], srt, keeps, rows)
            gates = routes[0][0][cut]
            parts.append(L._combine(of, keeps[0][0], keeps[0][1], gates, srt[0][0],
                                    cfg.moe.top_k))
            if plan.aux == "mean":
                top1 = routes[0][1][cut, 0]
                auxes.append(L._aux(cfg, F.one_hot(top1, e).float().mean(0),
                                    probs[0][cut].mean(0)))
        outs.append(x + torch.cat(parts).reshape(x.shape))
        if plan.aux == "global":
            auxes.append(torch.stack([F.one_hot(routes[0][1][:, 0], e)
                                      .float().sum(0), probs[0].sum(0)]))
    if plan.aux is None:
        return tuple(outs), None
    dev = groups.devices[ds[0]][0]
    if plan.aux == "global":
        if plan.exchange:
            sums, n = reduce_sum(auxes, dev, slots=every), plan.tokens
        else:
            sums, n = auxes[0], n_tok
        return tuple(outs), L._aux(cfg, sums[0] / n, sums[1] / n)
    if plan.chunks > 1:             # the rows do not split: group 0's chunks
        return tuple(outs), torch.stack(auxes[:plan.chunks]).mean()
    return tuple(outs), reduce_sum(auxes, dev, slots=every) / groups.n_data


def _ffn(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, ds, xs, layout,
         moe: Optional[_MoEPlan]):
    """x + the MLP (or the MoE sublayer) for each data group of ``ds``:
    (the new streams, the MoE aux or None)."""
    if "moe" in lp:
        return _moe_block(lp, cfg, groups, ds, xs, layout, moe)
    return tuple(_mlp_block(lp, cfg, groups, d, x, layout) for d, x in zip(ds, xs)), None


def _lockstep(groups: Groups, cfg: ModelConfig) -> list:
    """The lists of data groups whose programs advance together, one layer
    at a time: all of them where MoE layers exchange between the groups,
    else each alone."""
    ds = list(_data_groups(groups))
    return [ds] if cfg.moe is not None else [[d] for d in ds]


def _join(parts: list, sharded: bool, device, slots):
    """A row's channel slices, one a model slot, joined on ``device``; slot
    0's whole tensor where the channels do not shard."""
    return all_gather(parts, -1, (device,), slots)[0] if sharded else parts[0]


def _state_whole(arr: SlotArray, slots, devs) -> list:
    """Each model slot's copy of a recurrent state leaf whole over "model"
    (its channel blocks gathered over the group where dim 1 shards)."""
    blocks = [arr.blocks[s] for s in slots]
    if _check_model_dim(arr, "a recurrent state", 1):
        return list(all_gather(blocks, 1, devs, slots))
    return blocks


def _rglru_block(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, d: int, x, layout,
                 state: Optional[dict] = None):
    """x + the RG-LRU mixer for data group d, channel-parallel over rnn_d
    (``w_out`` row-parallel, summed in float32 before the residual add),
    from ``state`` (the layer's placed ``{"h", "conv"}``; zeros where None).
    Returns (x, each slot's new ``{"h", "conv"}``: its own channels)."""
    slots, devs = groups.slots[d], groups.devices[d]
    outs, states = [], []
    for s, xs in zip(slots, broadcast(x, devs, slots)):
        hn = L.apply_norm(lp["norm1"].slot(s), cfg, xs)
        p = lp["rglru"].slot(s)
        st = None if state is None else {k: a.blocks[s] for k, a in state.items()}
        out, new = rglru_lib.rglru_forward(
            p, dataclasses.replace(cfg, rnn_width=p["w_in"].shape[1]), hn, st)
        outs.append(out)
        states.append(new)
    return x + (reduce_sum(outs, devs[0], slots=slots) if layout[0] else outs[0]), states


def _rwkv_block(pl: _Placed, cfg: ModelConfig, groups: Groups, d: int, x, layout,
                state: Optional[dict] = None):
    """An RWKV-6 layer for data group d: x -> x + time mix + channel mix
    (``rwkv6.rwkv_forward``'s output) from ``state`` (the layer's placed
    ``{"wkv", "shift_tm", "shift_cm"}``; zeros where None).  Returns (x, each
    slot's new state: ``wkv`` of its heads — all of them where they straddle
    the slots —, ``shift_tm`` / ``shift_cm`` whole)."""
    tp, heads_sh, f_sh = layout
    slots, devs = groups.slots[d], groups.devices[d]
    hd, dt = cfg.rnn_head_dim, x.dtype
    b, t = x.shape[:2]
    whole = _RWKV_WHOLE + (() if heads_sh else ("ln_scale",))
    ps = [pl.slot(s, whole) for s in slots]
    zero = torch.zeros((b, cfg.d_model), dtype=dt, device=x.device)
    shift_tm, shift_cm = ((_state_whole(state[k], slots, devs) for k in ("shift_tm", "shift_cm"))
                          if state is not None else ([zero.to(dv) for dv in devs],) * 2)
    heads = lambda y: y.reshape(b, t, y.shape[-1] // hd, hd)

    def scan(m, r, k, v, w):
        p = ps[m]
        st0 = (torch.zeros((b, r.shape[-1] // hd, hd, hd), dtype=torch.float32, device=r.device)
               if state is None else state["wkv"].blocks[slots[m]])
        return rwkv_lib.wkv(heads(r), heads(k), heads(v), heads(w), p["u"], st0,
                            min(cfg.rnn_chunk, t))

    # ---- time mix: r/k/v/g/w of the slot's channels ------------------------
    xns, ins = [], []
    for m, xs in enumerate(broadcast(x, devs, slots)):
        xn = rwkv_lib._rms(xs, ps[m]["ln1"])
        xns.append(xn)
        ins.append(rwkv_lib.time_mix_in(ps[m], xn, rwkv_lib.shifted(xn, shift_tm[m])))
    wkvs, ygs = [], []
    if heads_sh or not tp:          # whole heads on each slot: its own
        for m, (r, k, v, g, w) in enumerate(ins):
            y, st = scan(m, r, k, v, w)
            wkvs.append(st)
            ygs.append(rwkv_lib.heads_out(y, g, ps[m]["ln_scale"], hd, dt))
        if tp:
            ygs = all_gather(ygs, -1, devs, slots)
    else:                           # heads straddle the slots: every slot scans all
        r_, k_, v_, g_, w_ = (all_gather([i[j] for i in ins], -1, devs, slots) for j in range(5))
        for m in range(len(slots)):
            y, st = scan(m, r_[m], k_[m], v_[m], w_[m])
            wkvs.append(st)
            ygs.append(rwkv_lib.heads_out(y, g_[m], ps[m]["ln_scale"], hd, dt))
    x2 = x + _join([yg @ p["wo"] for yg, p in zip(ygs, ps)], tp, devs[0], slots)

    # ---- channel mix ---------------------------------------------------------
    x2ns, cms, rrs = [], [], []
    for m, xs in enumerate(broadcast(x2, devs, slots)):
        x2n = rwkv_lib._rms(xs, ps[m]["ln2"])
        x2ns.append(x2n)
        kk, rr = rwkv_lib.channel_mix_in(ps[m], x2n, rwkv_lib.shifted(x2n, shift_cm[m]))
        cms.append(kk @ ps[m]["cm_v"])
        rrs.append(rr)
    cm = reduce_sum(cms, devs[0], slots=slots) if f_sh else cms[0]
    out = x2 + _join(rrs, tp, devs[0], slots) * cm
    return out, [{"wkv": w, "shift_tm": xn[:, -1], "shift_cm": x2n[:, -1]}
                 for w, xn, x2n in zip(wkvs, xns, x2ns)]


def _layer(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str, groups: Groups, ds,
           moe: Optional[_MoEPlan], eos: Optional[list], *xs):
    """One layer for the data groups ``ds`` (x -> x + mixer, then + the
    cross-attention over ``eos`` — per group, its encoder output's copies,
    one a slot — where given, then + mlp; an ``rwkv`` layer holds both):
    (the new streams, the MoE aux or None)."""
    layout = _layout(lp, cfg, kind)
    if kind == "rwkv":
        return tuple(_rwkv_block(lp["rwkv"], cfg, groups, d, x, layout)[0]
                     for d, x in zip(ds, xs)), None
    mixed = [(_rglru_block(lp, cfg, groups, d, x, layout) if kind == "rglru" else
              _attn_block(lp, cfg, kind, groups, d, x, layout))[0] for d, x in zip(ds, xs)]
    if eos is not None:
        mixed = [_cross_block(lp, cfg, groups, d, x, eo)[0] for d, x, eo in zip(ds, mixed, eos)]
    return _ffn(lp, cfg, groups, ds, mixed, layout[-1], moe)


def _side_inputs(cfg: ModelConfig, device, frames, patches):
    """(frames, patches) as global tensors on ``device`` (placed ones
    gathered), each None where not given or where the config has no
    encoder / no ``n_patches``: the reference ignores them there."""
    def get(x, used):
        if x is None or not used:
            return None
        x = _global(x)
        return torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)

    return get(frames, cfg.n_encoder_layers), get(patches, cfg.n_patches)


def _encode(prog: _Program, cfg: ModelConfig, frames, cuts: List[slice], ds, remat: bool) -> list:
    """``transformer.encode`` for each data group of ``ds`` over its rows
    of ``frames``, cast to the activation dtype: the ``enc-attn`` layers
    (split over "model" as the decoder's are; each of the layers the
    reference scans under a checkpoint when ``remat``), the norm on the
    group's first slot, the output copied to the group's slots.  Returns,
    per group, the copies (one a slot)."""
    groups, plan = prog.groups, prog.enc_plan
    xs = tuple(frames[cuts[d]].to(groups.devices[d][0], cfg.activation_dtype()) for d in ds)
    for i, lp in enumerate(prog.enc_layers):
        fn = _scoped(i, plan, functools.partial(_layer, lp, cfg, T.ENCODER_KIND, groups, ds,
                                                None, None))
        xs, _ = (checkpoint(fn, *xs, use_reentrant=False) if (remat and i < plan.n_groups)
                 else fn(*xs))
    out = []
    for d, x in zip(ds, xs):
        slots = groups.slots[d]
        eo = L.apply_norm(prog.enc_norm.slot(slots[0]), cfg, x)
        out.append(list(broadcast(eo, groups.devices[d], slots)))
    return out


def _project(prog: _Program, cfg: ModelConfig, patches, d: int):
    """Data group d's ``patches`` through the VLM projector, on its first
    slot's device: cast to the activation dtype and copied to the group's
    slots, GELU(patches · w1's columns) · w2's rows on each slot (d_model
    split over "model" where their specs split it), the partials summed in
    float32 and rounded once."""
    groups = prog.groups
    sharded = _together(prog.proj.arrs, {"w1": 1, "w2": 0}, "the projector's w1 and w2")
    slots, devs = groups.slots[d], groups.devices[d]
    x = patches.to(devs[0], cfg.activation_dtype())
    outs = [L._gelu_tanh(xs @ prog.proj.local("w1", s)) @ prog.proj.local("w2", s)
            for s, xs in zip(slots, broadcast(x, devs, slots))]
    return reduce_sum(outs, devs[0], slots=slots) if sharded else outs[0]


def _inputs(prog: _Program, cfg: ModelConfig, tokens, patches, cut: slice, d: int):
    """Data group d's rows ``cut`` embedded on its first slot's device, a
    VLM's projected patches before the tokens (positions 0 … P−1)."""
    x = _embed(prog.emb_c, cfg, tokens[cut], prog.groups, d)
    if patches is None:
        return x
    return torch.cat([_project(prog, cfg, patches[cut], d), x], 1)


def _final_hidden(prog: _Program, cfg: ModelConfig, d: int, x) -> list:
    """The final norm of data group d's residual stream, on each slot."""
    slots = prog.groups.slots[d]
    return [L.apply_norm(prog.fnorm.slot(s), cfg, xs)
            for s, xs in zip(slots, broadcast(x, prog.groups.devices[d], slots))]


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
            mxs = [lg.detach().amax(-1) for lg in logits]
            note("all-reduce", _nbytes(mxs[0]), slots)
            mx = torch.stack([a.to(dev0) for a in mxs]).amax(0)
        ses, golds = [], []
        for m, lg in enumerate(logits):
            mxm = mx.to(lg.device)
            ses.append(torch.exp(lg - mxm[..., None]).sum(-1))
            vl = lg.shape[-1]
            local = labels.to(lg.device) - m * vl
            ok = (local >= 0) & (local < vl)
            g = torch.gather(lg, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
            golds.append(torch.where(ok, g, torch.zeros((), dtype=g.dtype, device=g.device)))
        lse = mx + torch.log(reduce_sum(ses, dev0, slots=slots))
        return lse - reduce_sum(golds, dev0, slots=slots)

    return nll


def loss_fn(params, cfg: ModelConfig, batch):
    """``transformer.loss_fn`` over placed parameters: (loss, {"xent",
    "moe_aux"}) on slot 0's device.  ``batch`` holds global tensors
    (``tokens``, ``labels``, optional ``loss_mask``, ``frames``, ``patches``)
    whose rows split over the data groups where ``act_batch`` resolves (else
    each group runs them all and group 0's count).  Each scanned layer of a
    data group (of all of them in lockstep where MoE layers exchange between
    the groups) runs under a checkpoint when ``cfg.remat`` is set and
    gradients are on, as the one-device forward does in training, the
    encoder's scanned layers too; ``moe_aux`` is the MoE layers' aux summed
    in float32.  With patches the last ``labels.shape[1]`` positions are
    scored, as the reference's.  An unsharded vocabulary's logits are
    computed on the group's slot 0 alone (no other copy would reach the
    loss)."""
    prog = _Program(params, cfg)
    groups, plan = prog.groups, prog.plan
    dev = groups.devices[0][0]
    tokens = T._tokens(batch["tokens"], dev)
    labels = T._tokens(batch["labels"], dev)
    frames, patches = _side_inputs(cfg, dev, batch.get("frames"), batch.get("patches"))
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=labels.device) if mask is None
            else torch.as_tensor(mask, device=labels.device).float())
    cuts = prog.rows(cfg, tokens.shape[0])
    n_scanned = plan.n_groups * len(plan.pattern)
    use_remat = cfg.remat and torch.is_grad_enabled()
    seq = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    moe = _moe_plan(prog, cfg, tokens.shape[0] * seq, cuts[0] != cuts[-1], seq=True, aux=True)

    tots, cnts = [], []
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for ds in _lockstep(groups, cfg):
        eos = None if frames is None else _encode(prog, cfg, frames, cuts, ds, use_remat)
        xs = tuple(_inputs(prog, cfg, tokens, patches, cuts[d], d) for d in ds)
        for i, kind in enumerate(plan.kinds):
            fn = _scoped(i, plan, functools.partial(_layer, prog.layers[i], cfg, kind, groups, ds,
                                                    moe, eos))
            xs, aux_i = T._remat(cfg, fn)(*xs) if (use_remat and i < n_scanned) else fn(*xs)
            if aux_i is not None:
                aux = aux + aux_i
        for d, x in zip(ds, xs):
            dev0 = groups.devices[d][0]
            if cfg.n_patches and "patches" in batch:
                x = x[:, x.shape[1] - labels.shape[1]:]
            hs = _final_hidden(prog, cfg, d, x)
            tot, cnt = L.chunked_nll(_nll_fn(prog.emb_m, cfg, groups, d), hs,
                                     labels[cuts[d]].to(dev0), mask[cuts[d]].to(dev0),
                                     cfg.xent_chunk)
            tots.append(tot)
            cnts.append(cnt)
    note("all-reduce", 2 * _nbytes(tots[0]), range(len(prog.mesh.slot_devices)))
    if cuts[0] == cuts[-1]:         # every data group ran every row: count them once
        tots, cnts = tots[:1], cnts[:1]
    xent = sum(t.to(dev) for t in tots) / torch.clamp(sum(c.to(dev) for c in cnts), min=1.0)
    return xent + 0.01 * aux, {"xent": xent, "moe_aux": aux}


# --------------------------------------------------------------------------
# serving: prefill and decode over a placed cache
# --------------------------------------------------------------------------

def _logits(prog: _Program, cfg: ModelConfig, b: int, hidden: list):
    """The logits of each slot's last hidden state (r, D), placed as
    ``("act_batch", "act_vocab")``: a slot's vocab slice, or the whole
    vocabulary where the embedding does not shard it."""
    key = "tok" if cfg.tie_embeddings else "unembed"
    sharded = _check_model_dim(prog.emb_m.arrs[key], key, 0 if cfg.tie_embeddings else 1)
    sh = prog.ctx(cfg).named(("act_batch", "act_vocab"), (b, cfg.vocab_size))
    if (len(sh.spec) > 1 and sh.spec[1] == "model") != sharded:
        raise ValueError(f"the logits' spec {sh.spec} and the embedding's vocab shards disagree")
    blocks = [L.unembed({key: prog.emb_m.local(key, s)}, cfg, hidden[s][:, None])[:, 0]
              for s in range(len(prog.mesh.slot_devices))]
    return SlotArray(sh, (b, cfg.vocab_size), blocks)


def _block_of(value: torch.Tensor, sharding, s: int, shape) -> torch.Tensor:
    """Slot s's block of a decode-state leaf of global ``shape`` from
    ``value``, what slot s's program computed: its data group's rows, and
    along every other dim either the whole (cut here to the slot's block)
    or the slot's block already."""
    sl = sharding.slices(s, shape)
    idx = [slice(None)]
    for i in range(1, len(shape)):
        if value.shape[i] == shape[i]:
            idx.append(sl[i])
        elif value.shape[i] == sl[i].stop - sl[i].start:
            idx.append(slice(None))
        else:
            raise ValueError(f"a state of dim {i} {value.shape[i]} is neither the whole "
                             f"{shape[i]} nor slot {s}'s block of {sharding.spec}")
    return value[tuple(idx)].clone(memory_format=torch.contiguous_format)


def _cache_dim(sharding, kv_sharded: bool):
    """The dim of a cached K/V (its ``NamedSharding``) sharded over "model":
    2 (its KV heads, where the layer's K/V shard), 1 (its positions) or None
    (whole)."""
    dim = model_dim(sharding)
    if (dim == 2) != kv_sharded:
        raise ValueError(f"the cache's spec {sharding.spec} shards the KV heads where the "
                         f"layer's K/V {'do' if kv_sharded else 'do not'}")
    return dim


def _check_state(st: dict, layout: tuple, kind: str, lp: Dict[str, _Placed]) -> None:
    """A layer's decode-state shardings (``{"kv": ...}`` or ``{"rnn": ...}``,
    an encoder-decoder's ``"cross"`` beside it) against the layer's split
    over "model": a recurrent state shards its channels (heads for ``wkv``)
    where the layer computes them apart; the cross K/V their KV heads where
    the cross-attention's K/V shard, else nothing."""
    if "cross" in st:
        kv_sh = _attn_layout(lp["xattn"])[1]
        for a in st["cross"].values():
            if model_dim(a) != (2 if kv_sh else None):
                raise ValueError(f"the cross cache's spec {a.spec} does not split its KV heads "
                                 f"as the cross-attention's K/V do")
    if kind == "rwkv":
        want = {"wkv": (1, layout[1]), "shift_tm": (1, layout[0]), "shift_cm": (1, layout[0])}
    elif kind == "rglru":
        want = {"h": (1, layout[0]), "conv": (2, layout[0])}
    else:
        for a in st["kv"].values():
            _cache_dim(a, layout[1])
        return
    for k, (dim, sharded) in want.items():
        if model_dim(st["rnn"][k]) != (dim if sharded else None):
            raise ValueError(f"the {kind} state {k}'s spec {st['rnn'][k].spec} does not split "
                             f"as the layer's weights do")


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *, frames=None, patches=None):
    """``transformer.prefill`` over placed parameters: the prompt ``tokens``
    (B, S) — a tensor, or placed by ``act_batch`` —, an encoder-decoder's
    ``frames`` and a VLM's ``patches`` (likewise) run through the slot
    program.  Returns (logits (B, vocab) placed as ``("act_batch",
    "act_vocab")`` — ``.gather()`` joins them —, the cache: per layer its
    ``{"kv": {"k", "v"}}`` or ``{"rnn": ...}``, and with frames its cross
    K/V ``"cross"``, of ``SlotArray``, placed by ``transformer.cache_specs``
    on the parameters' mesh, each slot's block written by that slot).  As in
    the reference, a prefill without frames keeps no cross K/V (decode then
    skips cross-attention), and with patches the cache's positions 0 … P−1
    are the patches', so ``cache_len`` counts them."""
    prog = _Program(params, cfg)
    groups, plan = prog.groups, prog.plan
    dev0 = groups.devices[0][0]
    tokens = T._tokens(_global(tokens), dev0)
    frames, patches = _side_inputs(cfg, dev0, frames, patches)
    b = tokens.shape[0]
    cuts = prog.rows(cfg, b)
    kept = lambda tree: [{g: v for g, v in st.items() if g != "cross" or frames is not None}
                         for st in tree]
    shapes = kept(T.cache_shapes(cfg, b, cache_len))
    shard = prog.ctx(cfg).param_shardings(shapes, kept(T.cache_specs(cfg)))
    n_slots = len(prog.mesh.slot_devices)
    blocks = [{g: {n: [None] * n_slots for n in leaves} for g, leaves in st.items()}
              for st in shapes]
    hidden = [None] * n_slots
    seq = tokens.shape[1] + (0 if patches is None else patches.shape[1])
    moe = _moe_plan(prog, cfg, b * seq, cuts[0] != cuts[-1], seq=True, aux=False)

    def write(i, group, d, per_slot):
        for n, arr in shard[i][group].items():
            for s, v in zip(groups.slots[d], per_slot):
                blocks[i][group][n][s] = _block_of(v[n], arr, s, shapes[i][group][n].shape)

    def layer(i, kind, ds, eos, *xs):
        lp = prog.layers[i]
        layout = _layout(lp, cfg, kind)
        _check_state(shard[i], layout, kind, lp)
        mixed = []
        for j, (d, x) in enumerate(zip(ds, xs)):
            if kind == "rwkv":
                x, states = _rwkv_block(lp["rwkv"], cfg, groups, d, x, layout)
                write(i, "rnn", d, states)
            elif kind == "rglru":
                x, states = _rglru_block(lp, cfg, groups, d, x, layout)
                write(i, "rnn", d, states)
            else:
                x, kvs = _attn_block(lp, cfg, kind, groups, d, x, layout)
                write(i, "kv", d, [{n: T.cache_layout(t, cfg, kind, cache_len)
                                    for n, t in zip(("k", "v"), kv)} for kv in kvs])
            if eos is not None and kind != "rwkv":
                x, xkvs = _cross_block(lp, cfg, groups, d, x, eos[j])
                write(i, "cross", d, [dict(zip(("k", "v"), kv)) for kv in xkvs])
            mixed.append(x)
        if kind == "rwkv":
            return tuple(mixed)
        return _ffn(lp, cfg, groups, ds, mixed, layout[-1], moe)[0]

    for ds in _lockstep(groups, cfg):
        eos = None if frames is None else _encode(prog, cfg, frames, cuts, ds, False)
        xs = tuple(_inputs(prog, cfg, tokens, patches, cuts[d], d) for d in ds)
        for i, kind in enumerate(plan.kinds):
            xs = _scoped(i, plan, functools.partial(layer, i, kind, ds, eos))(*xs)
        for d, x in zip(ds, xs):
            for s, h in zip(groups.slots[d], _final_hidden(prog, cfg, d, x)):
                hidden[s] = h[:, -1]
    cache = [{g: {n: SlotArray(shard[i][g][n], tuple(shapes[i][g][n].shape),
                               _fill_groups(groups, bl)) for n, bl in leaves.items()}
              for g, leaves in blocks[i].items()}
             for i in range(len(plan.kinds))]
    return _logits(prog, cfg, b, _fill_groups(groups, hidden)), cache


def _partial_attend(cfg: ModelConfig, q, k, v, t0: int, last: int):
    """One slot's softmax terms of q (r, 1, H, hd) over its cached positions
    t0 … t0 + T' − 1 (k, v (r, T', G, hd)), those past ``last`` masked as
    ``_gqa_attend`` masks them: (max, sum of exponentials, exponential-
    weighted values), float32, shaped (r, G, rep, 1[, hd])."""
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, sq = q.shape[:2]
    qg = q.reshape(b, sq, g, h // g, hd)
    logits = torch.einsum("bsgrk,btgk->bgrst", qg, k).float()
    logits = logits / math.sqrt(hd)
    keep = (t0 + torch.arange(k.shape[1], device=k.device)) <= last
    logits = logits.masked_fill(~keep, L.MASKED)
    mx = logits.amax(-1)
    p = torch.exp(logits - mx[..., None])
    acc = torch.einsum("bgrst,btgk->bgrsk", p.to(v.dtype), v).float()
    return mx, p.sum(-1), acc


def _seq_attend(cfg: ModelConfig, qs, ck: SlotArray, cv: SlotArray, slots, devs, q_sharded: bool,
                last: int):
    """Attention of the model group's queries over a cache sharded by
    position: each slot's partial terms over its block for every query head
    (Q gathered over the group where it shards), combined in float32 on the
    group's first slot.  Returns (r, 1, H, hd) in the query dtype there."""
    if q_sharded:
        with torch.profiler.record_function(COLLECTIVE):
            note("all-gather", _nbytes(qs[0]), slots)
            qs = [torch.cat([q.to(dv) for q in qs], dim=2) for dv in devs]
    parts = [_partial_attend(cfg, q, ck.blocks[s], cv.blocks[s], m * ck.blocks[s].shape[1], last)
             for m, (s, q) in enumerate(zip(slots, qs))]
    with torch.profiler.record_function(COLLECTIVE):
        mx0, l0, a0 = parts[0]
        note("all-reduce", _nbytes(mx0), slots)
        note("all-reduce", _nbytes(l0) + _nbytes(a0), slots)
        mx = torch.stack([p[0].to(devs[0]) for p in parts]).amax(0)
        l = acc = 0.0
        for p_mx, p_l, p_acc in parts:
            w = torch.exp(p_mx.to(devs[0]) - mx)
            l = l + p_l.to(devs[0]) * w
            acc = acc + p_acc.to(devs[0]) * w[..., None]
    out = acc / l[..., None]                                   # (r, G, rep, 1, hd)
    b = out.shape[0]
    return torch.movedim(out, 3, 1).reshape(b, 1, cfg.n_heads, cfg.hd).to(qs[0].dtype)


def _write_state(st: dict, states: list, slots) -> None:
    """Each slot's new recurrent state written into its blocks of the
    placed ``st``, in place."""
    for n, arr in st.items():
        for s, v in zip(slots, states):
            arr.blocks[s].copy_(_block_of(v[n], arr.sharding, s, arr.shape))


def _decode_layer(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str, groups: Groups, ds,
                  st: dict, pos: int, moe: Optional[_MoEPlan], *xs):
    """One decoder layer of a decode step for the data groups ``ds`` over
    the layer's placed decode state ``st``, updated in place: x1 (r, 1, D)
    -> x1 + mixer (``_decode_mixer``), then + the cross-attention over the
    state's ``"cross"`` K/V where it holds them, then + mlp (an ``rwkv``
    layer holds both)."""
    layout = _layout(lp, cfg, kind)
    _check_state({g: {n: a.sharding for n, a in leaves.items()} for g, leaves in st.items()},
                 layout, kind, lp)
    xs = [_decode_mixer(lp, cfg, kind, groups, d, st, pos, x1, layout) for d, x1 in zip(ds, xs)]
    if kind == "rwkv":
        return tuple(xs)
    if "cross" in st:
        xs = [_decode_cross(lp, cfg, groups, d, st["cross"], x1) for d, x1 in zip(ds, xs)]
    return _ffn(lp, cfg, groups, ds, xs, layout[-1], moe)[0]


def _decode_cross(lp: Dict[str, _Placed], cfg: ModelConfig, groups: Groups, d: int, cross: dict,
                  x1):
    """x1 + data group d's cross-attention of a decode step: each slot's
    unroped query heads over its blocks of the placed cross K/V (read, never
    written), ``wo``'s partials summed where the heads shard."""
    q_sh, kv_sh = _attn_layout(lp["xattn"])
    slots, devs = groups.slots[d], groups.devices[d]
    hl = cfg.n_heads // groups.n_model if q_sh else cfg.n_heads
    outs = []
    for m, (s, xs) in enumerate(zip(slots, broadcast(x1, devs, slots))):
        hx = L.apply_norm(lp["normx"].slot(s), cfg, xs)
        q = torch.einsum("bsd,dhk->bshk", hx, lp["xattn"].local("wq", s))
        k, v = cross["k"].blocks[s], cross["v"].blocks[s]
        if q_sh and not kv_sh:
            k, v = _rep_heads(k, cfg, m, hl), _rep_heads(v, cfg, m, hl)
        lcfg = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=k.shape[2], head_dim=cfg.hd)
        outs.append(torch.einsum("bshk,hkd->bsd", L.cross_attend(lcfg, q, k, v),
                                 lp["xattn"].local("wo", s)))
    return x1 + (reduce_sum(outs, devs[0], slots=slots) if q_sh else outs[0])


def _decode_mixer(lp: Dict[str, _Placed], cfg: ModelConfig, kind: str, groups: Groups, d: int,
                  st: dict, pos: int, x1, layout):
    """Data group d's mixer of a decode step: a recurrent layer's state
    blocks rewritten (an ``rwkv`` layer's channel mix too); an attention
    layer's new K/V written on the slot that holds position ``pos``."""
    slots = groups.slots[d]
    if kind in ("rwkv", "rglru"):
        block = _rwkv_block if kind == "rwkv" else _rglru_block
        x1, states = block(lp["rwkv"] if kind == "rwkv" else lp, cfg, groups, d, x1, layout,
                           st["rnn"])
        _write_state(st["rnn"], states, slots)
        return x1
    q_sh, kv_sh, _ = layout
    ck, cv = st["kv"]["k"], st["kv"]["v"]
    cdim = model_dim(ck.sharding)
    devs = groups.devices[d]
    n_model, r = groups.n_model, x1.shape[0]
    hl = cfg.n_heads // n_model if q_sh else cfg.n_heads
    gl = cfg.n_kv_heads // n_model if kv_sh else cfg.n_kv_heads
    t_cache = ck.shape[1]
    at = pos % t_cache if kind == "local" else pos
    last = min(pos, t_cache - 1) if kind == "local" else pos

    qs = []
    for m, (s, xs) in enumerate(zip(slots, broadcast(x1, devs, slots))):
        hn = L.apply_norm(lp["norm1"].slot(s), cfg, xs)
        posb = torch.full((r, 1), pos, dtype=torch.int32, device=xs.device)
        q, k1, v1 = L._qkv(lp["attn"].slot(s), cfg, hn, hn, posb, posb)
        kb, vb = ck.blocks[s], cv.blocks[s]
        t0 = m * kb.shape[1] if cdim == 1 else 0
        if t0 <= at < t0 + kb.shape[1]:
            kb[:, at - t0] = k1[:, 0]
            vb[:, at - t0] = v1[:, 0]
        qs.append(q)

    wo = [lp["attn"].local("wo", s) for s in slots]
    if cdim == 1:
        out = _seq_attend(cfg, qs, ck, cv, slots, devs, q_sh, last)
        if q_sh:
            outs = [torch.einsum("bshk,hkd->bsd", out[:, :, m * hl:(m + 1) * hl].to(devs[m]), wo[m])
                    for m in range(n_model)]
            x1 = x1 + reduce_sum(outs, devs[0], slots=slots)
        else:
            x1 = x1 + torch.einsum("bshk,hkd->bsd", out, wo[0])
    else:
        outs = []
        for m, s in enumerate(slots):
            k, v, g_eff = ck.blocks[s], cv.blocks[s], gl
            if q_sh and not kv_sh:
                k, v, g_eff = _rep_heads(k, cfg, m, hl), _rep_heads(v, cfg, m, hl), hl
            lcfg = dataclasses.replace(cfg, n_heads=hl, n_kv_heads=g_eff, head_dim=cfg.hd)
            t = k.shape[1]
            mask = (torch.arange(t, device=k.device) <= last)[None, None, :].expand(r, 1, t)
            out = L._gqa_attend(lcfg, qs[m], k, v, mask)
            outs.append(torch.einsum("bshk,hkd->bsd", out, wo[m]))
        x1 = x1 + (reduce_sum(outs, devs[0], slots=slots) if q_sh else outs[0])
    return x1


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """``transformer.decode_step`` over placed parameters and a placed
    cache (``prefill``'s, or one placed by ``transformer.cache_specs``):
    ``token`` (B,) — a tensor, or placed by ``act_batch`` —, ``pos`` the
    absolute position (an int, a 0-d tensor, or a replicated ``SlotArray``).
    Writes the token's K/V (a recurrent layer's new state) into the
    cache's blocks in place and returns
    (logits (B, vocab) placed as ``("act_batch", "act_vocab")``, cache)."""
    prog = _Program(params, cfg)
    groups, plan = prog.groups, prog.plan
    pos = int(_global(pos))
    tokens = T._tokens(_global(token), groups.devices[0][0])
    b = tokens.shape[0]
    cuts = prog.rows(cfg, b)
    hidden = [None] * len(prog.mesh.slot_devices)
    moe = _moe_plan(prog, cfg, b, cuts[0] != cuts[-1], seq=False, aux=False)
    for ds in _lockstep(groups, cfg):
        xs = tuple(_embed(prog.emb_c, cfg, tokens[cuts[d], None], groups, d) for d in ds)
        for i, kind in enumerate(plan.kinds):
            fn = functools.partial(_decode_layer, prog.layers[i], cfg, kind, groups, ds,
                                   cache[i], pos, moe)
            xs = _scoped(i, plan, fn)(*xs)
        for d, x1 in zip(ds, xs):
            for s, h in zip(groups.slots[d], _final_hidden(prog, cfg, d, x1)):
                hidden[s] = h[:, 0]
    return _logits(prog, cfg, b, _fill_groups(groups, hidden)), cache
