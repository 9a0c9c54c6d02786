"""Model assembly — port of ``repro/models/transformer.py`` for the dense
decoders (pattern ``("attn",)`` or ``("local",)`` mixes: ``olmo_1b``,
``qwen3_14b``, ``yi_9b``, ``llama3_405b``), the MoE ones (``("attn",)``
with ``cfg.moe``: ``granite_moe_1b_a400m``, ``qwen3_moe_235b_a22b``) and
the recurrent ones (``("rwkv",)``: ``rwkv6_3b``; ``("rglru", "rglru",
"local")``: ``recurrentgemma_9b``) and the encoder-decoder
(``whisper_large_v3``: an ``("attn",)`` decoder with cross-attention and
``n_encoder_layers`` of ``enc-attn``) and the VLM
(``llava_next_mistral_7b``: an ``("attn",)`` decoder behind the
``mm_projector``), serving and training.

The model is a ``Transformer`` module holding the embedding, the final
norm and one ``Block`` module per layer, in execution order; its
parameters keep the JAX package's names and layouts.  An attention or
``rglru`` block holds ``norm1``, its mixer (``attn`` / ``rglru``),
``norm2`` and ``mlp`` (``moe`` where ``cfg.moe`` is set); an ``rwkv`` block
is self-contained (its own norms
and channel mix, ``models/rwkv6.py``).  An encoder-decoder's decoder layers
add ``normx`` and the cross-attention ``xattn`` after the mixer, and the
model holds an ``Encoder`` module (``encoder``: its ``enc-attn`` layers and
``norm``, the reference's ``params["encoder"]``).  The reference scans
``n_groups`` repetitions of the block pattern over stacked parameters
(``params["blocks"]``, one list entry per pattern position, each leaf with
a leading group axis) and runs the remainder unscanned
(``params["rem"]``).  A scan is numerically a loop over its layers, so the
port loops; ``params_from_jax`` unstacks either layout into the flat layer
list (layer ``g·len(pattern) + pos`` is group g's position pos;
recurrentgemma_9b's 38 layers are 12 groups of its pattern, then 2
unstacked ``rglru`` layers), and ``cache_from_jax`` does the same for a
decode cache (KV caches, recurrent states, cross K/V) and
``opt_state_from_jax`` for AdamW's moments; the encoder's layers are
unstacked alike (the reference stacks them all in one scan when
``cfg.scan_layers`` and there are two or more).  As in the reference, the
scanned groups' layers run under a checkpoint when ``cfg.remat`` is set
and gradients are on (``remat_policy="dots"`` keeps the 2-D matmul
outputs); the unscanned tail never does.  Inside a recurrent mixer each
``cfg.rnn_chunk`` chunk of the scan is checkpointed when gradients are on.

The entry points keep the reference's names and arguments with the model
in place of the parameter tree: ``init_params``, ``init_cache`` (with
``cache_specs`` and ``cache_shapes`` for a placed cache),
``forward_seq``, ``loss_fn``, ``prefill``, ``prefill_hidden``,
``decode_step_hidden`` and ``decode_step``; ``forward_seq(states=)``
carries recurrent states in (chunked prefill), in ``init_cache``'s
per-layer layout; as in the reference, an attention layer ignores its
entry, so a chunk's attention sees that chunk alone.  ``_cast_params`` casts every
float weight to ``cfg.dtype`` before compute, as the reference does.  For
inference the cast copy is kept beside the float32 masters and rebuilt
only when a parameter changes; when the masters require gradients (the
trainer sets them so) and gradients are on, the cast is made anew in the
autograd graph, so gradients flow back to the masters in their own dtype.
``forward_seq`` and ``loss_fn`` are differentiable; the inference entry
points run under ``torch.no_grad()``.  A decode step writes the cache in
place and returns it.  An MoE layer's load-balance aux is summed over the
layers into ``forward_seq``'s aux (float32), which ``loss_fn`` adds as
``0.01 · moe_aux``; a decode step drops it.

The encoder runs over precomputed frames (B, ``cfg.encoder_seq``, D)
(``encode``, the reference's stub frontend): its bidirectional, roped
``enc-attn`` layers (checkpointed as the scanned groups are), then its
norm.  ``forward_seq(frames=)``, ``loss_fn`` (``batch["frames"]``) and
``prefill(frames=)`` run it where the config has an encoder, and ignore
frames where it has none, as the reference does; each decoder layer then
attends to its output, unroped, and a prefill keeps each layer's
cross-attention K/V (``"cross"``) for decode.  A cache from ``init_cache``
holds zero cross K/V and decode attends to them; a prefill without frames
keeps none and decode skips cross-attention — the reference's three
cases.

A VLM's precomputed patch features (B, ``cfg.n_patches``, ``cfg.patch_dim``)
(the reference's stub vision tower) go through the ``mm_projector``
(``model.mm_projector``: ``w1`` (patch_dim, d), ``w2`` (d, d); in ``tree()``
only where ``cfg.n_patches``): GELU(patches · w1) · w2, in the activation
dtype, prepended to the token embeddings, so the patches take positions
0 … P−1 and the text P … P+S−1.  ``forward_seq(patches=)``, ``loss_fn``
(``batch["patches"]``, the loss over the text positions alone) and
``prefill(patches=)`` take them where the config has ``n_patches``, and
ignore them where it has none, as the reference does; a prefill's cache then
holds P + S positions and decode continues at P + S.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv6 as rwkv_lib
from repro_torch.utils import resolve_device, tree_leaves, tree_map

Params = Dict[str, Any]
_SUBLAYERS = ("norm1", "attn", "norm2", "mlp")     # an attention block's
ENCODER_KIND = "enc-attn"


# --------------------------------------------------------------------------
# layer plan
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerPlan:
    kinds: Tuple[str, ...]        # kind of every decoder layer, in order
    pattern: Tuple[str, ...]
    n_groups: int                 # stacked repetitions of the pattern
    rem_kinds: Tuple[str, ...]    # unstacked tail layers


def layer_plan(cfg: ModelConfig) -> LayerPlan:
    lp = len(cfg.block_pattern)
    kinds = tuple(cfg.block_pattern[i % lp] for i in range(cfg.n_layers))
    if cfg.scan_layers and cfg.n_layers >= 2 * lp:
        g = cfg.n_layers // lp
        rem = kinds[g * lp:]
    else:
        g, rem = 0, kinds
    return LayerPlan(kinds, cfg.block_pattern, g, rem)


def encoder_plan(cfg: ModelConfig) -> LayerPlan:
    """The encoder's ``cfg.n_encoder_layers`` layers of kind ``enc-attn``,
    laid out as the reference's ``params["encoder"]``: all stacked in one
    scan (``blocks[0]``) when ``cfg.scan_layers`` and there are two or more,
    else unstacked (``rem``)."""
    return layer_plan(dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers,
                                          block_pattern=(ENCODER_KIND,)))


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind not in ("attn", "local", "rglru", "rwkv"):
            raise ValueError(f"unknown layer kind {kind!r} in {cfg.name}'s block_pattern")


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

def _param_dict(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer in the reference's layout: ``norm1``, the mixer (``attn``
    or ``rglru``), in an encoder-decoder's decoder ``normx`` and ``xattn``,
    then ``norm2``, ``mlp`` or ``moe``, each a ``ParameterDict`` under the
    reference's names (the non-parametric norms are empty); an ``rwkv``
    layer's flat dict of parameters is the one ``ParameterDict`` ``rwkv``."""

    def __init__(self, kind: str, params: Params):
        super().__init__()
        self.kind = kind
        self.sublayers = ("rwkv",) if kind == "rwkv" else tuple(params)
        if kind == "rwkv":
            self.rwkv = _param_dict(params)
        else:
            for name in self.sublayers:
                self.add_module(name, _param_dict(params[name]))

    def tree(self) -> Params:
        """The layer's parameters in the reference's per-layer layout."""
        if self.kind == "rwkv":
            return dict(self.rwkv)
        return {name: dict(getattr(self, name)) for name in self.sublayers}


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``layers`` (one ``enc-attn`` ``Block``
    per layer, in execution order) and ``norm``."""

    def __init__(self, layers: List[Block], norm: Dict[str, torch.Tensor]):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = _param_dict(norm)

    def tree(self) -> Params:
        return {"layers": [blk.tree() for blk in self.layers], "norm": dict(self.norm)}


class Transformer(nn.Module):
    """The model: ``embed`` (``tok``[, ``unembed``]), ``layers`` (one
    decoder ``Block`` per layer, in execution order), ``final_norm``, an
    encoder-decoder's ``encoder`` and a VLM's ``mm_projector`` (``w1``,
    ``w2``; each None elsewhere)."""

    def __init__(self, cfg: ModelConfig, embed: Dict[str, torch.Tensor],
                 final_norm: Dict[str, torch.Tensor], layers: List[Block],
                 encoder: Optional[Encoder] = None,
                 mm_projector: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = _param_dict(embed)
        self.final_norm = _param_dict(final_norm)
        self.layers = nn.ModuleList(layers)
        self.encoder = encoder
        self.mm_projector = None if mm_projector is None else _param_dict(mm_projector)
        self._compute: Optional[Tuple[tuple, Params]] = None

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def tree(self) -> Params:
        """The parameters as a nested dict of tensors (``embed``,
        ``final_norm``, ``layers``: a list of per-layer dicts; an
        encoder-decoder's ``encoder``: ``{"layers", "norm"}``; a VLM's
        ``mm_projector``: ``{"w1", "w2"}``)."""
        out = {"embed": dict(self.embed), "final_norm": dict(self.final_norm),
               "layers": [blk.tree() for blk in self.layers]}
        if self.encoder is not None:
            out["encoder"] = self.encoder.tree()
        if self.mm_projector is not None:
            out["mm_projector"] = dict(self.mm_projector)
        return out


def _training(model: Transformer) -> bool:
    """Gradients are on and the masters require them: the forward is part
    of a training step's graph."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in model.parameters())


def _cast_params(model: Transformer, cfg: ModelConfig) -> Params:
    """The parameter tree with every float weight in ``cfg.dtype`` (the
    reference's compute-dtype cast; the masters stay in ``param_dtype``).
    In training the cast is made anew, inside the autograd graph.
    Otherwise the cast copy is cached on the model and rebuilt when any
    parameter was replaced or written in place."""
    dt = cfg.activation_dtype()

    def cast(t):
        return t.to(dt) if t.is_floating_point() and t.dtype != dt else t

    if _training(model):
        return tree_map(cast, model.tree())
    stamp = (dt,) + tuple((id(p), p._version) for p in model.parameters())
    if model._compute is not None and model._compute[0] == stamp:
        return model._compute[1]
    out = tree_map(cast, model.tree())
    model._compute = (stamp, out)
    return out


# --------------------------------------------------------------------------
# init and weights from the JAX package
# --------------------------------------------------------------------------

def _cross(cfg: ModelConfig, kind: str) -> bool:
    """A decoder layer of an encoder-decoder: it holds a cross-attention."""
    return bool(cfg.n_encoder_layers) and kind != ENCODER_KIND


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, dtype, device) -> Params:
    """One layer's parameters; an ``rwkv`` block is self-contained."""
    if kind == "rwkv":
        return rwkv_lib.init_rwkv(gen, cfg, dtype, device=device)
    mixer = (("rglru", rglru_lib.init_rglru) if kind == "rglru" else
             ("attn", L.init_attention))
    ffn = ("moe", L.init_moe) if cfg.moe is not None else ("mlp", L.init_mlp)
    p = {"norm1": L.init_norm(cfg, dtype, device=device),
         mixer[0]: mixer[1](gen, cfg, dtype, device=device)}
    if _cross(cfg, kind):
        p["normx"] = L.init_norm(cfg, dtype, device=device)
        p["xattn"] = L.init_attention(gen, cfg, dtype, device=device, cross=True)
    p["norm2"] = L.init_norm(cfg, dtype, device=device)
    p[ffn[0]] = ffn[1](gen, cfg, dtype, device=device)
    return p


def init_params(key, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """A freshly initialized model on ``device``.  ``key`` is an int seed or
    a ``torch.Generator`` on that device; the reference's scales
    (1/√fan_in) are drawn from it in a fixed order (a VLM's projector
    last, after the layers, as the reference draws it).  The numbers are not
    ``jax.random``'s: carry JAX weights across with ``params_from_jax``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    dtype = torch_dtype(cfg.param_dtype)
    plan = layer_plan(cfg)
    embed = L.init_embeddings(gen, cfg, dtype, device=dev)
    final_norm = L.init_norm(cfg, dtype, device=dev)
    layers = [Block(kind, _init_layer(gen, cfg, kind, dtype, dev)) for kind in plan.kinds]
    encoder = None
    if cfg.n_encoder_layers:
        encoder = Encoder([Block(kind, _init_layer(gen, cfg, kind, dtype, dev))
                           for kind in encoder_plan(cfg).kinds],
                          L.init_norm(cfg, dtype, device=dev))
    proj = None
    if cfg.n_patches:
        proj = {k: L.dense_init(gen, shp, dtype, device=dev)
                for k, (shp, _) in _projector_table(cfg).items()}
    return Transformer(cfg, embed, final_norm, layers, encoder, proj)


def _tables(cfg: ModelConfig) -> Params:
    """The model's (shape, logical axes) pairs in ``Transformer.tree()``'s
    layout, from the sublayers' tables."""
    _check_supported(cfg)
    out = {"embed": L.embedding_table(cfg), "final_norm": L.norm_table(cfg),
           "layers": [_layer_table(cfg, kind) for kind in layer_plan(cfg).kinds]}
    if cfg.n_encoder_layers:
        out["encoder"] = {"layers": [_layer_table(cfg, kind) for kind in encoder_plan(cfg).kinds],
                          "norm": L.norm_table(cfg)}
    if cfg.n_patches:
        out["mm_projector"] = _projector_table(cfg)
    return out


def _projector_table(cfg: ModelConfig) -> Params:
    """A VLM's ``mm_projector``: ``w1`` (patch_dim, d), ``w2`` (d, d), with
    the reference's logical axes; each drawn at 1/√fan_in, fan_in its rows."""
    d = cfg.d_model
    return {"w1": ((cfg.patch_dim, d), ("embed", "mlp")), "w2": ((d, d), ("mlp", "embed"))}


def _layer_table(cfg: ModelConfig, kind: str) -> Params:
    if kind == "rwkv":
        return rwkv_lib.rwkv_table(cfg)
    mixer = ("rglru", rglru_lib.rglru_table(cfg)) if kind == "rglru" else \
        ("attn", L.attention_table(cfg))
    ffn = ("moe", L.moe_table(cfg)) if cfg.moe is not None else ("mlp", L.mlp_table(cfg))
    t = {"norm1": L.norm_table(cfg), mixer[0]: mixer[1]}
    if _cross(cfg, kind):
        t["normx"] = L.norm_table(cfg)
        t["xattn"] = L.attention_table(cfg, cross=True)
    t["norm2"] = L.norm_table(cfg)
    t[ffn[0]] = ffn[1]
    return t


def _map_pairs(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_pairs(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_pairs(v, fn) for v in tree]
    return fn(*tree)


def param_specs(cfg: ModelConfig) -> Params:
    """The logical sharding axes of every parameter, a tuple of names per
    dim, shaped like ``Transformer.tree()``: the reference's
    ``init_params`` specs in the unstacked layout (its scanned leaves'
    leading ``"layers"`` axis dropped)."""
    return _map_pairs(_tables(cfg), lambda shape, axes: tuple(axes))


def param_shapes(cfg: ModelConfig, dtype=None) -> Params:
    """Every parameter as a ``meta`` tensor (shape and dtype, no storage),
    shaped like ``Transformer.tree()``; ``dtype`` defaults to
    ``cfg.param_dtype``."""
    dt = torch_dtype(cfg.param_dtype) if dtype is None else dtype
    return _map_pairs(_tables(cfg),
                      lambda shape, axes: torch.empty(shape, dtype=dt, device="meta"))


def _layer_sources(cfg: ModelConfig, plan: Optional[LayerPlan] = None):
    """For each layer of ``plan`` (the decoder's by default) in execution
    order: (kind, where its parameters sit in the reference's tree, or its
    encoder's) — ("blocks", pattern position, group) or ("rem", index)."""
    plan = plan or layer_plan(cfg)
    out = []
    for g in range(plan.n_groups):
        for pos, kind in enumerate(plan.pattern):
            out.append((kind, ("blocks", pos, g)))
    for i, kind in enumerate(plan.rem_kinds):
        out.append((kind, ("rem", i)))
    return out


def _pick(tree, src):
    if src[0] == "rem":
        return tree["rem"][src[1]]
    _, pos, g = src
    return _map(tree["blocks"][pos], lambda x: x[g])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _tensor(x, device) -> torch.Tensor:
    """A copy of a JAX leaf (numpy array, or a tensor, e.g. on ``meta``) on
    ``device``, same dtype; bf16 numpy leaves (ml_dtypes) go through
    float32.  A copy, as JAX's arrays are read-only and a decode writes
    its cache in place."""
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def _unstack(tree_np: Params, cfg: ModelConfig, dev) -> Params:
    """A tree in the JAX parameter layout as the port's ``{"embed",
    "final_norm", "layers"[, "encoder"][, "mm_projector"]}``
    (``Transformer.tree()``'s layout), each leaf copied to ``dev``."""
    conv = lambda x: _tensor(x, dev)
    out = {"embed": _map(tree_np["embed"], conv), "final_norm": _map(tree_np["final_norm"], conv),
           "layers": [_map(_pick(tree_np, src), conv) for _, src in _layer_sources(cfg)]}
    if cfg.n_encoder_layers:
        enc = tree_np["encoder"]
        out["encoder"] = {"layers": [_map(_pick(enc, src), conv)
                                     for _, src in _layer_sources(cfg, encoder_plan(cfg))],
                          "norm": _map(enc["norm"], conv)}
    if cfg.n_patches:
        out["mm_projector"] = _map(tree_np["mm_projector"], conv)
    return out


def _check_layout(tree_np: Params, plan: LayerPlan, what: str) -> None:
    """The tree's ``blocks`` / ``rem`` lists hold ``plan``'s layers."""
    blocks = tree_np.get("blocks", [])
    groups = {int(np.shape(leaf)[0]) for b in blocks for leaf in tree_leaves(b)}
    if len(blocks) != (len(plan.pattern) if plan.n_groups else 0) or \
            groups - {plan.n_groups} or len(tree_np["rem"]) != len(plan.rem_kinds):
        raise ValueError(f"the tree's blocks / rem lists do not match {what}'s layer plan "
                         f"({plan.n_groups} groups of {plan.pattern}, {len(plan.rem_kinds)} "
                         f"unstacked)")


def params_from_jax(params_np: Params, cfg: ModelConfig, *, device="cuda") -> Transformer:
    """The port's model holding the weights of a JAX ``init_params`` tree
    whose leaves are numpy arrays (or tensors).  Both layouts are taken:
    the scan-stacked ``params["blocks"]`` (a list over pattern positions,
    each leaf with a leading ``n_groups`` axis: the full ``olmo_1b``'s) and
    the unstacked ``params["rem"]`` list (``smoke_config()``'s), or both
    (``recurrentgemma_9b``'s scanned groups and its two-layer tail); an
    encoder-decoder's ``params["encoder"]`` in either layout too, and a
    VLM's ``params["mm_projector"]``."""
    _check_supported(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    plan = layer_plan(cfg)
    _check_layout(params_np, plan, cfg.name)
    if cfg.n_encoder_layers:
        _check_layout(params_np["encoder"], encoder_plan(cfg), f"{cfg.name}'s encoder")
    tree = _unstack(params_np, cfg, dev)
    layers = [Block(kind, lp) for kind, lp in zip(plan.kinds, tree["layers"])]
    encoder = None
    if cfg.n_encoder_layers:
        encoder = Encoder([Block(ENCODER_KIND, lp) for lp in tree["encoder"]["layers"]],
                          tree["encoder"]["norm"])
    return Transformer(cfg, tree["embed"], tree["final_norm"], layers, encoder,
                       tree.get("mm_projector"))


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *, device="cuda") -> List[Params]:
    """Zeroed decode state, one dict per layer in execution order: an
    attention layer's ``{"kv": {"k", "v"}}`` in the activation dtype (a
    window-sized ring for ``local``), a recurrent layer's ``{"rnn": ...}``
    (``rwkv``: ``wkv`` float32, ``shift_tm`` / ``shift_cm``; ``rglru``: ``h``
    float32, ``conv``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [_map_pairs(_state_table(cfg, kind, batch, cache_len),
                       lambda shape, axes, dt: torch.zeros(shape, dtype=dt, device=dev))
            for kind in layer_plan(cfg).kinds]


def _state_table(cfg: ModelConfig, kind: str, batch: int, cache_len: int) -> Params:
    """(shape, logical axes, dtype) of each leaf of one layer's decode state,
    the reference's ``_layer_state_shape`` / ``_layer_state_spec``: a KV
    cache for attention layers (a window-sized ring for ``local``), the
    recurrent state of ``rwkv`` and ``rglru`` layers, and the cross-attention
    K/V of an encoder-decoder."""
    dt, f32 = cfg.activation_dtype(), torch.float32
    g, hd, d, rd = cfg.n_kv_heads, cfg.hd, cfg.d_model, cfg.rnn_d
    st: Params = {}
    if kind == "rwkv":
        h = d // cfg.rnn_head_dim
        st["rnn"] = {"wkv": ((batch, h, cfg.rnn_head_dim, cfg.rnn_head_dim),
                             ("act_batch", "rnn_heads", None, None), f32),
                     "shift_tm": ((batch, d), ("act_batch", "rnn"), dt),
                     "shift_cm": ((batch, d), ("act_batch", "rnn"), dt)}
    elif kind == "rglru":
        st["rnn"] = {"h": ((batch, rd), ("act_batch", "rnn"), f32),
                     "conv": ((batch, cfg.conv_width - 1, rd), ("act_batch", None, "rnn"), dt)}
    else:
        t = min(cache_len, cfg.window) if kind == "local" else cache_len
        kv = ((batch, t, g, hd), ("act_batch", "act_kv_seq", "kv_heads", None), dt)
        st["kv"] = {"k": kv, "v": kv}
    if cfg.n_encoder_layers:
        cross = ((batch, cfg.encoder_seq, g, hd), ("act_batch", None, "kv_heads", None), dt)
        st["cross"] = {"k": cross, "v": cross}
    return st


def cache_specs(cfg: ModelConfig) -> List[Params]:
    """The logical sharding axes of the decode state, shaped like
    ``init_cache``'s list: the reference's ``cache_specs`` in the unstacked
    layout (its scanned leaves' leading ``"layers"`` axis dropped), for every
    layer kind."""
    return [_map_pairs(_state_table(cfg, kind, 1, 1), lambda shape, axes, dt: tuple(axes))
            for kind in layer_plan(cfg).kinds]


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> List[Params]:
    """The decode state as ``meta`` tensors (shape and dtype, no storage),
    shaped like ``init_cache``'s list."""
    return [_map_pairs(_state_table(cfg, kind, batch, cache_len),
                       lambda shape, axes, dt: torch.empty(shape, dtype=dt, device="meta"))
            for kind in layer_plan(cfg).kinds]


def opt_state_from_jax(opt_np: Params, cfg: ModelConfig, *, device="cuda") -> Params:
    """A JAX ``init_opt_state`` / ``adamw_update`` state (``mu``, ``nu`` in the
    parameter tree's layout, numpy leaves; ``count``) in the port's layout:
    ``mu`` and ``nu`` shaped like ``Transformer.tree()``, unstacked as
    ``params_from_jax`` unstacks the parameters."""
    dev = resolve_device(device)
    return {"mu": _unstack(opt_np["mu"], cfg, dev), "nu": _unstack(opt_np["nu"], cfg, dev),
            "count": torch.tensor(int(np.asarray(opt_np["count"])), dtype=torch.int32,
                                  device=dev)}


def cache_from_jax(cache_np: Params, cfg: ModelConfig, *, device="cuda") -> List[Params]:
    """A JAX decode cache (``{"blocks": [...], "rem": [...]}``, numpy leaves)
    in the port's per-layer layout."""
    dev = resolve_device(device)
    return [_map(_pick(cache_np, src), lambda x: _tensor(x, dev))
            for _, src in _layer_sources(cfg)]


# --------------------------------------------------------------------------
# sequence forward (prefill)
# --------------------------------------------------------------------------

def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                           else tokens, device=device).long()


def cache_layout(kv: torch.Tensor, cfg: ModelConfig, kind: str, cache_len: int):
    """A prefill's roped K or V (B, S, G, hd) in the decode cache's layout:
    zero-padded to ``cache_len``, or for a local layer the trailing window in
    the ring layout slot = pos % t."""
    t = min(cache_len, cfg.window) if kind == "local" else cache_len
    if kind == "local" and kv.shape[1] > t:
        # tail element j (absolute position pos0 + j) lands at (pos0 + j) % t,
        # a roll by pos0.
        pos0 = kv.shape[1] - t
        return torch.roll(kv[:, pos0:], pos0 % t, dims=1)
    return L.pad_cache(kv, t)


def _apply_layer_seq(p: Params, cfg: ModelConfig, kind: str, x, *, state=None, cache_len: int,
                     collect: bool, shd=None, encoder_out=None):
    """One layer over the sequence: (x, the MoE aux — a float32 zero for
    other layers —, the layer's new state when ``collect``).  ``state`` (a
    recurrent layer's ``{"rnn": ...}``) is the state before the sequence;
    attention layers ignore it.  With ``encoder_out`` the layer's
    cross-attention runs after its mixer, and a collected state keeps its
    K/V (``"cross"``)."""
    new_state: Params = {}
    rnn0 = (state or {}).get("rnn")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv":
        x, rnn = rwkv_lib.rwkv_forward(p, cfg, x, rnn0)
        if collect:
            new_state["rnn"] = rnn
        return x, aux, new_state
    h = L.apply_norm(p["norm1"], cfg, x)
    if kind == "rglru":
        mix, rnn = rglru_lib.rglru_forward(p["rglru"], cfg, h, rnn0)
        if collect:
            new_state["rnn"] = rnn
    elif collect:
        mix, (kk, vv) = L.attention_forward_collect(p["attn"], cfg, h, kind=kind)
        new_state["kv"] = {"k": cache_layout(kk, cfg, kind, cache_len),
                           "v": cache_layout(vv, cfg, kind, cache_len)}
    else:
        mix = L.attention_forward(p["attn"], cfg, h, kind=kind)
    x = x + mix
    if encoder_out is not None:
        hx = L.apply_norm(p["normx"], cfg, x)
        x = x + L.attention_forward(p["xattn"], cfg, hx, encoder_out=encoder_out)
        if collect:
            new_state["cross"] = L.init_cross_cache(p["xattn"], cfg, encoder_out)
    h2 = L.apply_norm(p["norm2"], cfg, x)
    if "moe" in p:
        out, aux = L.apply_moe(p["moe"], cfg, h2, shd)
    else:
        out = L.apply_mlp(p["mlp"], cfg, h2)
    return x + out, aux, new_state


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of matmuls without batch
    dimensions (``mm``, and ``bmm`` over a batch of one, as ``einsum``
    lowers the projections), recompute the rest — the reference's
    ``dots_with_no_batch_dims_saveable``."""
    dot = op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default) or (
        op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return CheckpointPolicy.MUST_SAVE if dot else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ModelConfig, fn):
    """``fn(*xs)`` under a per-layer checkpoint, with ``cfg.remat_policy``;
    ``fn`` may return a tuple (a layer's x and its aux)."""
    kwargs = {}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
    return lambda *xs: checkpoint(fn, *xs, use_reentrant=False, **kwargs)


def forward_seq(model: Transformer, cfg: ModelConfig, tokens, shd=None, *, frames=None,
                patches=None, states=None, collect: bool = False, cache_len: int = 0):
    """Token ids -> final hidden states; differentiable.

    Returns (hidden (B,S,D), aux_loss, new_states): ``aux_loss`` the MoE
    layers' load-balance aux summed in float32 (0 without MoE);
    ``collect=True`` gathers each layer's decode state (the KV
    caches padded to ``cache_len``, the recurrent states) for decode
    (prefill).  ``states`` (one entry per layer, ``init_cache``'s layout)
    carries the recurrent layers' states in, for a prefill in chunks;
    attention layers ignore their entry, as the reference's do.  In training
    (``_training``) with ``cfg.remat``, each layer of the scanned groups is
    checkpointed, its aux returned beside x so that it stays differentiable.
    ``shd`` reaches the MoE layers (their per-data-shard dispatch).
    ``frames`` (B, T, D), where the config has an encoder, run through it
    (``encode``) and every decoder layer attends to its output; a config
    without one ignores them, as the reference does.  ``patches`` (B, P,
    patch_dim), where the config has ``n_patches``, go through the
    projector and are prepended: the hidden states are (B, P + S, D)."""
    if states is not None and len(states) != cfg.n_layers:
        raise ValueError(f"states has {len(states)} entries; {cfg.name} has {cfg.n_layers} "
                         f"layers")
    p = _cast_params(model, cfg)
    x = L.embed(p["embed"], cfg, _tokens(tokens, model.device))
    if cfg.n_patches and patches is not None:
        x = torch.cat([_project(p["mm_projector"], patches, x.dtype, model.device), x], 1)
    plan = layer_plan(cfg)
    n_scanned = plan.n_groups * len(plan.pattern)
    training = _training(model)
    remat = cfg.remat and not collect and training
    encoder_out = None
    if cfg.n_encoder_layers and frames is not None:
        encoder_out = _encode(p["encoder"], cfg, frames, model.device, cfg.remat and training)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_states: List[Params] = []
    for i, (lp, blk) in enumerate(zip(p["layers"], model.layers)):
        st = states[i] if states is not None else None
        if remat and i < n_scanned:
            x, aux_i = _remat(cfg, functools.partial(_layer_out, lp, cfg, blk.kind, st, shd,
                                                     encoder_out))(x)
            ns: Params = {}
        else:
            x, aux_i, ns = _apply_layer_seq(lp, cfg, blk.kind, x, state=st, cache_len=cache_len,
                                            collect=collect, shd=shd, encoder_out=encoder_out)
        aux = aux + aux_i
        new_states.append(ns)
    x = L.apply_norm(p["final_norm"], cfg, x)
    return x, aux, (new_states if collect else None)


def _layer_out(lp: Params, cfg: ModelConfig, kind: str, state, shd, encoder_out, x):
    """A layer's (x, aux), the function a training forward checkpoints."""
    return _apply_layer_seq(lp, cfg, kind, x, state=state, cache_len=0, collect=False,
                            shd=shd, encoder_out=encoder_out)[:2]


def loss_fn(model: Transformer, cfg: ModelConfig, batch, shd=None):
    """Next-token cross entropy (+ 0.01 · the MoE aux loss, 0 without MoE).
    ``batch``: ``tokens``, ``labels``, optional ``loss_mask``, ``frames``
    (the encoder's input) and ``patches`` (a VLM's: the patch positions
    carry no loss, only the last ``labels.shape[1]`` positions of the hidden
    states are scored).  The unembedding runs against
    the master embedding, uncast, as the reference's does: bf16 hidden
    states against float32 masters give float32 logits.  Returns (loss,
    {"xent", "moe_aux"})."""
    hidden, aux, _ = forward_seq(model, cfg, batch["tokens"], shd,
                                 frames=batch.get("frames"), patches=batch.get("patches"))
    labels = _tokens(batch["labels"], model.device)
    mask = batch.get("loss_mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=model.device) if mask is None
            else torch.as_tensor(mask, device=model.device).float())
    if cfg.n_patches and "patches" in batch:
        hidden = hidden[:, hidden.shape[1] - labels.shape[1]:]
    xent = L.chunked_xent(lambda xc: L.unembed(model.embed, cfg, xc), hidden, labels, mask,
                          chunk=cfg.xent_chunk)
    loss = xent + 0.01 * aux
    return loss, {"xent": xent, "moe_aux": aux}


def _encode(enc: Params, cfg: ModelConfig, frames, device, remat: bool):
    """The encoder over ``frames`` with its compute-dtype parameters ``enc``
    (``{"layers", "norm"}``): the frames cast to the activation dtype, each
    ``enc-attn`` layer — under a checkpoint when ``remat``, for the layers
    the reference scans —, then the norm."""
    x = torch.as_tensor(np.asarray(frames) if not isinstance(frames, torch.Tensor) else frames,
                        device=device).to(cfg.activation_dtype())
    n_scanned = encoder_plan(cfg).n_groups
    for i, lp in enumerate(enc["layers"]):
        f = functools.partial(_layer_out, lp, cfg, ENCODER_KIND, None, None, None)
        if remat and i < n_scanned:
            x, _ = checkpoint(f, x, use_reentrant=False)
        else:
            x, _ = f(x)
    return L.apply_norm(enc["norm"], cfg, x)


def _project(proj: Params, patches, dtype, device) -> torch.Tensor:
    """The VLM projector with its compute-dtype parameters ``proj``:
    GELU(patches · w1) · w2, the patches cast to ``dtype`` (the
    activations') before the first product, as the reference casts them;
    the GELU the reference's tanh form, rounded step by step."""
    x = torch.as_tensor(np.asarray(patches) if not isinstance(patches, torch.Tensor)
                        else patches, device=device).to(dtype)
    return L._gelu_tanh(x @ proj["w1"]) @ proj["w2"]


def project_patches(model: Transformer, cfg: ModelConfig, patches) -> torch.Tensor:
    """A VLM's projector over precomputed patch features (the reference's
    stub vision tower): patches (B, ``cfg.n_patches``, ``cfg.patch_dim``) ->
    (B, P, D) in the activation dtype, the embeddings ``forward_seq``
    prepends; differentiable."""
    return _project(_cast_params(model, cfg)["mm_projector"], patches,
                    cfg.activation_dtype(), model.device)


def encode(model: Transformer, cfg: ModelConfig, frames, shd=None) -> torch.Tensor:
    """The whisper-style encoder over precomputed frame embeddings (the
    reference's stub frontend): frames (B, ``cfg.encoder_seq``, D) ->
    (B, T, D) in the activation dtype; differentiable."""
    return _encode(_cast_params(model, cfg)["encoder"], cfg, frames, model.device,
                   cfg.remat and _training(model))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@torch.no_grad()
def decode_step_hidden(model: Transformer, cfg: ModelConfig, token, cache: List[Params],
                       pos, shd=None):
    """Decode one token through the stack, returning the final-norm hidden
    state (B, D) — the retrieval query vector — and the cache, updated in
    place (a KV slot written, a recurrent layer's state replaced).  A layer
    whose state holds ``"cross"`` K/V attends to them after its mixer.  An
    MoE layer's aux is dropped, as the reference's is."""
    p = _cast_params(model, cfg)
    x1 = L.embed(p["embed"], cfg, _tokens(token, model.device)[:, None])
    for lp, blk, st in zip(p["layers"], model.layers, cache):
        if blk.kind == "rwkv":
            x1, st["rnn"] = rwkv_lib.rwkv_decode(lp, cfg, x1, st["rnn"])
            continue
        h = L.apply_norm(lp["norm1"], cfg, x1)
        if blk.kind == "rglru":
            mix, st["rnn"] = rglru_lib.rglru_decode(lp["rglru"], cfg, h, st["rnn"])
        else:
            mix, st["kv"] = L.attention_decode(lp["attn"], cfg, h, st["kv"], pos, kind=blk.kind)
        x1 = x1 + mix
        if "cross" in st:
            hx = L.apply_norm(lp["normx"], cfg, x1)
            x1 = x1 + L.attention_decode(lp["xattn"], cfg, hx, None, pos,
                                         cross_cache=st["cross"])[0]
        h2 = L.apply_norm(lp["norm2"], cfg, x1)
        x1 = x1 + (L.apply_moe(lp["moe"], cfg, h2)[0] if "moe" in lp else
                   L.apply_mlp(lp["mlp"], cfg, h2))
    x1 = L.apply_norm(p["final_norm"], cfg, x1)
    return x1[:, 0], cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: ModelConfig, token, cache: List[Params], pos,
                shd=None):
    """One serving step: token (B,), ``pos`` the absolute position.
    Returns (logits (B, vocab), cache)."""
    hidden, cache = decode_step_hidden(model, cfg, token, cache, pos, shd)
    return L.unembed(model.embed, cfg, hidden[:, None])[:, 0], cache


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

@torch.no_grad()
def prefill(model: Transformer, cfg: ModelConfig, tokens, cache_len: int, shd=None, *,
            frames=None, patches=None):
    """Run the full prompt (and ``frames`` through the encoder, where the
    config has one; ``patches`` through the projector before the prompt,
    where it has ``n_patches``: the cache then holds P + S positions, so
    ``cache_len`` counts them, and decode continues at position P + S),
    return (last_logits (B,V), cache)."""
    hidden, _, states = forward_seq(model, cfg, tokens, shd, frames=frames, patches=patches,
                                    collect=True, cache_len=cache_len)
    return L.unembed(model.embed, cfg, hidden[:, -1:])[:, 0], states


@torch.no_grad()
def prefill_hidden(model: Transformer, cfg: ModelConfig, tokens, cache_len: int, shd=None):
    """``prefill`` that also returns the last position's final-norm hidden
    state (B, D): the retrieval query of the FIRST generated token."""
    hidden, _, states = forward_seq(model, cfg, tokens, shd, collect=True, cache_len=cache_len)
    return L.unembed(model.embed, cfg, hidden[:, -1:])[:, 0], hidden[:, -1], states
