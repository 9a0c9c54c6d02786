"""Analytic per-cell cost model (FLOPs + HBM bytes, per device) — port of
``repro/launch/analytic.py``, the same arithmetic (numpy only), for every
layer kind ``layer_plan`` lists.

Why this exists: XLA's ``compiled.cost_analysis()`` counts every while
body ONCE, so a scan-over-layers train step under-reports FLOPs by
~n_layers× (and microbatching by another micro×).  The dry-run records
the as-compiled numbers for transparency, but the roofline's compute and
memory terms come from this explicit, documented model — the same napkin
math §Perf hypotheses are made from, so predictions and measurements
share units.

All numbers are *algorithmic* (what the lowered program actually
computes, including flash-attention full-S² baselines, MoE capacity
padding and remat recompute) — not the idealized 6·N·D, which is
reported separately as MODEL_FLOPS to expose the waste ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig, torch_dtype
from repro_torch.launch.mesh import mesh_chip_count
from repro_torch.models.transformer import layer_plan

BF16 = 2
F32 = 4


def _itemsize(dtype: str) -> int:
    """Bytes of one element of a config's dtype string (``np.dtype`` knows
    no bfloat16 without ml_dtypes)."""
    return torch_dtype(dtype).itemsize


@dataclasses.dataclass
class CellCosts:
    flops_per_device: float
    hbm_bytes_per_device: float
    breakdown: Dict[str, float]      # global fwd FLOPs by component
    notes: str = ""


def _attention_kv_span(cfg: ModelConfig, kind: str, s: int,
                       mode: str) -> float:
    """Average keys visited per query token (what the program computes,
    not what the mask keeps)."""
    if mode == "decode":
        return min(cfg.window, s) if kind == "local" else s
    if kind == "local" and cfg.window:
        if cfg.attn_chunk:
            # flash visits ceil(window/chunk)+1 chunks around the diagonal
            return min(cfg.window + cfg.attn_chunk, s)
        return s                      # dense path materializes S×S
    if cfg.causal_skip and cfg.attn_chunk:
        return (s + cfg.attn_chunk) / 2.0   # diagonal-blocked lower triangle
    return float(s)


def _per_token_layer_flops(cfg: ModelConfig, kind: str, s: int,
                           mode: str) -> Dict[str, float]:
    """Forward FLOPs per *token* for one layer of ``kind``."""
    d, h, g, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.d_ff)
    out: Dict[str, float] = {}
    if kind == "rwkv":
        # 5 d×d projections + decay LoRA + recurrence + channel mix
        out["rwkv_proj"] = 2 * 5 * d * d + 2 * 2 * d * 64
        out["rwkv_rec"] = 10 * d * cfg.rnn_head_dim
        out["rwkv_cmix"] = 2 * (2 * d * f + d * d)
        return out
    if kind == "rglru":
        rd = cfg.rnn_d
        out["rglru_proj"] = 2 * 3 * d * rd
        out["rglru_conv"] = 2 * cfg.conv_width * rd
        out["rglru_rec"] = 8 * rd
    else:
        kv_span = _attention_kv_span(cfg, kind, s, mode)
        out["attn_proj"] = 2 * (d * h * hd + 2 * d * g * hd + h * hd * d)
        out["attn_scores"] = 2 * 2 * kv_span * h * hd
    # MLP / MoE attaches to attn and rglru blocks (not rwkv)
    if cfg.moe is not None:
        e, k_top, fe = cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert
        out["moe_router"] = 2 * d * e
        out["moe_experts"] = 2 * 3 * d * fe * k_top * cfg.moe.capacity_factor
    else:
        out["mlp"] = 2 * (2 if cfg.gelu_mlp else 3) * d * f
    return out


def forward_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global forward FLOPs by component for one step of this cell."""
    b, s = shape.global_batch, shape.seq_len
    mode = shape.kind
    if mode == "decode":
        tokens = float(b)            # one new token per sequence
        s_ctx = s
    else:
        tokens = float(b) * s
        s_ctx = s
    plan = layer_plan(cfg)
    total: Dict[str, float] = {}
    for kind in plan.kinds:
        for name, v in _per_token_layer_flops(cfg, kind, s_ctx, mode).items():
            total[name] = total.get(name, 0.0) + v * tokens
    # unembed (+ xent is negligible)
    total["unembed"] = 2 * cfg.d_model * cfg.vocab_size * tokens
    # encoder + cross attention (whisper)
    if cfg.n_encoder_layers:
        te = cfg.encoder_seq
        enc_tokens = float(b) * te if mode != "decode" else 0.0
        d, h, g, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.d_ff)
        per_tok = (2 * (d * h * hd + 2 * d * g * hd + h * hd * d)
                   + 2 * 2 * te * h * hd + 2 * 2 * d * f)
        total["encoder"] = cfg.n_encoder_layers * per_tok * enc_tokens
        # decoder cross-attn: q/o per dec token + scores over enc_seq
        xattn = (2 * (d * h * hd + h * hd * d) + 2 * 2 * te * h * hd)
        total["cross_attn"] = cfg.n_layers * xattn * tokens
        if mode != "decode":         # cross K/V computed once per prompt
            total["cross_kv"] = cfg.n_layers * 2 * 2 * cfg.d_model * \
                cfg.n_kv_heads * cfg.hd * enc_tokens
    if cfg.n_patches and mode != "decode":
        total["mm_projector"] = 2 * (cfg.patch_dim * cfg.d_model +
                                     cfg.d_model ** 2) * b * cfg.n_patches
    return total


def _effective_shards(mesh, batch: int) -> float:
    """Devices that can share this cell's work: the model axis always,
    the data axes only up to the batch size (long_500k's B=1 cannot
    data-parallelize — that IS its bottleneck, and we report it)."""
    model = mesh.shape.get("model", 1)
    data = int(np.prod([v for k, v in mesh.shape.items() if k != "model"]))
    return model * min(data, max(batch, 1))


def param_bytes(cfg: ModelConfig) -> float:
    return cfg.n_params() * _itemsize(cfg.param_dtype)


def cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Total decode-state bytes (global)."""
    b, s = shape.global_batch, shape.seq_len
    plan = layer_plan(cfg)
    total = 0.0
    for kind in plan.kinds:
        if kind == "rwkv":
            h = cfg.d_model // cfg.rnn_head_dim
            total += b * (h * cfg.rnn_head_dim ** 2 * F32 +
                          2 * cfg.d_model * BF16)
        elif kind == "rglru":
            total += b * (cfg.rnn_d * F32 +
                          (cfg.conv_width - 1) * cfg.rnn_d * BF16)
        else:
            t = min(cfg.window, s) if kind == "local" else s
            total += b * t * cfg.n_kv_heads * cfg.hd * 2 * BF16
        if cfg.n_encoder_layers:
            total += b * cfg.encoder_seq * cfg.n_kv_heads * cfg.hd * 2 * BF16
    return total


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, float]:
    """Global HBM traffic for one step (read+write), by component."""
    p = cfg.n_params()
    act_elem_bytes = _itemsize(cfg.dtype)
    out: Dict[str, float] = {}
    if shape.kind == "train":
        micro = max(cfg.micro_steps, 1)
        reads_per_step = (2 if cfg.remat else 1) + 1   # fwd(+remat) + bwd
        out["param_reads"] = p * act_elem_bytes * reads_per_step * micro
        out["grad_traffic"] = 2 * p * F32
        out["opt_update"] = 6 * p * _itemsize(cfg.opt_state_dtype) \
            + 2 * p * _itemsize(cfg.param_dtype)
        # activations: residual stream + layer-internal tensors ~ 20·d
        # bytes/token/layer each direction (empirically calibrated vs XLA)
        tokens = shape.global_batch * shape.seq_len
        out["activations"] = 20 * cfg.d_model * act_elem_bytes * tokens * \
            cfg.n_layers * (2 if cfg.remat else 1)
    elif shape.kind == "prefill":
        out["param_reads"] = p * act_elem_bytes
        tokens = shape.global_batch * shape.seq_len
        out["activations"] = 12 * cfg.d_model * act_elem_bytes * tokens * \
            cfg.n_layers
        out["cache_write"] = cache_bytes(cfg, shape)
    else:  # decode: read params + whole cache per token
        out["param_reads"] = p * act_elem_bytes
        out["cache_read"] = cache_bytes(cfg, shape)
        out["cache_write"] = cache_bytes(cfg, shape) / max(shape.seq_len, 1)
    return out


def cell_costs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> CellCosts:
    fwd = forward_flops(cfg, shape)
    fwd_total = sum(fwd.values())
    if shape.kind == "train":
        # fwd + bwd(2×) (+ recompute: full remat ≈ +1 fwd; dots policy
        # saves matmul outputs so only the ~10% elementwise share re-runs)
        mult = 3.0 if not cfg.remat else \
            (3.1 if cfg.remat_policy == "dots" else 4.0)
    else:
        mult = 1.0
    shards = _effective_shards(mesh, shape.global_batch)
    mem = hbm_bytes(cfg, shape, mesh)
    return CellCosts(
        flops_per_device=fwd_total * mult / shards,
        hbm_bytes_per_device=sum(mem.values()) / shards,
        breakdown={**{f"flops_fwd/{k}": v for k, v in fwd.items()},
                   **{f"bytes/{k}": v for k, v in mem.items()},
                   "flops_multiplier": mult,
                   "effective_shards": shards,
                   "chips": mesh_chip_count(mesh)},
        notes=f"train_mult={mult} shards={shards}",
    )
