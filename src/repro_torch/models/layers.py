"""Shared NN layers of the model code — port of ``repro/models/layers.py``
(the decoder's layers: the kNN-LM's serving path, the trainer, the MoE
layer; the encoder's bidirectional attention and cross-attention).

Parameters are mappings of tensors (a plain dict, or an
``nn.ParameterDict`` of ``models.transformer.Block``), with the JAX
package's names and layouts: ``wq`` (d, h, hd), ``wo`` (h, hd, d), ``tok``
(vocab, d), so weights cross between the packages unchanged.  Every init
draws from an explicit ``torch.Generator`` and returns the tensors alone;
each sublayer's shapes and logical sharding axes (which the reference's
inits return beside the tensors) come from one table, ``*_table(cfg)``,
that the init and ``transformer.param_specs`` both read.

The arithmetic follows the reference step for step, including where it
rounds: norms in float32 and cast back; ``_gqa_attend``'s logits in the
activation dtype, then float32; the flash loop's products in float32 (the
reference's ``preferred_element_type=f32``), which the port gets by
upcasting the operands before the product — a bf16 product would round
its output.  The products are plain ``torch`` matmuls (the reference
leaves them to XLA); no fused attention operator is used, as it would
change the summation.

The MoE layer (``init_moe``, ``apply_moe``) is the reference's
sort-based, capacity-bounded top-k dispatch on one device: a stable
descending sort for the top-k (the reference's tie-break, which
``torch.topk`` does not keep), the experts' products as batched matmuls,
and a combine that adds each token's contributions in a fixed order (no
atomics), in named steps (``_route``, ``_sort``, ``_keep``, ``_buffer``,
``_experts``, ``_combine``) that the slot program (``models/spmd.py``)
calls too; ``apply_moe`` takes the reference's per-data-shard dispatch
where ``cfg.moe_sharded_dispatch`` asks for it.

Attention comes in the reference's three kinds: causal ``attn``, windowed
``local`` and the encoder's bidirectional ``enc-attn``, each roped; and
cross-attention (``encoder_out=``, ``cross_cache=``): a decoder query over
the encoder's output, unroped, under a full mask, its parameters without
qk-norm scales; its K/V are computed once a request (``init_cross_cache``).

``chunked_xent`` is the trainer's loss.  The recurrent mixers are
``models/rglru.py`` and ``models/rwkv6.py``; the attention functions
refuse their kinds.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import axis_size, data_axis_names

MASKED = -1e30                     # the reference's mask value (not −inf)


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    return (scale * torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device)).to(dtype)


def dense_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None, *,
               device) -> torch.Tensor:
    """N(0, 1/fan_in) weights; ``fan_in`` defaults to ``shape[0]``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return _normal(gen, shape, scale, dtype, device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def norm_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of a norm's parameters."""
    if cfg.nonparam_norm:
        return {}
    t = {"scale": ((cfg.d_model,), ("embed",))}
    if cfg.use_layernorm:
        t["bias"] = ((cfg.d_model,), ("embed",))
    return t


def init_norm(cfg: ModelConfig, dtype, *, device) -> dict:
    return {k: (torch.ones if k == "scale" else torch.zeros)(shp, dtype=dtype, device=device)
            for k, (shp, _) in norm_table(cfg).items()}


def apply_norm(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (also OLMo's non-parametric one) or RMSNorm over the last
    dim, in float32 with ε = 1e-6 inside the rsqrt; ``var`` is the biased
    variance.  The result is cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.use_layernorm or cfg.nonparam_norm:
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        out = (xf - mean) * torch.rsqrt(var + 1e-6)
    else:  # RMSNorm
        out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    if params and "scale" in params:
        out = out * params["scale"].float()
    if params and "bias" in params:
        out = out + params["bias"].float()
    return out.to(x.dtype)


def rms_head_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head RMS norm for qk-norm (qwen3); x (..., hd)."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (out * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin), each (..., head_dim//2) f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, nh, hd); cos/sin (..., S, hd//2) broadcast over heads.
    The rotation is half-split (first half against second), not
    interleaved."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA; global / local / bidirectional / cross; prefill + decode)
# --------------------------------------------------------------------------

def attention_table(cfg: ModelConfig, cross: bool = False) -> dict:
    """name -> (shape, logical axes) of an attention's parameters, in the
    order ``init_attention`` draws them; a cross-attention has no qk-norm
    scales, whatever ``cfg.qk_norm`` says."""
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {"wq": ((d, h, hd), ("embed", "heads", "head_dim")),
         "wk": ((d, g, hd), ("embed", "kv_heads", "head_dim")),
         "wv": ((d, g, hd), ("embed", "kv_heads", "head_dim")),
         "wo": ((h, hd, d), ("heads", "head_dim", "embed"))}
    if cfg.qk_norm and not cross:
        t["q_norm"] = ((hd,), ("head_dim",))
        t["k_norm"] = ((hd,), ("head_dim",))
    return t


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype, *, device,
                   cross: bool = False) -> dict:
    fan_in = {"wo": cfg.n_heads * cfg.hd}
    return {k: (torch.ones(shp, dtype=dtype, device=device) if k.endswith("_norm") else
                dense_init(gen, shp, dtype, fan_in=fan_in.get(k), device=device))
            for k, (shp, _) in attention_table(cfg, cross).items()}


def _qkv(params, cfg: ModelConfig, x, kv_input, positions, kv_positions, use_rope: bool = True):
    """q of ``x``, k and v of ``kv_input``; qk-norm where the parameters
    hold its scales, then RoPE at the given positions unless ``use_rope``
    is off (cross-attention)."""
    hd = cfg.hd
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("btd,dgk->btgk", kv_input, params["wk"])
    v = torch.einsum("btd,dgk->btgk", kv_input, params["wv"])
    if "q_norm" in params:
        q = rms_head_norm(q, params["q_norm"])
        k = rms_head_norm(k, params["k_norm"])
    if not use_rope:
        return q, k, v
    qc, qs = rope_angles(positions, hd, cfg.rope_theta)
    kc, ks = rope_angles(kv_positions, hd, cfg.rope_theta)
    return apply_rope(q, qc, qs), apply_rope(k, kc, ks), v


def _gqa_attend(cfg: ModelConfig, q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,G,hd), mask (B,S,T) or (S,T) bool (True=keep).
    The logits are computed in the activation dtype and then cast to
    float32, as the reference's einsum is."""
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = h // g
    b, sq = q.shape[0], q.shape[1]
    qg = q.reshape(b, sq, g, rep, hd)
    logits = torch.einsum("bsgrk,btgk->bgrst", qg, k).float()
    logits = logits / math.sqrt(hd)
    if mask.dim() == 2:
        mask = mask[None]
    logits = logits.masked_fill(~mask[:, None, None, :, :], MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgk->bsgrk", probs, v)
    return out.reshape(b, sq, h, hd)


def _flash_attend(cfg: ModelConfig, q, k, v, *, kind: str, q_chunk: int, kv_chunk: int,
                  causal_skip: bool):
    """Chunked online-softmax attention: the (S, T) logits are never
    materialized (peak B·qc·kc per step).  The reference's ``lax.scan``
    over kv chunks is a loop here.  ``attn`` and ``local`` are causal
    (``local`` windowed too); ``enc-attn`` and ``cross`` keep every key but
    the padding.  With ``causal_skip`` the loop over q chunks of a causal
    kind visits only kv chunks at or below the diagonal (exact)."""
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rep = h // g
    b, s = q.shape[0], q.shape[1]
    t = k.shape[1]
    dev = q.device
    causal = kind in ("attn", "local")
    scale = 1.0 / math.sqrt(hd)

    qc = min(q_chunk, s)
    kc = min(kv_chunk, t)
    n_q = -(-s // qc)
    n_kv_total = -(-t // kc)
    s_pad, t_pad = n_q * qc, n_kv_total * kc
    if s_pad != s:
        q = F.pad(q, (0, 0, 0, 0, 0, s_pad - s))
    if t_pad != t:
        k = F.pad(k, (0, 0, 0, 0, 0, t_pad - t))
        v = F.pad(v, (0, 0, 0, 0, 0, t_pad - t))
    qg = q.reshape(b, n_q, qc, g, rep, hd)
    kg = k.reshape(b, n_kv_total, kc, g, hd)
    vg = v.reshape(b, n_kv_total, kc, g, hd)

    outs = []
    for i in range(n_q):
        q_i = qg[:, i].float()                      # (B, qc, G, rep, hd)
        q_pos = i * qc + torch.arange(qc, device=dev)
        n_kv = -(-min((i + 1) * qc, t) // kc) if (causal and causal_skip) else n_kv_total
        m = torch.full((b, g, rep, qc), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((b, g, rep, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g, rep, qc, hd), dtype=torch.float32, device=dev)
        for j in range(n_kv):
            k_j, v_j = kg[:, j], vg[:, j]
            kv_pos = j * kc + torch.arange(kc, device=dev)
            logits = torch.einsum("bqgrk,btgk->bgrqt", q_i, k_j.float()) * scale
            mask = (kv_pos[None, :] < t).expand(qc, kc)
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            if kind == "local" and cfg.window:
                mask = mask & (q_pos[:, None] - kv_pos[None, :] < cfg.window)
            logits = logits.masked_fill(~mask, MASKED)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqt,btgk->bgrqk", p.to(v_j.dtype).float(), v_j.float())
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B,G,rep,qc,hd) -> (B,qc,H,hd)
        outs.append(torch.movedim(out_i, 3, 1).reshape(b, qc, h, hd))
    out = torch.cat(outs, dim=1)[:, :s]
    return out.to(q.dtype)


def _self_mask(cfg: ModelConfig, kind: str, s: int, device) -> torch.Tensor:
    """(s, s) keep-mask of a self-attention: causal, windowed for ``local``,
    full for the encoder's ``enc-attn``."""
    if kind == "enc-attn":
        return torch.ones((s, s), dtype=torch.bool, device=device)
    sq = torch.arange(s, device=device)
    mask = sq[:, None] >= sq[None, :]
    if kind == "local":
        mask = mask & (sq[:, None] - sq[None, :] < cfg.window)
    return mask


def _check_kind(kind: str, what: str) -> None:
    if kind not in ("attn", "local", "enc-attn"):
        raise ValueError(f"{what} of kind {kind!r}: not an attention kind")


def attention_forward_collect(params, cfg: ModelConfig, x, *, kind: str = "attn",
                              positions: Optional[torch.Tensor] = None, shd=None):
    """Self-attention over a full sequence (prefill); returns (out, (k, v))
    with the roped K/V for cache construction.  Flash runs only when the
    sequence is longer than ``cfg.attn_chunk``."""
    _check_kind(kind, "attention")
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(params, cfg, x, x, positions, positions)
    out = self_attend(cfg, q, k, v, kind=kind)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), (k, v)


def self_attend(cfg: ModelConfig, q, k, v, *, kind: str):
    """Self-attention (causal, or bidirectional for ``enc-attn``) of roped q
    (B,S,H,hd) over k/v (B,S,G,hd), H and G as ``cfg`` gives them: the flash
    loop when the sequence is longer than ``cfg.attn_chunk``, else the dense
    ``_gqa_attend``."""
    s = q.shape[1]
    if cfg.attn_chunk and s > cfg.attn_chunk:
        return _flash_attend(cfg, q, k, v, kind=kind, q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk, causal_skip=cfg.causal_skip)
    return _gqa_attend(cfg, q, k, v, _self_mask(cfg, kind, s, q.device))


def attention_forward(params, cfg: ModelConfig, x, *, kind: str = "attn",
                      encoder_out=None, positions: Optional[torch.Tensor] = None, shd=None):
    """Full-sequence attention (train / prefill): self-attention of
    ``kind``, or cross-attention over ``encoder_out`` (B,T,D) when given:
    unroped, every key kept, in the flash loop (no causal mask, the padded
    keys dropped) when the decoder's sequence is longer than
    ``cfg.attn_chunk``, else the dense ``_gqa_attend``."""
    if encoder_out is None:
        return attention_forward_collect(params, cfg, x, kind=kind, positions=positions)[0]
    q, k, v = _qkv(params, cfg, x, encoder_out, None, None, use_rope=False)
    return torch.einsum("bshk,hkd->bsd", cross_attend(cfg, q, k, v), params["wo"])


def cross_attend(cfg: ModelConfig, q, k, v):
    """Cross-attention of unroped q (B,S,H,hd) over k/v (B,T,G,hd), every
    key kept: the flash loop (no causal mask, the padded keys dropped) when
    the decoder's sequence is longer than ``cfg.attn_chunk``, else the dense
    ``_gqa_attend``."""
    s, t = q.shape[1], k.shape[1]
    if cfg.attn_chunk and s > cfg.attn_chunk:
        return _flash_attend(cfg, q, k, v, kind="cross", q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk, causal_skip=False)
    return _gqa_attend(cfg, q, k, v, torch.ones((s, t), dtype=torch.bool, device=q.device))


def pad_cache(kv: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Zero-pad a (B,S,G,hd) prefill K/V to the static cache length."""
    s = kv.shape[1]
    if s >= cache_len:
        return kv[:, :cache_len]
    return F.pad(kv, (0, 0, 0, 0, 0, cache_len - s))


def attention_decode(params, cfg: ModelConfig, x1, cache: dict, pos: int, *,
                     kind: str = "attn", encoder_out=None, cross_cache=None):
    """One-token decode.  x1 (B,1,D); ``pos`` the absolute position.
    Writes the token's K/V into ``cache`` in place (slot ``pos``, or
    ``pos % t`` in the local ring) — where the reference returns an updated
    copy — and returns (out (B,1,D), cache).

    Cross-attention, with ``cross_cache`` (``init_cross_cache``'s K/V) or
    else ``encoder_out`` (its K/V computed here): the token's unroped query
    over every encoder position; ``cache`` is returned untouched."""
    if encoder_out is not None or cross_cache is not None:
        if cross_cache is None:
            q, k, v = _qkv(params, cfg, x1, encoder_out, None, None, use_rope=False)
        else:
            q = torch.einsum("bsd,dhk->bshk", x1, params["wq"])
            k, v = cross_cache["k"], cross_cache["v"]
        return torch.einsum("bshk,hkd->bsd", cross_attend(cfg, q, k, v), params["wo"]), cache
    _check_kind(kind, "attention decode")
    b = x1.shape[0]
    pos = int(pos)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x1.device)
    q, k1, v1 = _qkv(params, cfg, x1, x1, posb, posb)
    t_cache = cache["k"].shape[1]
    slot = pos % t_cache if kind == "local" else pos
    cache["k"][:, slot] = k1[:, 0]
    cache["v"][:, slot] = v1[:, 0]
    idx = torch.arange(t_cache, device=x1.device)
    last = min(pos, t_cache - 1) if kind == "local" else pos
    mask = (idx <= last)[None, None, :].expand(b, 1, t_cache)
    out = _gqa_attend(cfg, q, cache["k"], cache["v"], mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def init_cross_cache(params, cfg: ModelConfig, encoder_out) -> dict:
    """A decoder layer's cross-attention K/V (B,T,G,hd) of the encoder's
    output, unroped: computed once a request, by prefill."""
    return {"k": torch.einsum("btd,dgk->btgk", encoder_out, params["wk"]),
            "v": torch.einsum("btd,dgk->btgk", encoder_out, params["wv"])}


# --------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# --------------------------------------------------------------------------

def mlp_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of the MLP's weights, in draw order."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gelu_mlp:
        return {"w_in": ((d, f), ("embed", "mlp")), "w_out": ((f, d), ("mlp", "embed"))}
    return {"w_gate": ((d, f), ("embed", "mlp")), "w_up": ((d, f), ("embed", "mlp")),
            "w_down": ((f, d), ("mlp", "embed"))}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype, *, device) -> dict:
    return {k: dense_init(gen, shp, dtype, device=device)
            for k, (shp, _) in mlp_table(cfg).items()}


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the reference rounds it: 1 / (1 + e^−x), each
    step in x's dtype (``torch.sigmoid`` rounds once, an ulp away in
    bf16)."""
    return torch.reciprocal(1 + torch.exp(-x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default, the tanh approximation) step by step,
    each step rounded to x's dtype and the constants cast to it first, as
    the reference computes it; ``F.gelu`` rounds once, an ulp away in bf16."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=torch.float64).to(x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def apply_mlp(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.gelu_mlp:
        return _gelu_tanh(x @ params["w_in"]) @ params["w_out"]
    a = x @ params["w_gate"]
    u = x @ params["w_up"]
    # jax.nn.silu is a·sigmoid(a), each step rounded to the activation dtype;
    # F.silu rounds once, so in bf16 it differs by an ulp.
    return (a * sigmoid(a) * u) @ params["w_down"]


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------

def moe_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of the MoE layer's weights, in draw
    order: the router, then the experts' SwiGLU weights."""
    d, e, f = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    return {"router": ((d, e), ("embed", "experts")),
            "w_gate": ((e, d, f), ("experts", "embed", "expert_mlp")),
            "w_up": ((e, d, f), ("experts", "embed", "expert_mlp")),
            "w_down": ((e, f, d), ("experts", "expert_mlp", "embed"))}


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, *, device) -> dict:
    d, f = cfg.d_model, cfg.moe.d_expert
    fan_in = {"w_gate": d, "w_up": d, "w_down": f}
    return {k: dense_init(gen, shp, dtype, fan_in=fan_in.get(k), device=device)
            for k, (shp, _) in moe_table(cfg).items()}


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values in
    descending order, a tie going to the lower index (a stable descending
    sort; ``torch.topk`` breaks ties in no fixed order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_probs(params, xt: torch.Tensor) -> torch.Tensor:
    """The router: logits in the activation dtype, then a float32 softmax."""
    return torch.softmax((xt @ params["router"]).float(), dim=-1)


# The dispatch in named steps, which the one-device layer (``_moe_dispatch``)
# and the slot program (``models/spmd.py``) both call.

def _route(cfg: ModelConfig, probs: torch.Tensor):
    """The top-k of the router's probabilities (T, e): (gates (T, K)
    renormalized to sum to 1, expert ids (T, K))."""
    gates, eidx = _top_k(probs, cfg.moe.top_k)
    return gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), eidx


def _aux(cfg: ModelConfig, density: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
    """The Switch-style load-balance loss from the means over the tokens of
    one_hot(top-1) (``density``) and of the probabilities (``proxy``)."""
    return (density * proxy).sum() * cfg.moe.n_experts


def _sort(cfg: ModelConfig, eidx: torch.Tensor):
    """The flat (token, k) assignments sorted by expert, stably: (order,
    their experts ``se``, each expert's first sorted position ``starts``)."""
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    return order, se, torch.searchsorted(se, torch.arange(cfg.moe.n_experts,
                                                          device=eidx.device))


def _keep(cfg: ModelConfig, se, starts, cap: int, rows: int, offsets=None):
    """(keep, slot) of each sorted assignment: kept where its position among
    its expert's assignments, after ``offsets[e]`` of them ahead of this
    block (the data groups before this one), is below ``cap``; ``slot`` its
    row of an expert-major buffer of ``rows`` rows an expert, e·rows where
    it is dropped."""
    pos = torch.arange(se.shape[0], device=se.device) - starts[se]
    keep = (pos if offsets is None else pos + offsets[se]) < cap
    return keep, torch.where(keep, se * rows + pos, cfg.moe.n_experts * rows)


def _buffer(xt: torch.Tensor, order, k_top: int, slot, n_rows: int) -> torch.Tensor:
    """The (n_rows, d) buffer of the assignments' tokens by ``slot``; row
    n_rows takes every slot past the buffer and is cut off."""
    buf = xt.new_zeros((n_rows + 1, xt.shape[1]))
    st = torch.div(order, k_top, rounding_mode="floor")            # the token of each
    return buf.index_put((slot,), xt[st])[:n_rows]


def _experts(params, h: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over h (e, rows, d) as batched products."""
    a = torch.bmm(h, params["w_gate"])
    u = torch.bmm(h, params["w_up"])
    return torch.bmm(a * sigmoid(a) * u, params["w_down"])


def _combine(of: torch.Tensor, keep, slot, gates, order, k_top: int) -> torch.Tensor:
    """(T, d): each token's kept contributions from the expert rows ``of``
    (e·rows, d), gate-weighted and added one after another in of's dtype,
    by expert ascending, as the reference's scatter-add meets them, so the
    sum is the same each run (no atomics)."""
    t = gates.shape[0]
    sg = gates.reshape(-1)[order]
    contrib = torch.where(keep[:, None], of[slot.clamp(max=of.shape[0] - 1)], 0.0) * \
        sg[:, None].to(of.dtype)
    # Each token's K sorted positions, ascending: its contributions by expert.
    at = torch.empty_like(order)
    at[order] = torch.arange(t * k_top, device=order.device)
    parts = contrib[at.reshape(t, k_top).sort(dim=1).values]      # (T, K, d)
    out = parts[:, 0]
    for i in range(1, k_top):
        out = out + parts[:, i]
    return out


def _moe_dispatch(params, cfg: ModelConfig, xt: torch.Tensor, cap: int):
    """Sort-based capacity-bounded top-k dispatch of a token block xt (T, d),
    step for step as the reference: the router's logits in the activation
    dtype, then a float32 softmax and top-k; the assignments sorted by
    expert (stably), each expert's first ``cap`` of them written to its rows
    of an (e·cap, d) buffer and the rest dropped; the experts' SwiGLU as
    batched products; the ordered combine.  Returns (out (T, d), aux ()),
    the Switch-style load-balance loss."""
    t, d = xt.shape
    e, k_top = cfg.moe.n_experts, cfg.moe.top_k
    probs = _router_probs(params, xt)
    gates, eidx = _route(cfg, probs)
    aux = _aux(cfg, F.one_hot(eidx[:, 0], e).float().mean(0), probs.mean(0))
    order, se, starts = _sort(cfg, eidx)
    keep, slot = _keep(cfg, se, starts, cap, cap)
    h = _buffer(xt, order, k_top, slot, e * cap).reshape(e, cap, d)
    of = _experts(params, h).reshape(e * cap, d)
    return _combine(of, keep, slot, gates, order, k_top), aux


def _moe_cap(cfg: ModelConfig, t: int) -> int:
    cap = int(math.ceil(t * cfg.moe.top_k / cfg.moe.n_experts * cfg.moe.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_chunks(cfg: ModelConfig, t: int, n_data: int) -> int:
    """How many capacity buffers the reference's ``apply_moe`` cuts t tokens
    into on a mesh of ``n_data`` data slots: one a data slot where
    ``cfg.moe_sharded_dispatch`` is set, there are several and their count
    divides t; else one."""
    return n_data if (cfg.moe_sharded_dispatch and n_data > 1 and t % n_data == 0) else 1


def apply_moe(params, cfg: ModelConfig, x: torch.Tensor, shd=None):
    """MoE layer over x (B, S, D).  Returns (out, aux).  The global dispatch
    (the reference's baseline): one capacity buffer over all B·S tokens.
    The per-data-shard dispatch (``moe_chunks`` > 1 on ``shd``'s mesh): the
    flat tokens cut into one contiguous chunk a data slot, each dispatched
    into its own buffer with a chunk's capacity, the aux the mean of the
    chunks' (the reference's ``jax.vmap`` over the chunks, as a loop)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    mesh = None if shd is None else shd.mesh
    n = moe_chunks(cfg, t, 1 if mesh is None else axis_size(mesh, data_axis_names(mesh)))
    if n == 1:
        out, aux = _moe_dispatch(params, cfg, xt, _moe_cap(cfg, t))
        return out.reshape(b, s, d), aux
    cap = _moe_cap(cfg, t // n)
    outs, auxes = zip(*(_moe_dispatch(params, cfg, c, cap) for c in xt.chunk(n)))
    return torch.cat(outs).reshape(b, s, d), torch.stack(auxes).mean()


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embedding_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of the embeddings, in draw order."""
    t = {"tok": ((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        t["unembed"] = ((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return t


def init_embeddings(gen: torch.Generator, cfg: ModelConfig, dtype, *, device) -> dict:
    fan_in = {"tok": cfg.d_model}
    return {k: dense_init(gen, shp, dtype, fan_in=fan_in.get(k), device=device)
            for k, (shp, _) in embedding_table(cfg).items()}


def embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens.long()].to(cfg.activation_dtype())


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits ``x @ W``; W is ``tok.T`` under tied embeddings.  Mixed
    dtypes promote as the reference's einsum does (bf16 hidden states
    against float32 master weights give float32 logits)."""
    w = params["tok"].T if cfg.tie_embeddings else params["unembed"]
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def chunked_nll(nll_fn, xs, labels, mask, chunk: int = 512):
    """The masked next-token NLL summed over sequence chunks, and the
    mask's sum: (Σ nll·mask, Σ mask).  Each tensor of ``xs`` (B, S, ...),
    ``labels`` and ``mask`` is padded to a multiple of ``chunk`` along S;
    ``nll_fn(*x_chunks, label_chunk)`` gives a chunk's per-token NLL.  With
    gradients on, each chunk runs under a (non-reentrant) checkpoint, so
    backward holds one chunk's logits at a time and recomputes them, where
    the reference's ``lax.map`` keeps its residuals."""
    s = labels.shape[1]
    chunk = min(chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        xs = [F.pad(x, (0, 0, 0, pad)) for x in xs]
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))

    def one(li, mi, *xi):
        nll = nll_fn(*xi, li) * mi
        return nll.sum(), mi.sum()

    tot, cnt = [], []
    for i in range(n_chunks):
        cut = slice(i * chunk, (i + 1) * chunk)
        part = (labels[:, cut], mask[:, cut]) + tuple(x[:, cut] for x in xs)
        t, c = (checkpoint(one, *part, use_reentrant=False) if torch.is_grad_enabled()
                else one(*part))
        tot.append(t)
        cnt.append(c)
    return torch.stack(tot).sum(), torch.stack(cnt).sum()


def chunked_xent(logits_fn, x, labels, mask, chunk: int = 512):
    """Mean next-token cross-entropy over sequence chunks, so the (B, S, V)
    logits are never all materialized (peak B·chunk·V): per chunk
    (``chunked_nll``), float32 logits, their ``logsumexp``, the gold logit
    and the masked NLL; the sum over ``max(the mask's sum, 1)``."""
    def nll(xi, li):
        logits = logits_fn(xi).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
        return lse - gold

    tot, cnt = chunked_nll(nll, [x], labels, mask, chunk)
    return tot / torch.clamp(cnt, min=1.0)
