"""RWKV-6 "Finch" mixer (arXiv:2404.05892) — port of
``repro/models/rwkv6.py``: attention-free, with a data-dependent
per-channel decay (the defining v6 feature) and a linear recurrence.

Per head (size hd), with r/k/v/g projections of the token-shift-mixed
input and decay w_t = exp(−exp(w0 + tanh(x̃ A) B)):

    y_t = rᵗ_t · (S_t + (u ⊙ k_t) v_tᵀ)
    S_{t+1} = diag(w_t) · S_t + k_t v_tᵀ

The block is self-contained: internal RMS pre-norms for the time mix and
the channel mix, and both residuals inside (``rwkv_forward`` returns
``x + tm + rr·cm``).  The recurrence runs in float32, its output cast to
the activation dtype before the per-head group norm; the decay is float32
too.  The reference scans ``cfg.rnn_chunk`` chunks, padding the last with
w = 1 and k = 0 so the state passes the padding unchanged; the port loops
over the real tokens, which gives the same states, and checkpoints each
chunk when gradients are on, as the reference's ``jax.checkpoint`` does.
State is O(H·hd²) per sequence: the decode step is the forward on one
token from the carried state.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_LORA_R = 64  # decay LoRA rank (Finch uses small low-rank decay MLPs)
_PROJ = ("wr", "wk", "wv", "wg", "wo")
_MU = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w")


def rwkv_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of the block's parameters, the
    reference's flat layer dict, in the order ``init_rwkv`` draws them."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.rnn_head_dim
    t = {name: ((d, d), ("embed", "rnn")) for name in _PROJ}
    t.update({name: ((d,), ("rnn",)) for name in _MU + ("w0",)})
    t["wd_a"] = ((d, _LORA_R), ("embed", None))
    t["wd_b"] = ((_LORA_R, d), (None, "rnn"))
    t["u"] = ((d // hd, hd), ("rnn_heads", "head_dim"))
    t.update({name: ((d,), ("rnn",)) for name in ("ln_scale", "ln1", "ln2")})
    t["cm_k"] = ((d, f), ("embed", "mlp"))
    t["cm_v"] = ((f, d), ("mlp", "embed"))
    t["cm_r"] = ((d, d), ("embed", "rnn"))
    t.update({name: ((d,), ("rnn",)) for name in ("cm_mu_k", "cm_mu_r")})
    return t


_FILL = {**{name: 0.5 for name in _MU + ("cm_mu_k", "cm_mu_r")}, "w0": -6.0, "u": 0.0,
         "ln_scale": 1.0, "ln1": 1.0, "ln2": 1.0}


def init_rwkv(gen: torch.Generator, cfg: ModelConfig, dtype, *, device) -> dict:
    """N(0, 1/fan_in) matrices; token-shift mixes 0.5, w0 = −6, the bonus u 0
    and the norm scales 1, as the reference initializes them."""
    return {name: (torch.full(shape, _FILL[name], dtype=dtype, device=device) if name in _FILL
                   else L.dense_init(gen, shape, dtype, device=device))
            for name, (shape, _) in rwkv_table(cfg).items()}


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, *, device) -> dict:
    d, hd = cfg.d_model, cfg.rnn_head_dim
    h = d // hd
    return {"wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
            "shift_tm": torch.zeros((batch, d), dtype=dtype, device=device),   # time mix
            "shift_cm": torch.zeros((batch, d), dtype=dtype, device=device)}   # channel mix


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)


def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMS norm in float32, ε = 1e-6 inside the rsqrt, cast back."""
    xf = x.float()
    out = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (out * scale.float()).to(x.dtype)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Per-head layer norm in float32 (biased variance, ε = 1e-5), scaled,
    cast back.  y (B,S,D)."""
    b, s, d = y.shape
    yf = y.reshape(b, s, n_heads, d // n_heads).float()
    mean = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    return (yn.reshape(b, s, d) * scale.float()).to(y.dtype)


def _wkv_scan(r, k, v, w, u, state0):
    """The linear recurrence over time, in float32.  r/k/v/w (B,S,H,hd), u
    (H,hd), state0 (B,H,hd,hd).  Returns (y (B,S,H,hd), final state)."""
    r, k, v, w = (t.float().transpose(0, 1).contiguous() for t in (r, k, v, w))
    ub = u.float()[None, :, :, None]
    state, ys = state0, []
    for t in range(r.shape[0]):
        kv = k[t][..., :, None] * v[t][..., None, :]                  # (B,H,hd,hd)
        ys.append((r[t][..., None, :] @ torch.addcmul(state, ub, kv))[..., 0, :])
        state = torch.addcmul(kv, w[t][..., :, None], state)
    return torch.stack(ys, dim=1), state


def _wkv_shapes(r, k, v, w, u, state0):
    """``_wkv_scan``'s outputs in shape and dtype alone, on ``meta`` tensors
    (the dry run's trace): elementwise in every input, so a backward reaches
    each of them, with no loop over the tokens."""
    y = r.float() * k.float() * v.float() * w.float() + u.float()
    return y, state0 + y[:, -1, :, :, None]


def wkv(r, k, v, w, u, state0, chunk: int):
    """``_wkv_scan`` in chunks of ``chunk`` tokens, each under a
    (non-reentrant) checkpoint when gradients are on: backward keeps one
    chunk's states.  On ``meta`` tensors, ``_wkv_shapes``."""
    if r.device.type == "meta":
        return _wkv_shapes(r, k, v, w, u, state0)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, state0))):
        return _wkv_scan(r, k, v, w, u, state0)
    state, ys = state0, []
    for c0 in range(0, r.shape[1], chunk):
        cut = slice(c0, c0 + chunk)
        y, state = checkpoint(_wkv_scan, r[:, cut], k[:, cut], v[:, cut], w[:, cut], u, state,
                              use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def shifted(xn: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The token shift: each position's previous normed input, ``shift``
    (B, D) before the first."""
    return torch.cat([shift[:, None, :], xn[:, :-1, :]], dim=1)


def time_mix_in(params, xn: torch.Tensor, x_prev: torch.Tensor):
    """The time mix's r, k, v, g (SiLU'd) and the float32 decay w of the
    output channels ``params``' projections hold (all of them, or a slot's
    columns of ``wr``/``wk``/``wv``/``wg``/``wd_b``/``w0``); the mixes ``mu_*``
    and ``wd_a`` whole."""
    r = _mix(xn, x_prev, params["mu_r"]) @ params["wr"]
    k = _mix(xn, x_prev, params["mu_k"]) @ params["wk"]
    v = _mix(xn, x_prev, params["mu_v"]) @ params["wv"]
    g = _mix(xn, x_prev, params["mu_g"]) @ params["wg"]
    g = g * L.sigmoid(g)                                      # jax.nn.silu
    dd = torch.tanh(_mix(xn, x_prev, params["mu_w"]) @ params["wd_a"]) @ params["wd_b"]
    w = torch.exp(-torch.exp(params["w0"].float() + dd.float()))
    return r, k, v, g, w


def heads_out(y: torch.Tensor, g: torch.Tensor, scale: torch.Tensor, hd: int, dtype):
    """The wkv output y (B,S,H',hd) of whole heads, cast to ``dtype``, group
    normed per head with ``scale`` (its H'·hd channels) and gated by g."""
    b, s, h = y.shape[:3]
    return _group_norm(y.reshape(b, s, h * hd).to(dtype), scale, h) * g


def channel_mix_in(params, x2n: torch.Tensor, x2_prev: torch.Tensor):
    """The channel mix's squared-ReLU key (the d_ff columns ``cm_k`` holds)
    and its sigmoid receptance (the output channels ``cm_r`` holds)."""
    kk = torch.square(torch.relu(_mix(x2n, x2_prev, params["cm_mu_k"]) @ params["cm_k"]))
    rr = L.sigmoid(_mix(x2n, x2_prev, params["cm_mu_r"]) @ params["cm_r"])
    return kk, rr


def rwkv_forward(params, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full-sequence RWKV-6 time mix + channel mix.  x (B,S,D).  Returns
    (out, new_state); ``out`` already holds both residuals."""
    b, s, d = x.shape
    hd = cfg.rnn_head_dim
    h = d // hd
    if state is None:
        state = init_rwkv_state(cfg, b, x.dtype, device=x.device)

    # ---- time mix (over the internally pre-normed input) ------------------
    xn = _rms(x, params["ln1"])
    r, k, v, g, w = time_mix_in(params, xn, shifted(xn, state["shift_tm"]))
    heads = lambda t: t.reshape(b, s, h, hd)
    y, final = wkv(heads(r), heads(k), heads(v), heads(w), params["u"], state["wkv"],
                   min(cfg.rnn_chunk, s))
    x2 = x + heads_out(y, g, params["ln_scale"], hd, x.dtype) @ params["wo"]

    # ---- channel mix ----------------------------------------------------------
    x2n = _rms(x2, params["ln2"])
    kk, rr = channel_mix_in(params, x2n, shifted(x2n, state["shift_cm"]))
    out = x2 + rr * (kk @ params["cm_v"])
    return out, {"wkv": final, "shift_tm": xn[:, -1, :].clone(),
                 "shift_cm": x2n[:, -1, :].clone()}


def rwkv_decode(params, cfg: ModelConfig, x1: torch.Tensor, state):
    """Single-token step: the forward on x1 (B,1,D) from the carried state."""
    return rwkv_forward(params, cfg, x1, state)
