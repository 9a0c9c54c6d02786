"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
port of ``repro/models/rglru.py``.

    x̃  = conv1d_w4(W_in x)                      (temporal conv, width 4)
    iₜ = σ(x̃ₜ ⊙ w_i + b_i)                      (input gate, per channel)
    aₜ = exp(−c · softplus(Λ) · σ(x̃ₜ ⊙ w_a + b_a))   (recurrence gate)
    hₜ = aₜ ⊙ hₜ₋₁ + √(1−aₜ²) ⊙ (iₜ ⊙ x̃ₜ)
    out = W_out( GeLU(W_gate x) ⊙ h )

The reference's per-channel (diagonal) gates, its float32 gates and
state, and its parameter names and layouts (``w_in`` (d, rd), ``conv``
(cw, rd), ...).  The reference scans the recurrence in ``cfg.rnn_chunk``
chunks, padding the last with a = 1 and drive 0 so the state passes the
padding unchanged; the port loops over the real tokens, which gives the
same states, and checkpoints each chunk when gradients are on, as the
reference's ``jax.checkpoint`` does.  State is O(rd) per sequence: the
decode step is the forward on one token from the carried state.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_C = 8.0  # Griffin's fixed recurrence constant


def rglru_table(cfg: ModelConfig) -> dict:
    """name -> (shape, logical axes) of the block's parameters, in the
    order ``init_rglru`` draws them."""
    d, rd, cw = cfg.d_model, cfg.rnn_d, cfg.conv_width
    t = {"w_in": ((d, rd), ("embed", "rnn")), "w_gate": ((d, rd), ("embed", "rnn")),
         "w_out": ((rd, d), ("rnn", "embed")), "conv": ((cw, rd), ("conv", "rnn"))}
    for name in ("lam", "w_i", "b_i", "w_a", "b_a"):
        t[name] = ((rd,), ("rnn",))
    return t


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype, *, device) -> dict:
    """N(0, 1/fan_in) projections, the conv N(0, 1/cw), Λ = 0 and the gates'
    weights 1 and biases 0, as the reference initializes them."""
    t = rglru_table(cfg)
    p = {k: L.dense_init(gen, t[k][0], dtype, device=device) for k in ("w_in", "w_gate", "w_out")}
    p["conv"] = _conv_init(gen, cfg.conv_width, cfg.rnn_d, dtype, device)
    fill = {"lam": 0.0, "w_i": 1.0, "b_i": 0.0, "w_a": 1.0, "b_a": 0.0}
    for name, v in fill.items():
        p[name] = torch.full(t[name][0], v, dtype=dtype, device=device)
    return p


def _conv_init(gen: torch.Generator, cw: int, rd: int, dtype, device) -> torch.Tensor:
    return L._normal(gen, (cw, rd), 1.0 / math.sqrt(cw), dtype, device)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, *, device) -> dict:
    rd, cw = cfg.rnn_d, cfg.conv_width
    return {"h": torch.zeros((batch, rd), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, rd), dtype=dtype, device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: torch.Tensor):
    """Depthwise causal conv, width cw.  x (B,S,rd), carry (B,cw−1,rd) the
    trailing inputs before x.  Returns (out (B,S,rd), the new carry)."""
    cw, s = w.shape[0], x.shape[1]
    xx = torch.cat([carry, x], dim=1)                    # (B, S+cw−1, rd)
    out = sum(xx[:, i:i + s, :] * w[i][None, None, :] for i in range(cw))
    return out, xx[:, -(cw - 1):, :].clone()


def _gates(params, xt: torch.Tensor):
    """Per-channel input and recurrence gates for conv output xt (..., rd),
    both float32: (i, a)."""
    xf = xt.float()
    i_g = L.sigmoid(xf * params["w_i"].float() + params["b_i"].float())
    a_exp = L.sigmoid(xf * params["w_a"].float() + params["b_a"].float())
    lam = params["lam"].float()
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * a_exp   # softplus(Λ)
    return i_g, torch.exp(log_a)


def _scan(a: torch.Tensor, drive: torch.Tensor, h0: torch.Tensor):
    """hₜ = aₜ·hₜ₋₁ + driveₜ over the sequence axis of (B, T, rd) float32
    inputs: (h (B, T, rd), the last h)."""
    h, hs = h0, []
    for t in range(a.shape[1]):
        h = torch.addcmul(drive[:, t], a[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _scan_shapes(a: torch.Tensor, drive: torch.Tensor, h0: torch.Tensor):
    """``_scan``'s outputs in shape and dtype alone, on ``meta`` tensors (the
    dry run's trace): elementwise in every input, so a backward reaches
    each of them, with no loop over the tokens."""
    h = a * drive + h0[:, None, :]
    return h, h[:, -1]


def linear_scan(a: torch.Tensor, drive: torch.Tensor, h0: torch.Tensor, chunk: int):
    """``_scan`` in chunks of ``chunk`` tokens, each under a (non-reentrant)
    checkpoint when gradients are on: backward keeps one chunk's states.
    On ``meta`` tensors, ``_scan_shapes``."""
    if a.device.type == "meta":
        return _scan_shapes(a, drive, h0)
    if not (torch.is_grad_enabled() and (a.requires_grad or drive.requires_grad
                                         or h0.requires_grad)):
        return _scan(a, drive, h0)
    h, outs = h0, []
    for c0 in range(0, a.shape[1], chunk):
        hc, h = checkpoint(_scan, a[:, c0:c0 + chunk], drive[:, c0:c0 + chunk], h,
                           use_reentrant=False)
        outs.append(hc)
    return torch.cat(outs, dim=1), h


def rglru_forward(params, cfg: ModelConfig, x: torch.Tensor, state=None):
    """Full-sequence RG-LRU.  x (B,S,D) -> (out (B,S,D), new_state)."""
    b = x.shape[0]
    if state is None:
        state = init_rglru_state(cfg, b, x.dtype, device=x.device)
    xc, conv_carry = _causal_conv(x @ params["w_in"], params["conv"], state["conv"])
    i_g, a = _gates(params, xc)                          # (B,S,rd) f32
    drive = (i_g * xc.float()) * torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    h, h_final = linear_scan(a, drive, state["h"], min(cfg.rnn_chunk, x.shape[1]))
    gate = L._gelu_tanh(x @ params["w_gate"])
    out = (gate * h.to(x.dtype)) @ params["w_out"]
    return out, {"h": h_final, "conv": conv_carry}


def rglru_decode(params, cfg: ModelConfig, x1: torch.Tensor, state):
    """Single-token step: the forward on x1 (B,1,D) from the carried state."""
    return rglru_forward(params, cfg, x1, state)
