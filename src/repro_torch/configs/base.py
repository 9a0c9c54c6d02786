"""Model / shape / run configuration dataclasses and the arch registry —
port of ``repro/configs/base.py``.

The dataclasses carry the reference's fields and numbers unchanged; only
``activation_dtype()`` differs, returning a ``torch.dtype``.  ``--arch
<id>`` resolves inside ``repro_torch.configs``: the dense presets
(``olmo_1b``, ``qwen3_14b``, ``yi_9b``, ``llama3_405b``), the recurrent
ones (``rwkv6_3b``, ``recurrentgemma_9b``) and the MoE ones
(``granite_moe_1b_a400m``, ``qwen3_moe_235b_a22b``), the
encoder-decoder ``whisper_large_v3`` and the VLM ``llava_next_mistral_7b``:
every preset of the reference.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config's dtype string."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden dim
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """kNN-LM retrieval head (the paper's join inside the serving path)."""
    enabled: bool = False
    datastore_size: int = 65536
    k: int = 8
    lam: float = 0.25          # λ·p_kNN + (1−λ)·p_LM
    temperature: float = 1.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    # --- per-layer mixer pattern, cycled over layers --------------------
    #   "attn" global causal, "local" windowed, "rglru", "rwkv", "enc-attn"
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                   # local-attention window
    # --- norm / attention variants --------------------------------------
    qk_norm: bool = False             # qwen3
    nonparam_norm: bool = False       # olmo (non-parametric LN)
    use_layernorm: bool = False       # LayerNorm instead of RMSNorm (whisper)
    gelu_mlp: bool = False            # plain GELU MLP instead of SwiGLU
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    # --- MoE -------------------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- SSM (rwkv / rglru) -----------------------------------------------
    rnn_head_dim: int = 64            # rwkv6 head size
    rnn_width: Optional[int] = None   # rglru recurrent width (default d_model)
    conv_width: int = 4               # rglru temporal conv
    # --- encoder-decoder ---------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # whisper: 30 s of audio frames (stub)
    # --- vlm ---------------------------------------------------------------
    n_patches: int = 0                # llava: anyres patch embeds (stub)
    patch_dim: int = 1024             # vision feature dim fed to mm_projector
    # --- retrieval (paper technique) ----------------------------------------
    retrieval: RetrievalConfig = RetrievalConfig()
    # --- numerics / execution ----------------------------------------------
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"
    remat: bool = True                # training only: recompute the scanned layers in backward
    remat_policy: str = "full"        # full | dots (keep the 2-D matmul outputs)
    scan_layers: bool = True          # the stacked parameter layout (the port loops)
    fsdp: bool = False
    seq_shard: bool = True
    opt_state_dtype: str = "float32"
    rnn_chunk: int = 512
    attn_chunk: int = 0               # 0 = dense S×T attention; >0 = flash
                                      # (chunked online-softmax, plain tensor code)
    causal_skip: bool = False         # skip fully-masked kv chunks
    xent_chunk: int = 512
    micro_steps: int = 1
    moe_sharded_dispatch: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def rnn_d(self) -> int:
        return self.rnn_width if self.rnn_width is not None else self.d_model

    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, hd = self.d_model, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        swiglu = 3 * d * self.d_ff
        gelu = 2 * d * self.d_ff
        mlp = gelu if self.gelu_mlp else swiglu
        if self.moe is not None:
            moe_mlp = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
        else:
            moe_mlp = 0
        rwkv = 6 * d * d + 2 * d * self.d_ff       # time-mix + channel-mix
        rglru = 3 * d * self.rnn_d + self.conv_width * self.rnn_d + 2 * self.rnn_d
        total = 0
        n_dec = self.n_layers
        for i in range(n_dec):
            kind = self.block_pattern[i % len(self.block_pattern)]
            if kind == "rwkv":
                total += rwkv
                continue
            if kind == "rglru":
                total += rglru
            else:
                total += attn
            total += moe_mlp if self.moe is not None else mlp
        total += self.n_encoder_layers * (attn + mlp)
        if self.n_encoder_layers:                   # decoder cross-attention
            total += n_dec * attn
        emb = self.vocab_size * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        moe_all = self.n_layers * self.moe.n_experts * 3 * d * self.moe.d_expert
        moe_active = self.n_layers * self.moe.top_k * 3 * d * self.moe.d_expert
        return full - moe_all + moe_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                 # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "llama3_405b", "olmo_1b", "qwen3_14b", "yi_9b", "rwkv6_3b",
    "qwen3_moe_235b_a22b", "granite_moe_1b_a400m", "recurrentgemma_9b",
    "whisper_large_v3", "llava_next_mistral_7b",
]

# The presets this port carries: all of the reference's.
PORTED_ARCHS = tuple(ARCH_IDS)


def sub_quadratic(cfg: ModelConfig) -> bool:
    """True if every mixer is O(1)-state or windowed (long_500k eligible)."""
    return all(kind in ("rwkv", "rglru", "local") for kind in cfg.block_pattern)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells that lower for this arch (skips recorded in DESIGN.md §4)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if sub_quadratic(cfg):
        shapes.append("long_500k")
    return shapes


def _preset(arch: str):
    arch = arch.replace("-", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; expected one of {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _preset(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _preset(arch).smoke_config()


def registry() -> dict[str, ModelConfig]:
    """Every preset's published config by arch id."""
    return {a: get_config(a) for a in ARCH_IDS}
