"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536.
Finch — data-dependent decay [arXiv:2404.05892; hf].  Port of
``repro/configs/rwkv6_3b.py``: the same numbers.

Attention-free ⇒ O(1) decode state ⇒ this arch runs the long_500k cell."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                  # informational: d_model / rnn_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rnn_head_dim=64,
    rnn_chunk=512,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=384, rnn_head_dim=16, rnn_chunk=16,
        dtype="float32", param_dtype="float32")
