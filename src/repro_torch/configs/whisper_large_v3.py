"""whisper-large-v3 [audio] — 32L d_model=1280 20H (MHA kv=20) d_ff=5120
vocab=51866.  Enc-dec; conv frontend is a STUB per the assignment —
``input_specs()`` feeds precomputed (B, 1500, d_model) frame embeddings
[arXiv:2212.04356; unverified].  Port of
``repro/configs/whisper_large_v3.py``: the same numbers.

Adaptation (DESIGN.md §4.1): learned absolute positions -> RoPE so the
decoder shares the zoo's single attention implementation."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_large_v3",
    family="encdec",
    n_layers=32,                 # decoder layers
    n_encoder_layers=32,
    encoder_seq=1500,            # 30 s of audio at 50 frames/s
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    use_layernorm=True,
    gelu_mlp=True,
    rope_theta=10000.0,
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, encoder_seq=24, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=384,
        dtype="float32", param_dtype="float32", attn_chunk=0)
