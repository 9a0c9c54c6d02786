"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
llama-arch GQA [arXiv:2403.04652; hf].  Port of
``repro/configs/yi_9b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=8, n_kv_heads=2, d_ff=192,
        vocab_size=384, dtype="float32", param_dtype="float32",
        attn_chunk=64)   # exercises the flash path on CPU
