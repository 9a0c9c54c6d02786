"""olmo-1b [dense] — 16L d_model=2048 16H (MHA kv=16) d_ff=8192
vocab=50304.  Non-parametric LN [arXiv:2402.00838; hf].  Port of
``repro/configs/olmo_1b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    nonparam_norm=True,          # OLMo's defining non-parametric LayerNorm
    tie_embeddings=True,
    rope_theta=10000.0,
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=4, n_kv_heads=4, d_ff=192,
        vocab_size=384, dtype="float32", param_dtype="float32", attn_chunk=0,
        scan_layers=False)
