"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936.  qk_norm, GQA, head_dim=128 [hf:Qwen/Qwen3-8B; hf].  Port of
``repro/configs/qwen3_14b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,                # qwen3's per-head RMS q/k norm
    rope_theta=1000000.0,
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab_size=384, head_dim=16, dtype="float32", param_dtype="float32",
        attn_chunk=0)
