"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8)
d_expert=512 vocab=49155, MoE 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].  Port of
``repro/configs/granite_moe_1b_a400m.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite_moe_1b_a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                    # per the assignment (== d_expert)
    vocab_size=49155,
    tie_embeddings=True,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=4, n_kv_heads=2, d_ff=96,
        vocab_size=384, moe=MoEConfig(n_experts=4, top_k=2, d_expert=96),
        dtype="float32", param_dtype="float32", attn_chunk=0,
        scan_layers=False)
