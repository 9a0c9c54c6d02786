"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
d_expert=1536 vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B; hf].  Port of
``repro/configs/qwen3_moe_235b_a22b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,                   # per the assignment (== d_expert)
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    fsdp=True,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=96,
        vocab_size=384, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
        fsdp=False, param_dtype="float32", dtype="float32", attn_chunk=0)
