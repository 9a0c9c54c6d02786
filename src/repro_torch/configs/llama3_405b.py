"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  GQA, 128k vocab [arXiv:2407.21783; unverified].  Port of
``repro/configs/llama3_405b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3_405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    # 405B execution profile: bf16 params + bf16 opt state + FSDP is the
    # only way this fits a 16 GiB/chip pod slice (EXPERIMENTS.md §Dry-run).
    fsdp=True,
    param_dtype="bfloat16",
    opt_state_dtype="bfloat16",
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab_size=512, fsdp=False, param_dtype="float32",
        dtype="float32", attn_chunk=0)
