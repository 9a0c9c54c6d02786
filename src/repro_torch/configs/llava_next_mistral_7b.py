"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000.  AnyRes tiling; the vision tower is a STUB per
the assignment — ``input_specs()`` feeds precomputed (B, n_patches,
patch_dim) CLIP features through the learned mm_projector
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].  Port of
``repro/configs/llava_next_mistral_7b.py``: the same numbers."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_mistral_7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    n_patches=2880,              # anyres: (1 base + 4 tiles) × 576 patches
    patch_dim=1024,              # CLIP-L/14 feature width
    attn_chunk=1024,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab_size=384, n_patches=12, patch_dim=32,
        dtype="float32", param_dtype="float32", attn_chunk=0)
