"""Model configurations of the port (``repro/configs``): the dataclasses,
the dense presets (``olmo_1b``, ``qwen3_14b``, ``yi_9b``,
``llama3_405b``), the recurrent ones (``rwkv6_3b``,
``recurrentgemma_9b``), the MoE ones (``granite_moe_1b_a400m``,
``qwen3_moe_235b_a22b``), the encoder-decoder ``whisper_large_v3`` and the
VLM ``llava_next_mistral_7b``."""
from repro_torch.configs.base import (
    ARCH_IDS, PORTED_ARCHS, SHAPES, ModelConfig, MoEConfig, RetrievalConfig, ShapeConfig,
    applicable_shapes, get_config, get_smoke_config, registry, sub_quadratic, torch_dtype,
)

__all__ = [
    "ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "RetrievalConfig",
    "ShapeConfig", "applicable_shapes", "get_config", "get_smoke_config", "registry",
    "sub_quadratic", "torch_dtype",
]
