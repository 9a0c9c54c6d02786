"""Model configurations of the port (``repro/configs``): the dataclasses
and, so far, the ``olmo_1b`` preset the kNN-LM serves."""
from repro_torch.configs.base import (
    ARCH_IDS, PORTED_ARCHS, SHAPES, ModelConfig, MoEConfig, RetrievalConfig, ShapeConfig,
    applicable_shapes, get_config, get_smoke_config, sub_quadratic, torch_dtype,
)

__all__ = [
    "ARCH_IDS", "PORTED_ARCHS", "SHAPES", "ModelConfig", "MoEConfig", "RetrievalConfig",
    "ShapeConfig", "applicable_shapes", "get_config", "get_smoke_config", "sub_quadratic",
    "torch_dtype",
]
