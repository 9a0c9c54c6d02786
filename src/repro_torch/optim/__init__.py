"""Optimizer substrate of the port (``repro/optim``): AdamW with
dtype-configurable moments, the warmup-cosine schedule, int8
error-feedback gradient compression."""
from repro_torch.optim.adamw import (
    OptConfig, adamw_update, clip_by_global_norm, global_norm,
    init_opt_state, warmup_cosine,
)
from repro_torch.optim.compression import (
    compressed_grad_mean, compression_ratio, dequantize, ef_quantize,
    init_residuals, quantize,
)

__all__ = [
    "OptConfig", "adamw_update", "clip_by_global_norm", "global_norm",
    "init_opt_state", "warmup_cosine", "compressed_grad_mean",
    "compression_ratio", "dequantize", "ef_quantize", "init_residuals",
    "quantize",
]
