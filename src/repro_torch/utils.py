"""Small shared utilities of the PyTorch port: padding, shape buckets,
device resolution, and the error raised for features outside this slice."""
from __future__ import annotations

import numpy as np
import torch

INT32_SENTINEL = int(np.int32(2**31 - 1))  # padding value for sorted id arrays


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pow2_bucket(n: int, block: int) -> int:
    """Smallest pow2 multiple of ``block`` that holds ``n`` rows — the
    shape bucket for engine-cache keys (query-id vectors and foreign
    query arrays must round identically, or the zero-compile steady
    state silently breaks)."""
    n = max(int(n), 1)
    target = block
    while target < n:
        target *= 2
    return round_up(target, block)


def pad_to(x: torch.Tensor, size: int, axis: int = 0, value=0) -> torch.Tensor:
    """Pad ``x`` along ``axis`` up to ``size`` with ``value``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis of size {cur} down to {size}")
    shape = list(x.shape)
    shape[axis] = size - cur
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default of every
    entry point; asking for it without a usable card raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def unported(feature: str, item: str) -> NotImplementedError:
    """The error for a feature the JAX package has and this port does not
    yet: names the ROADMAP queue item that will bring it."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md {item})"
    )
