"""Small shared utilities of the PyTorch port: padding, shape buckets,
device resolution, nested-container helpers, byte counts and timers."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

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


def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple, dict keys in sorted order
    (``jax.tree.leaves``' order); ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(template, leaves):
    """``template``'s structure holding ``leaves``, taken in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(template)


def tensor_leaves(tree):
    """Every ``torch.Tensor`` leaf of ``tree``, descending into dicts,
    lists, tuples and dataclass fields (``GridIndex``, ``Pyramid``, a
    ``_Generation``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensor_leaves(getattr(tree, f.name))


def tree_bytes(tree) -> int:
    """Total bytes of every tensor leaf of ``tree`` (``meta`` tensors
    included: only shape and dtype count)."""
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))


def human_bytes(n: float) -> str:
    for unit in ["B", "KiB", "MiB", "GiB", "TiB"]:
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"


def _sync_tree(tree) -> None:
    """Wait for the work that produces ``tree``'s tensors: synchronise each
    CUDA device a tensor leaf lives on (the ``block_until_ready`` of the
    JAX package's timers)."""
    for dev in {t.device for t in tensor_leaves(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer; with ``device`` a CUDA device, ``__exit__`` waits
    for that device's queued work first, so the time is the work's and not
    its enqueueing's."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self._t0
        return False


def timed(fn: Callable, *args, repeats: int = 1, warmup: int = 1, **kw):
    """Run ``fn`` repeatedly, each time waiting for the devices its result
    lives on; return ``(best_seconds, result)``."""
    result = None
    for _ in range(max(warmup, 0)):
        result = fn(*args, **kw)
        _sync_tree(result)
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        _sync_tree(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
