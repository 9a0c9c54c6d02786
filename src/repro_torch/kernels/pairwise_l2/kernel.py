"""Wrapper of the CUDA pairwise distance kernel (``csrc/pairwise_l2.cu``),
the port of ``repro/kernels/pairwise_l2/kernel.py::pairwise_sq_l2`` and
``::pairwise_sq_l2_dyn_shortc``.

One launch scores a whole batch of (query tile, candidate block) pairs:
the cell-tiled dense engine passes a chunk of tiles at once.  Each thread
block owns one ``TILE`` × ``TILE`` output tile (the register-tiled score
tile of ``csrc/score_tile.cuh``), so ``block_q`` and ``block_c`` — the
SHORTC tile — must be ``TILE``.  ε² is always a device operand (a float is
written to a one-element tensor on the card, a tensor is used where it
lies), so the static and the runtime SHORTC forms are one kernel and
nothing waits on the host.  ``launches`` counts the launches per variant
(``pairwise_sq_l2``, ``pairwise_sq_l2[ip]``)."""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

TILE = 128                    # output tile rows and columns (score_tile.cuh TQ, TC)

launches: collections.Counter = collections.Counter()

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def variant(metric: str) -> str:
    return "pairwise_sq_l2[ip]" if metric == "ip" else "pairwise_sq_l2"


def pairwise_sq_l2(queries, candidates, shortc_eps2=None, *, block_q: int = 128,
                   block_c: int = 128, block_d: int = 128, metric: str = "l2",
                   chunks_out=None):
    """(T, Q, D) × (T, C, D) f32 -> (T, Q, C) f32 distance tiles, Q % block_q
    == 0 and C % block_c == 0 (any D: the last chunk is ragged).  Squared L2
    in the expansion form per ``block_d`` chunk, unclamped, or −q·c under
    ``metric="ip"``.  ``shortc_eps2`` (None, a float or a () tensor; l2 only)
    turns on the tile-level SHORTC; ``chunks_out`` (T, Q/block_q,
    C/block_c) i32 receives the chunks each tile accumulated."""
    req = _build.require
    dev = queries.device
    req(dev.type == "cuda", "pairwise_l2 kernel needs CUDA tensors")
    req(metric in ("l2", "ip"), f"metric must be 'l2' or 'ip', got {metric!r}")
    req(metric == "l2" or shortc_eps2 is None,
        "pairwise_l2: SHORTC needs monotone partial sums (l2 only)")
    for name, t in (("queries", queries), ("candidates", candidates)):
        req(t.device == dev and t.dtype == torch.float32 and t.is_contiguous()
            and t.dim() == 3,
            f"pairwise_l2: {name} must be a contiguous (T, rows, D) float32 tensor on {dev}")
    batch, n_q, dim = queries.shape
    n_c = candidates.shape[1]
    req(candidates.shape[0] == batch and candidates.shape[2] == dim,
        f"pairwise_l2: candidates {tuple(candidates.shape)} do not match "
        f"queries {tuple(queries.shape)}")
    req(block_q == TILE and block_c == TILE,
        f"pairwise_l2: block_q={block_q}, block_c={block_c} must both be {TILE} "
        f"(the kernel's output tile)")
    req(block_d >= 1, f"block_d must be >= 1, got {block_d}")
    req(n_q % block_q == 0 and n_c % block_c == 0,
        f"pairwise_l2: rows ({n_q}, {n_c}) must be multiples of ({block_q}, {block_c})")
    n_tiles = batch * (n_q // block_q) * (n_c // block_c)
    req(n_tiles < 2**31, f"pairwise_l2: {n_tiles} tiles exceed one launch")
    if chunks_out is not None:
        req(chunks_out.device == dev and chunks_out.dtype == torch.int32
            and chunks_out.is_contiguous() and chunks_out.numel() == n_tiles,
            "pairwise_l2: chunks_out must be a contiguous int32 tensor with one "
            "entry per tile")
    shortc = shortc_eps2 is not None
    if isinstance(shortc_eps2, torch.Tensor):
        eps = shortc_eps2.to(device=dev, dtype=torch.float32).reshape(1)
    else:
        eps = torch.full((1,), float(shortc_eps2) if shortc else 0.0,
                         dtype=torch.float32, device=dev)
    out = torch.empty((batch, n_q, n_c), dtype=torch.float32, device=dev)
    fn = _build.function("pairwise_l2", "pairwise_l2_launch", _ARGTYPES)
    p = _build.ptr
    err = fn(p(queries), p(candidates), p(eps), p(out),
             ctypes.c_void_p(chunks_out.data_ptr() if chunks_out is not None else None),
             batch, n_q, n_c, dim, block_d, int(shortc),
             int(metric == "ip"), _build.stream())
    _build.check(err, "pairwise_l2_launch")
    launches[variant(metric)] += 1
    return out
