"""Dispatch for the pairwise distance kernel: the plain version
(``ref.pairwise_sq_l2_matmul_ref``, the kernel's chunked arithmetic and
SHORTC rule) for a CPU tensor, the CUDA kernel for a CUDA tensor.

``shortc_eps2`` may be a float or a 0-d tensor; both reach the same kernel,
which reads ε² from device memory.  SHORTC is l2 only: partial ip sums are
not monotone, so ``metric="ip"`` with ``shortc_eps2`` raises."""
from __future__ import annotations


from repro_torch.kernels.pairwise_l2 import kernel as _kernel
from repro_torch.kernels.pairwise_l2 import ref as _ref
from repro_torch.utils import pad_to, round_up


def _check_metric(metric: str, shortc_eps2) -> None:
    if metric not in ("l2", "ip"):
        raise ValueError(f"metric must be 'l2' or 'ip', got {metric!r}")
    if metric == "ip" and shortc_eps2 is not None:
        raise ValueError(
            "pairwise_sq_l2(metric='ip') cannot take shortc_eps2: the SHORTC "
            "cutoff assumes monotone partial distances (l2 only) — pass "
            "shortc_eps2=None")


def pairwise_sq_l2_batched(queries, candidates, *, block_q: int = 128,
                           block_c: int = 128, block_d: int = 128,
                           shortc_eps2=None, metric: str = "l2"):
    """(T, TQ, D) × (T, TC, D) -> (T, TQ, TC) f32 distance tiles, one kernel
    launch for all T; TQ % block_q == 0 and TC % block_c == 0."""
    _check_metric(metric, shortc_eps2)
    kw = dict(block_q=block_q, block_c=block_c, block_d=block_d, metric=metric)
    if not queries.is_cuda:
        return _ref.pairwise_sq_l2_matmul_ref(queries, candidates,
                                              shortc_eps2=shortc_eps2, **kw)
    return _kernel.pairwise_sq_l2(queries.float().contiguous(),
                                  candidates.float().contiguous(), shortc_eps2, **kw)


def pairwise_sq_l2(queries, candidates, *, block_q: int = 128, block_c: int = 128,
                   block_d: int = 128, shortc_eps2=None, metric: str = "l2"):
    """Squared L2 distances (Q, C) f32 for arbitrary (unpadded) shapes
    (negated inner product −q·c under ``metric="ip"``).  Rows are padded
    with zeros to the tile multiples, as the JAX ops pad them (padded rows
    take part in a tile's SHORTC minimum there too), and sliced off."""
    q_n, c_n = queries.shape[0], candidates.shape[0]
    q = pad_to(queries, round_up(max(q_n, 1), block_q))
    c = pad_to(candidates, round_up(max(c_n, 1), block_c))
    out = pairwise_sq_l2_batched(q[None], c[None], block_q=block_q, block_c=block_c,
                                 block_d=block_d, shortc_eps2=shortc_eps2,
                                 metric=metric)
    return out[0, :q_n, :c_n]
