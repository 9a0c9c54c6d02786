"""Plain PyTorch versions of the pairwise distance kernel.

``pairwise_sq_l2_ref`` is the difference form (the stable one) and
``pairwise_neg_ip_ref`` the negated inner product.  ``pairwise_sq_l2_matmul_ref``
repeats the kernel's arithmetic: ``|q|² + |c|² − 2q·c`` accumulated chunk by
chunk over ``block_d`` dims, with the tile-level SHORTC rule — before each
chunk after the first, a (block_q × block_c) tile whose smallest partial
sum exceeds ε² stops accumulating.  It is what the CUDA kernel is held
against, and what ``ops`` runs for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.utils import cdiv


def pairwise_sq_l2_ref(queries, candidates):
    """(Q, D) × (C, D) -> (Q, C) f32 squared L2, difference-then-square."""
    diff = queries.float()[:, None, :] - candidates.float()[None, :, :]
    return (diff * diff).sum(-1)


def pairwise_neg_ip_ref(queries, candidates):
    """(Q, D) × (C, D) -> (Q, C) f32 negated inner product −q·c."""
    return -(queries.float() @ candidates.float().T)


def pairwise_sq_l2_matmul_ref(queries, candidates, *, block_q: int = 128,
                              block_c: int = 128, block_d: int = 128,
                              shortc_eps2=None, metric: str = "l2",
                              chunks_out=None):
    """The kernel's arithmetic on (T, Q, D) × (T, C, D) -> (T, Q, C) f32
    (or 2-D operands without the batch axis); Q % block_q == 0 and
    C % block_c == 0.  ``chunks_out`` (T, Q/block_q, C/block_c) i32, if
    given, receives the chunks each tile accumulated."""
    q, c = queries.float(), candidates.float()
    flat = q.dim() == 2
    if flat:
        q, c = q[None], c[None]
    t, nq, dim = q.shape
    nc = c.shape[1]
    assert nq % block_q == 0 and nc % block_c == 0, (nq, nc, block_q, block_c)
    shape = (t, nq // block_q, block_q, nc // block_c, block_c)
    out = torch.zeros((t, nq, nc), dtype=torch.float32, device=q.device)
    done = torch.zeros((t, nq // block_q, nc // block_c), dtype=torch.int32,
                       device=q.device)
    for ch in range(cdiv(dim, block_d)):
        qd = q[..., ch * block_d:(ch + 1) * block_d]
        cd = c[..., ch * block_d:(ch + 1) * block_d]
        qc = torch.bmm(qd, cd.transpose(1, 2))
        if metric == "ip":
            part = -qc
        else:
            part = ((qd * qd).sum(-1)[:, :, None] + (cd * cd).sum(-1)[:, None, :]) - 2.0 * qc
        if shortc_eps2 is not None and ch > 0:
            alive = out.reshape(shape).amin(dim=(2, 4)) <= shortc_eps2
            part = torch.where(alive[:, :, None, :, None], part.reshape(shape),
                               torch.zeros((), device=q.device)).reshape(out.shape)
            done += alive.to(torch.int32)
        else:
            done += 1
        out += part
    if chunks_out is not None:
        chunks_out.copy_(done[0] if flat and chunks_out.dim() == 2 else done)
    return out[0] if flat else out
