"""Plain PyTorch version of the sampled distance-bin histogram."""
from __future__ import annotations

import torch

# Elements of the (S, chunk, D) difference tensor per chunk of points: bounds
# its memory whatever the corpus size and the width.
_DIFF_ELEMS = 1 << 28


def distance_bin_histogram_ref(queries, points, query_ids, point_ids,
                               bin_width, *, n_bins: int):
    """(n_bins,) f32 counts of pair distances d = √Σ(q − p)² with
    ⌊d / bin_width⌋ < n_bins; pairs with an id < 0 or equal ids are
    excluded.  Counts are summed in int64, then converted."""
    q = queries.float()
    qid = query_ids.to(torch.int32)
    counts = torch.zeros((n_bins + 1,), dtype=torch.int64, device=q.device)
    chunk = max(1, _DIFF_ELEMS // max(1, q.shape[0] * q.shape[1]))
    for p0 in range(0, points.shape[0], chunk):
        p = points[p0:p0 + chunk].float()
        pid = point_ids[p0:p0 + chunk].to(torch.int32)
        diff = q[:, None, :] - p[None, :, :]
        d = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
        valid = (pid[None, :] >= 0) & (qid[:, None] >= 0) & (qid[:, None] != pid[None, :])
        bins = torch.floor(d / bin_width)
        in_range = valid & (bins >= 0) & (bins < n_bins)
        bins = torch.where(in_range, bins, torch.full_like(bins, n_bins)).long()
        counts += torch.bincount(bins.reshape(-1), minlength=n_bins + 1)
    return counts[:n_bins].to(torch.float32)
