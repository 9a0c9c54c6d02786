"""kNN-LM retrieval head — port of ``repro/models/knn_lm.py``: the paper's
join as a first-class LM feature.

At serve time the decoder's final hidden state queries a datastore of
(hidden, next-token) pairs; the output distribution is

    p(w) = λ · p_kNN(w)  +  (1 − λ) · p_LM(w),
    p_kNN(w) ∝ Σ_{i : v_i = w} exp(−d_i² / T)          (Khandelwal et al.)

The lookups run on the port's engines:

  * a ``Datastore`` (keys on the model's device, REORDERed, optionally
    truncated) -> ``lookup``: ``core.brute.brute_knn`` in l2, on the card
    one ``knn_tile_topk`` launch over the whole datastore;
  * a datastore sharded over a mesh axis -> ``sharded_lookup``: the ring
    over the axis's slots, each step a ``knn_topk`` call on one shard
    folded into the running top-K (tensor code on slot 0's device, as
    ``core/distributed.py``'s ring is);
  * the served datastore -> ``IndexRetriever``: a ``KNNIndex`` /
    ``ShardedKNNIndex`` with ``metric="ip"`` (the brute lane's
    ``knn_tile_topk[ip]``), optionally behind ``KNNServer``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import brute as brute_lib
from repro_torch.core import grid as grid_lib
from repro_torch.core.distributed import shard_devices
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer


@dataclasses.dataclass
class Datastore:
    keys: torch.Tensor      # (N, d_key) float32, reordered space
    values: torch.Tensor    # (N,) int32 next-token ids
    order: torch.Tensor     # (d,) variance reorder permutation (§IV-D)

    @property
    def size(self) -> int:
        return self.keys.shape[0]


@torch.no_grad()
def collect_pairs(model, cfg: ModelConfig,
                  token_batches: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Run the LM over token batches; return the raw (hidden_t ->
    token_{t+1}) pairs as ``(keys (N, d) f32, values (N,) i32)`` — the
    shared front half of every datastore flavor."""
    keys, vals = [], []
    for tokens in token_batches:
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor)
                                 else tokens)
        hidden, _, _ = transformer.forward_seq(model, cfg, tokens)
        keys.append(hidden[:, :-1].float().reshape(-1, hidden.shape[-1]).cpu().numpy())
        vals.append(tokens[:, 1:].reshape(-1).cpu().numpy())
    return np.concatenate(keys), np.concatenate(vals).astype(np.int32)


def build_datastore(model, cfg: ModelConfig, token_batches: Sequence, *,
                    m_dims: Optional[int] = None) -> Datastore:
    """Collect (hidden_t -> token_{t+1}) pairs into a datastore on the
    model's device: keys REORDERed by variance (§IV-D) and, with
    ``m_dims``, truncated to the top-variance dims (§IV-C)."""
    raw_keys, raw_vals = collect_pairs(model, cfg, token_batches)
    dev = model.device
    reordered, order = grid_lib.reorder_by_variance(torch.as_tensor(raw_keys, device=dev))
    if m_dims is not None:
        reordered = reordered[:, :m_dims]
    return Datastore(keys=reordered.contiguous(), values=torch.as_tensor(raw_vals, device=dev),
                     order=order)


def _project(ds: Datastore, queries: torch.Tensor) -> torch.Tensor:
    """Apply the datastore's REORDER permutation (+ truncation) to queries."""
    q = queries.float()[:, ds.order]
    return q[:, : ds.keys.shape[1]].contiguous()


@torch.no_grad()
def lookup(ds: Datastore, queries: torch.Tensor, *, k: int,
           corpus_chunk: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """Datastore lookup: (d² (B,k), values (B,k)); a value is −1 where
    fewer than k keys exist.  Query ids start at N, so no key is
    excluded."""
    q = _project(ds, torch.as_tensor(queries, device=ds.keys.device))
    qids = ds.size + torch.arange(q.shape[0], dtype=torch.int32, device=q.device)
    d2, ids = brute_lib.brute_knn(ds.keys, q, qids, k=k, corpus_chunk=corpus_chunk)
    vals = ds.values[ids.long().clamp(0, ds.size - 1)]
    return d2, torch.where(ids >= 0, vals, torch.full_like(vals, -1))


def sharded_lookup(mesh, axis: str, *, k: int):
    """Ring lookup for a datastore sharded over ``axis``: returns
    ``fn(queries, keys, values) -> (d² (B,k), values (B,k))``.

    The keys and values are cut into ``mesh.shape[axis]`` equal shards,
    one on each slot of the axis; the queries stay on slot 0, and each of
    ``mesh.shape[axis]`` ring steps brings the next shard to them —
    0, n−1, …, 1, the order in which the reference's ``ppermute`` ring
    delivers them to device 0 — runs ``knn_topk`` on it, gathers its values
    and folds them into the running top-K (exact global top-K)."""
    n_shards = mesh.shape[axis]
    devs = shard_devices(mesh, (axis,))

    @torch.no_grad()
    def fn(queries, keys, values):
        dev = devs[0]
        q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
        keys = torch.as_tensor(keys, dtype=torch.float32)
        values = torch.as_tensor(values, dtype=torch.int32)
        n = keys.shape[0]
        if n % n_shards:
            raise ValueError(f"{n} datastore keys do not split into {n_shards} equal shards")
        shard_n = n // n_shards
        shards = [(keys[s * shard_n:(s + 1) * shard_n].to(devs[s]),
                   values[s * shard_n:(s + 1) * shard_n].to(devs[s])) for s in range(n_shards)]
        run_d = torch.full((q.shape[0], k), float("inf"), device=dev)
        run_v = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=dev)
        qids = shard_n * n_shards + torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        cids = torch.arange(shard_n, dtype=torch.int32, device=dev)
        for step in range(n_shards):
            ks, vs = (x.to(dev) for x in shards[-step % n_shards])
            nd, ni = topk_ops.knn_topk(q, ks, qids, cids, k=k)
            nv = vs[ni.long().clamp(0, shard_n - 1)]
            nv = torch.where(ni >= 0, nv, torch.full_like(nv, -1))
            run_d, run_v = topk_ops.merge_running_topk(run_d, run_v, nd, nv, k=k)
        return run_d, run_v

    return fn


def knn_probs(d2: torch.Tensor, vals: torch.Tensor, vocab: int,
              temperature: float) -> torch.Tensor:
    """Scatter softmax(−d²/T) over the valid neighbours onto the
    vocabulary, repeated values adding.  (B,k) -> (B,V); a row with no
    valid neighbour is all zeros."""
    valid = vals >= 0
    w = torch.softmax(torch.where(valid, -d2.float() / temperature,
                                  torch.full_like(d2, float("-inf"), dtype=torch.float32)),
                      dim=-1)
    w = torch.where(valid, w, torch.zeros_like(w))          # NaN rows -> 0
    out = torch.zeros((vals.shape[0], vocab), dtype=torch.float32, device=vals.device)
    return out.scatter_add_(1, vals.long().clamp(0, vocab - 1), w)


class IndexRetriever:
    """kNN-LM lookup served by the index stack (DESIGN.md §9.5): the
    datastore keys live in a ``KNNIndex`` / ``ShardedKNNIndex`` built with
    ``metric="ip"`` (maximum-inner-product retrieval, the unembed's own
    geometry), and hidden-state queries enter through ``KNNServer``'s
    admission and micro-batching when one is attached.

    The served datastore is mutable (``insert``), persistent and
    shardable; the lookup runs host-side between decode steps, so it pairs
    with ``generate``'s interpolation rather than
    ``decode_step_retrieval``."""

    def __init__(self, index, values: np.ndarray, *, server=None):
        self.index = index
        self.values = np.asarray(values, np.int32)
        self.server = server

    @classmethod
    def build(cls, model, cfg: ModelConfig, token_batches: Sequence, *, mesh=None,
              hybrid_config=None, server_config=None):
        """Collect (hidden, next-token) pairs and index the keys with
        ``metric="ip"``: sharded over ``mesh``'s slots when one is given,
        else on the model's device.  ``server_config`` wraps the index in a
        ``KNNServer``."""
        from repro_torch.core.hybrid import HybridConfig
        from repro_torch.runtime.knn_index import KNNIndex
        from repro_torch.runtime.server import KNNServer

        keys, vals = collect_pairs(model, cfg, token_batches)
        rc = cfg.retrieval
        hcfg = hybrid_config or HybridConfig(k=rc.k, metric="ip")
        if hcfg.metric != "ip":
            raise ValueError(
                f"IndexRetriever scores candidates by inner product (the unembed's own "
                f"geometry); got metric={hcfg.metric!r} — pass a HybridConfig with "
                f"metric='ip'")
        index = KNNIndex.build(keys, hcfg, mesh=mesh, device=model.device)
        server = KNNServer(index, server_config) if server_config is not None else None
        return cls(index, vals, server=server)

    @property
    def size(self) -> int:
        return self.index.n_points

    def insert(self, model, cfg: ModelConfig, token_batches: Sequence):
        """Stream new text into the served datastore (delta-buffer insert —
        no rebuild until compaction)."""
        keys, vals = collect_pairs(model, cfg, token_batches)
        self.index.insert(keys)
        self.values = np.concatenate([self.values, vals])

    def lookup(self, queries, *, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, d) hidden states -> (scores (B, k), values (B, k)), numpy.

        Scores are the index's ip distances (−q·c), so ``knn_probs``'s
        exp(−d/T) weighting becomes exp(q·c/T).  Through the server each
        row is one admitted request, re-coalesced by the micro-batcher, so
        the answers equal a direct whole-batch query; a shed request
        raises, as a decode step cannot proceed on partial retrieval."""
        q = np.asarray(queries, np.float32)
        if self.server is not None:
            tickets = [self.server.submit(row, k=k) for row in q]
            self.server.drain()
            bad = [t for t in tickets if not hasattr(t.outcome, "ids")]
            if bad:
                raise RuntimeError(
                    f"{len(bad)} of {len(tickets)} retrieval requests were shed "
                    f"({bad[0].outcome!r}) — a decode step cannot proceed on partial "
                    f"retrieval; raise the server deadline or queue bound")
            d = np.stack([t.outcome.dists for t in tickets])
            ids = np.stack([t.outcome.ids for t in tickets])
        else:
            res = self.index.query(q, k=k)
            d, ids = np.asarray(res.dists), np.asarray(res.ids)
        vals = np.where(ids >= 0, self.values[np.clip(ids, 0, len(self.values) - 1)], -1)
        return d, vals


def interpolate_retrieval(cfg: ModelConfig, logits: torch.Tensor, d, vals) -> torch.Tensor:
    """log(λ·p_kNN + (1−λ)·p_LM) from already-retrieved (scores, values),
    numpy or tensors — the back half of ``decode_step_retrieval`` for
    index-backed lookups that run between decode steps."""
    rc = cfg.retrieval
    p_lm = torch.softmax(logits.float(), dim=-1)
    p_knn = knn_probs(torch.as_tensor(d, device=logits.device),
                      torch.as_tensor(vals, device=logits.device), cfg.vocab_size,
                      rc.temperature)
    p = rc.lam * p_knn + (1.0 - rc.lam) * p_lm
    return torch.log(torch.clamp(p, min=1e-20))


@torch.no_grad()
def decode_step_retrieval(model, cfg: ModelConfig, token, cache, pos, ds: Datastore,
                          shd=None):
    """``transformer.decode_step`` + kNN interpolation (the serving hot
    path): the final-norm hidden state is both the unembed input (p_LM)
    and the retrieval query (p_kNN).  Returns (log p (B, V), cache)."""
    hidden, cache = transformer.decode_step_hidden(model, cfg, token, cache, pos, shd)
    logits = L.unembed(model.embed, cfg, hidden[:, None])[:, 0]
    d2, vals = lookup(ds, hidden, k=cfg.retrieval.k)
    return interpolate_retrieval(cfg, logits, d2, vals), cache
