"""Serving driver: batched prefill + decode, optional kNN-LM retrieval —
port of ``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo_1b --smoke \
        --batch 4 --prompt-len 32 --gen 16 --retrieval --device cpu

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import knn_lm, transformer
from repro_torch.models import layers as L
from repro_torch.sharding import ShardingCtx
from repro_torch.utils import resolve_device


@torch.no_grad()
def generate(model, cfg, prompts, gen_len: int, *, ds=None, shd=None,
             temperature: float = 0.0, seed: int = 0) -> torch.Tensor:
    """Greedy (or sampled) generation: returns (B, gen_len) tokens.

    ``ds`` attaches the kNN-LM head: a ``Datastore`` runs the lookup inside
    each decode step (``decode_step_retrieval``); an ``IndexRetriever``
    (index-backed, optionally behind a ``KNNServer``) runs it host-side
    between steps on the step's hidden states.  Retrieval applies to the
    first generated token too, from the prompt's last hidden state.
    Greedy ties take the first maximum (``torch.argmax``, as
    ``jnp.argmax``); sampling draws from a ``torch.Generator`` seeded with
    ``seed`` on the model's device (not ``jax.random``'s numbers)."""
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts) if not isinstance(prompts, torch.Tensor)
                              else prompts, device=dev).long()
    b, p_len = prompts.shape
    cache_len = p_len + gen_len
    k = cfg.retrieval.k
    retriever = ds if isinstance(ds, knn_lm.IndexRetriever) else None

    def retrieve(hidden):
        if retriever is not None:
            return retriever.lookup(hidden.float().cpu().numpy(), k=k)
        return knn_lm.lookup(ds, hidden, k=k)

    if ds is None:
        logits, cache = transformer.prefill(model, cfg, prompts, cache_len, shd)
    else:
        logits, h_last, cache = transformer.prefill_hidden(model, cfg, prompts, cache_len, shd)
        logits = knn_lm.interpolate_retrieval(cfg, logits, *retrieve(h_last))

    def step(tok, pos):
        if ds is None:
            return transformer.decode_step(model, cfg, tok, cache, pos, shd)[0]
        if retriever is None:
            return knn_lm.decode_step_retrieval(model, cfg, tok, cache, pos, ds, shd)[0]
        hidden, _ = transformer.decode_step_hidden(model, cfg, tok, cache, pos, shd)
        lg = L.unembed(model.embed, cfg, hidden[:, None])[:, 0]
        return knn_lm.interpolate_retrieval(cfg, lg, *retrieve(hidden))

    gen = None
    if temperature > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    out = []
    for t in range(gen_len):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        logits = step(tok, p_len + t)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true",
                    help="serve with the kNN-LM head (the paper's join in the serving path)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_host_mesh(model=args.model_axis, device=dev)
    shd = ShardingCtx.for_mesh(mesh, seq_shard=False)
    model = transformer.init_params(0, cfg, device=dev)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))

    ds = None
    if args.retrieval:
        corpus = rng.integers(0, cfg.vocab_size, (4, 64))
        ds = knn_lm.build_datastore(model, cfg, [corpus])
        print(f"[serve] datastore: {ds.size} keys × {ds.keys.shape[1]} dims")

    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, cfg, prompts, args.gen, ds=ds, shd=shd)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    print(f"[serve] generated {total} tokens in {dt:.2f}s on {dev} ({total / dt:.1f} tok/s)")
    print(f"[serve] sample: {toks[0].cpu().numpy()[:12]}")
    return toks


if __name__ == "__main__":
    main()
