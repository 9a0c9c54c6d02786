"""Model code of the port (``repro/models``): the dense decoder
(``transformer``: serving, and the differentiable loss the trainer takes)
and the kNN-LM head (``knn_lm``) that attaches the
paper's join to the serving path."""
from repro_torch.models.transformer import (
    Transformer, cache_from_jax, decode_step, decode_step_hidden, forward_seq, init_cache,
    init_params, layer_plan, loss_fn, opt_state_from_jax, params_from_jax, prefill,
    prefill_hidden,
)
from repro_torch.models.knn_lm import (
    Datastore, IndexRetriever, build_datastore, collect_pairs, decode_step_retrieval,
    interpolate_retrieval, knn_probs, lookup, sharded_lookup,
)

__all__ = [
    "decode_step", "decode_step_hidden", "forward_seq", "init_cache",
    "init_params", "layer_plan", "loss_fn", "prefill", "prefill_hidden",
    "Datastore", "IndexRetriever", "build_datastore", "collect_pairs",
    "decode_step_retrieval", "interpolate_retrieval", "knn_probs",
    "lookup", "sharded_lookup",
    "Transformer", "cache_from_jax", "opt_state_from_jax", "params_from_jax",
]
