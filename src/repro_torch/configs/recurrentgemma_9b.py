"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1)
d_ff=12288 vocab=256000.  RG-LRU + local attention, 2:1 pattern,
window=2048 [arXiv:2402.19427; unverified].  Port of
``repro/configs/recurrentgemma_9b.py``: the same numbers.

Sub-quadratic (RG-LRU state + windowed KV ring) ⇒ long_500k cell runs.
38 = 12×(rglru,rglru,local) + 2 remainder layers — the stacked groups
and the unstacked tail of the layer plan."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=4096,
    conv_width=4,
    rope_theta=10000.0,
    attn_chunk=1024,
    rnn_chunk=512,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=384, window=16, rnn_width=64, rnn_chunk=16,
        dtype="float32", param_dtype="float32", attn_chunk=0)
