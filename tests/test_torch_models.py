"""The port's dense decoder (``repro_torch.models.{layers,transformer}``,
``configs``, ``sharding``) held to the JAX package on the same numpy
inputs.

Weights cross with ``params_from_jax`` (a JAX ``init_params`` tree as
numpy), caches with ``cache_from_jax``, at ``olmo_1b``'s
``smoke_config()``: in float32 the unscanned layout (3 layers, dense
attention) and a scanned one (``scan_layers=True``, 4 layers stacked into
4 groups, ``attn_chunk=8`` so the flash loop runs on 20-token sequences,
ragged in both chunk axes); and the card's activation dtype, bfloat16,
with ``attn_chunk=8`` (the unscanned layout with the flash loop).  Each
JAX reference is computed once per module.

Tolerances.  float32 (sums taken in another order): 1e-5 relative (atol
1e-5) on hidden states and single layers, 1e-4 on logits and across the 8
decode steps; the port's own decode-matches-forward check uses the
reference test's (``tests/test_models.py:82-110``).  bfloat16: against
JAX, 2^-7 relative and absolute (about one bf16 ulp; the port rounds
where the reference does, so the forward and prefill agree bit for bit
here and the decode steps to ~1e-3); single layers bit for bit (the JAX
side run op by op, see ``run``); between two paths of the port that round
in different places (decode against forward, flash against dense), 2^-4
relative and absolute, sixteen bf16 unit roundoffs (the largest seen is
0.051 on hidden states up to 3.3: three ulps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch import sharding
from repro_torch.launch import make_host_mesh, make_serving_mesh
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import spmd
from repro_torch.models import transformer as T

RTOL_H, ATOL_H = 1e-5, 1e-5        # hidden states, single layers
RTOL_LOGIT, ATOL_LOGIT = 1e-4, 1e-4
TOL_BF16 = 2.0 ** -7               # against JAX, bfloat16 activations
TOL_BF16_PATHS = 2.0 ** -4         # two rounding orders of the port, bfloat16
P_LEN, S_LEN = 12, 20

VARIANTS = {
    "smoke": {},
    "scanned": dict(scan_layers=True, n_layers=4, attn_chunk=8),
    "bf16": dict(dtype="bfloat16", attn_chunk=8),
}
# (rtol, atol): hidden states and logits against JAX; then the port's
# decode-vs-forward prefill and steps, and flash-vs-dense.
_F32_TOLS = dict(h=(RTOL_H, ATOL_H), logit=(RTOL_LOGIT, ATOL_LOGIT),
                 fwd_prefill=(1e-4, 1e-4), fwd_step=(1e-4, 2e-4), flash=(RTOL_H, ATOL_H))
TOLS = {"smoke": _F32_TOLS, "scanned": _F32_TOLS,
        "bf16": dict(h=(TOL_BF16,) * 2, logit=(TOL_BF16,) * 2,
                     fwd_prefill=(TOL_BF16_PATHS,) * 2, fwd_step=(TOL_BF16_PATHS,) * 2,
                     flash=(TOL_BF16_PATHS,) * 2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tensors are tiny, and under the suite's
    parallel workers torch's thread pool only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return (dataclasses.replace(jbase.get_smoke_config("olmo_1b"), **over),
            dataclasses.replace(C.get_smoke_config("olmo_1b"), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    """A JAX array or a tensor (bf16 included) as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0], atol=tol[1])


@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """JAX and port runs of one variant: forward, prefill and 8 decode
    steps on the same tokens and weights."""
    jcfg, tcfg = _cfgs(**VARIANTS[request.param])
    params, _ = JT.init_params(jax.random.PRNGKey(1), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)

    # bf16 runs op by op: each op rounds to bf16 as jnp's dtype rules say.
    # Under jit XLA may keep f32 across a fusion (its default excess
    # precision), which the port, rounding per op, does not model.
    eager = jcfg.dtype == "bfloat16"
    jit = (lambda f: f) if eager else jax.jit
    fwd = jit(lambda p, t: JT.forward_seq(p, jcfg, t)[0])
    pre = jit(lambda p, t: JT.prefill_hidden(p, jcfg, t, S_LEN))
    dec = jit(lambda p, t, c, pos: JT.decode_step_hidden(p, jcfg, t, c, pos))
    unemb = jit(lambda p, h: JL.unembed(p["embed"], jcfg, h))
    with jax.disable_jit(eager):
        hidden = fwd(params, jnp.asarray(toks))
        logits0, h_last, cache = pre(params, jnp.asarray(toks[:, :P_LEN]))
        j = {"hidden": np.asarray(hidden), "full_logits": np.asarray(unemb(params, hidden)),
             "prefill_logits": np.asarray(logits0), "prefill_hidden": np.asarray(h_last),
             "cache": _np(cache), "decode_hidden": [], "decode_logits": []}
        for t in range(P_LEN, S_LEN):
            h, cache = dec(params, jnp.asarray(toks[:, t]), cache, jnp.int32(t))
            j["decode_hidden"].append(np.asarray(h))
            j["decode_logits"].append(np.asarray(unemb(params, h[:, None])[:, 0]))
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                toks=toks, j=j, tol=TOLS[request.param])


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_olmo_config_is_the_reference_config():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jbase, get)("olmo_1b"))
        assert dataclasses.asdict(getattr(C, get)("olmo_1b")) == want, get
    full = C.get_config("olmo_1b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.d_ff,
            full.vocab_size, full.attn_chunk) == (16, 2048, 16, 16, 8192, 50304, 1024)
    assert full.activation_dtype() == torch.bfloat16
    assert C.get_smoke_config("olmo-1b").activation_dtype() == torch.float32
    assert C.SHAPES == {k: C.ShapeConfig(**dataclasses.asdict(v))
                        for k, v in jbase.SHAPES.items()}
    assert C.ARCH_IDS == jbase.ARCH_IDS


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_param_counts_match_reference(arch):
    """The copied analytic counts on every preset's numbers (the presets
    themselves are not ported yet; their fields go through the port's
    dataclasses)."""
    jcfg = jbase.get_config(arch)
    fields = dataclasses.asdict(jcfg)
    if fields["moe"] is not None:
        fields["moe"] = C.MoEConfig(**fields["moe"])
    fields["retrieval"] = C.RetrievalConfig(**fields["retrieval"])
    tcfg = C.ModelConfig(**fields)
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()
    assert C.sub_quadratic(tcfg) == jbase.sub_quadratic(jcfg)
    assert C.applicable_shapes(tcfg) == jbase.applicable_shapes(jcfg)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nonparam", "layernorm", "rmsnorm"])
def test_norm_matches_jax(kind):
    over = {"nonparam": {}, "layernorm": dict(nonparam_norm=False, use_layernorm=True),
            "rmsnorm": dict(nonparam_norm=False)}[kind]
    jcfg, tcfg = _cfgs(**over)
    r = np.random.default_rng(2)
    x = (3.0 * r.normal(size=(2, 5, jcfg.d_model)) + 0.5).astype(np.float32)
    p = {}
    if kind != "nonparam":
        p["scale"] = r.normal(size=jcfg.d_model).astype(np.float32)
    if kind == "layernorm":
        p["bias"] = r.normal(size=jcfg.d_model).astype(np.float32)
    want = np.asarray(JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                                    jnp.asarray(x)))
    got = L.apply_norm({k: torch.as_tensor(v) for k, v in p.items()}, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_H, atol=ATOL_H)
    assert set(L.init_norm(tcfg, torch.float32, device="cpu")) == set(p)
    s = r.normal(size=8).astype(np.float32)
    xh = r.normal(size=(2, 3, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_head_norm(torch.as_tensor(xh), torch.as_tensor(s)).numpy(),
        np.asarray(JL.rms_head_norm(jnp.asarray(xh), jnp.asarray(s))), rtol=RTOL_H, atol=ATOL_H)


def test_rope_matches_jax():
    r = np.random.default_rng(3)
    pos = np.arange(40, dtype=np.int32)[None, :] + 1000
    x = r.normal(size=(1, 40, 4, 24)).astype(np.float32)
    jc, js = JL.rope_angles(jnp.asarray(pos), 24, 10000.0)
    tc, ts = L.rope_angles(torch.as_tensor(pos), 24, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=2e-6)
    np.testing.assert_allclose(L.apply_rope(torch.as_tensor(x), tc, ts).numpy(),
                               np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)),
                               rtol=RTOL_H, atol=ATOL_H)


def _qkv_data(jcfg, b=2, s=19, seed=4):
    r = np.random.default_rng(seed)
    q = r.normal(size=(b, s, jcfg.n_heads, jcfg.hd)).astype(np.float32)
    k = r.normal(size=(b, s, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32)
    v = r.normal(size=(b, s, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kind", ["attn", "local"])
def test_gqa_attend_matches_jax(kind):
    jcfg, tcfg = _cfgs(n_kv_heads=2, window=5)          # GQA: 2 query heads a group
    q, k, v = _qkv_data(jcfg)
    sq = np.arange(q.shape[1])
    mask = sq[:, None] >= sq[None, :]
    if kind == "local":
        mask &= sq[:, None] - sq[None, :] < jcfg.window
    want = np.asarray(JL._gqa_attend(jcfg, *map(jnp.asarray, (q, k, v)), jnp.asarray(mask)))
    got = L._gqa_attend(tcfg, *map(torch.as_tensor, (q, k, v)), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_H, atol=ATOL_H)
    np.testing.assert_array_equal(L._self_mask(tcfg, kind, q.shape[1], "cpu").numpy(), mask)


@pytest.mark.parametrize("kind,causal_skip", [("attn", False), ("attn", True),
                                              ("local", False), ("local", True)])
def test_flash_attend_matches_jax(kind, causal_skip):
    """Ragged chunks in both axes (19 rows in chunks of 8 and 6)."""
    jcfg, tcfg = _cfgs(n_kv_heads=2, window=7)
    q, k, v = _qkv_data(jcfg)
    kw = dict(kind=kind, q_chunk=8, kv_chunk=6, causal_skip=causal_skip)
    want = np.asarray(JL._flash_attend(jcfg, *map(jnp.asarray, (q, k, v)), **kw))
    got = L._flash_attend(tcfg, *map(torch.as_tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_H, atol=ATOL_H)
    dense = L._gqa_attend(tcfg, *map(torch.as_tensor, (q, k, v)),
                          L._self_mask(tcfg, kind, q.shape[1], "cpu"))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=RTOL_H, atol=ATOL_H)


@pytest.mark.parametrize("gelu", [False, True])
def test_mlp_matches_jax(gelu):
    jcfg, tcfg = _cfgs(gelu_mlp=gelu)
    p, _ = JL.init_mlp(jax.random.PRNGKey(5), jcfg, jnp.float32)
    x = np.random.default_rng(5).normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    want = np.asarray(JL.apply_mlp(p, jcfg, jnp.asarray(x)))
    got = L.apply_mlp({k: torch.as_tensor(np.array(v)) for k, v in p.items()}, tcfg,
                      torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_H, atol=ATOL_H)
    assert set(L.init_mlp(torch.Generator().manual_seed(0), tcfg, torch.float32,
                          device="cpu")) == set(p)


@pytest.mark.parametrize("tied", [True, False])
def test_embed_unembed_match_jax(tied):
    jcfg, tcfg = _cfgs(tie_embeddings=tied)
    p, _ = JL.init_embeddings(jax.random.PRNGKey(6), jcfg, jnp.float32)
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    r = np.random.default_rng(6)
    toks = r.integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    x = r.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    np.testing.assert_array_equal(L.embed(tp, tcfg, torch.as_tensor(toks)).numpy(),
                                  np.asarray(JL.embed(p, jcfg, jnp.asarray(toks))))
    np.testing.assert_allclose(L.unembed(tp, tcfg, torch.as_tensor(x)).numpy(),
                               np.asarray(JL.unembed(p, jcfg, jnp.asarray(x))),
                               rtol=RTOL_LOGIT, atol=ATOL_LOGIT)
    # bf16 hidden states against float32 weights promote to float32 logits.
    assert L.unembed(tp, tcfg, torch.as_tensor(x).bfloat16()).dtype == torch.float32


BF16_LAYERS = ["gqa", "flash", "flash_local_skip", "swiglu", "gelu", "norm", "unembed"]


@pytest.mark.parametrize("layer", BF16_LAYERS)
def test_layers_bf16_match_jax(layer):
    """Single layers on bfloat16 inputs and weights (the card's activation
    dtype): bit for bit with the reference, which rounds to bf16 after
    every op (the attention logits before the f32 cast, bf16
    probabilities before the PV product, each step of jax.nn.silu).  The
    GELU and the unembed within one bf16 ulp on under 1% of the entries:
    XLA's and torch's f32 tanh, and the two f32 sums of the vocab
    product, differ in their last bits, which moves a bf16 rounding now
    and then."""
    over = dict(dtype="bfloat16", n_kv_heads=2, window=7, gelu_mlp=layer == "gelu")
    jcfg, tcfg = _cfgs(**over)
    r = np.random.default_rng(8)
    bf = lambda a: (jnp.asarray(a, jnp.bfloat16), torch.as_tensor(a).bfloat16())
    if layer in ("gqa", "flash", "flash_local_skip"):
        (jq, tq), (jk, tk), (jv, tv) = map(bf, _qkv_data(jcfg, seed=8))
        jk, tk, jq, tq = 2 * jk, 2 * tk, 2 * jq, 2 * tq
        if layer == "gqa":
            mask = np.arange(19)[:, None] >= np.arange(19)[None, :]
            want = JL._gqa_attend(jcfg, jq, jk, jv, jnp.asarray(mask))
            got = L._gqa_attend(tcfg, tq, tk, tv, torch.as_tensor(mask))
        else:
            kw = dict(kind="attn", q_chunk=8, kv_chunk=6, causal_skip=False)
            if layer == "flash_local_skip":
                kw.update(kind="local", causal_skip=True)
            want = JL._flash_attend(jcfg, jq, jk, jv, **kw)
            got = L._flash_attend(tcfg, tq, tk, tv, **kw)
    elif layer in ("swiglu", "gelu"):
        p, _ = JL.init_mlp(jax.random.PRNGKey(8), jcfg, jnp.bfloat16)
        jx, tx = bf(r.normal(size=(2, 7, jcfg.d_model)).astype(np.float32))
        want = JL.apply_mlp(p, jcfg, jx)
        got = L.apply_mlp({k: torch.as_tensor(_f32(v)).bfloat16() for k, v in p.items()},
                          tcfg, tx)
    elif layer == "norm":
        jx, tx = bf((3.0 * r.normal(size=(2, 5, jcfg.d_model)) + 0.5).astype(np.float32))
        want, got = JL.apply_norm({}, jcfg, jx), L.apply_norm({}, tcfg, tx)
    else:
        p, _ = JL.init_embeddings(jax.random.PRNGKey(8), jcfg, jnp.bfloat16)
        jx, tx = bf(r.normal(size=(2, 9, jcfg.d_model)).astype(np.float32))
        want = JL.unembed(p, jcfg, jx)
        got = L.unembed({k: torch.as_tensor(_f32(v)).bfloat16() for k, v in p.items()}, tcfg, tx)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if layer in ("gelu", "unembed"):
        _close(got, want, (TOL_BF16, TOL_BF16))
        assert (_f32(got) != _f32(want)).mean() < 0.01
    else:
        np.testing.assert_array_equal(_f32(got), _f32(want))


# --------------------------------------------------------------------------
# the transformer
# --------------------------------------------------------------------------

def test_forward_seq_matches_jax(run):
    hidden, aux, states = T.forward_seq(run["model"], run["tcfg"], run["toks"])
    assert states is None and float(aux) == 0.0
    assert hidden.dtype == run["tcfg"].activation_dtype()
    _close(hidden, run["j"]["hidden"], run["tol"]["h"])


def test_prefill_matches_jax(run):
    model, tcfg, toks, j, tol = run["model"], run["tcfg"], run["toks"], run["j"], run["tol"]
    logits, h_last, cache = T.prefill_hidden(model, tcfg, toks[:, :P_LEN], S_LEN)
    _close(logits, j["prefill_logits"], tol["logit"])
    _close(h_last, j["prefill_hidden"], tol["h"])
    want = T.cache_from_jax(j["cache"], tcfg, device="cpu")
    assert len(cache) == len(want) == tcfg.n_layers
    for got_l, want_l in zip(cache, want):
        for name in ("k", "v"):
            assert got_l["kv"][name].shape == (2, S_LEN, tcfg.n_kv_heads, tcfg.hd)
            assert got_l["kv"][name].dtype == want_l["kv"][name].dtype
            _close(got_l["kv"][name], want_l["kv"][name], tol["h"])
    logits2, cache2 = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    assert torch.equal(logits2, logits) and torch.equal(cache2[0]["kv"]["k"], cache[0]["kv"]["k"])


@pytest.mark.parametrize("cache_from", ["port", "jax"])
def test_decode_matches_jax(run, cache_from):
    """8 decode steps from the port's prefill cache, or from the JAX
    prefill cache carried across."""
    model, tcfg, toks, j, tol = run["model"], run["tcfg"], run["toks"], run["j"], run["tol"]
    if cache_from == "jax":
        cache = T.cache_from_jax(j["cache"], tcfg, device="cpu")
    else:
        cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)[1]
    for i, t in enumerate(range(P_LEN, S_LEN)):
        if i % 2:
            logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
            _close(logits, j["decode_logits"][i], tol["logit"])
        else:
            hidden, cache = T.decode_step_hidden(model, tcfg, toks[:, t], cache, t)
            _close(hidden, j["decode_hidden"][i], tol["logit"])


def test_decode_matches_forward(run):
    """Prefill + token-by-token decode == full-sequence forward, on the
    port alone (``tests/test_models.py``'s check and tolerances in float32)."""
    model, tcfg, toks, tol = run["model"], run["tcfg"], run["toks"], run["tol"]
    hidden, _, _ = T.forward_seq(model, tcfg, toks)
    full_logits = L.unembed(model.embed, tcfg, hidden)
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    _close(logits, full_logits[:, P_LEN - 1], tol["fwd_prefill"])
    for t in range(P_LEN, S_LEN):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, full_logits[:, t], tol["fwd_step"])


def test_flash_forward_equals_dense(run):
    model, tcfg, toks = run["model"], run["tcfg"], run["toks"]
    h_dense = T.forward_seq(model, dataclasses.replace(tcfg, attn_chunk=0), toks)[0]
    for over in (dict(attn_chunk=8), dict(attn_chunk=8, causal_skip=True)):
        h = T.forward_seq(model, dataclasses.replace(tcfg, **over), toks)[0]
        _close(h, h_dense, run["tol"]["flash"])


def test_local_layers_and_ring_cache_match_jax():
    """A windowed layer: prefill longer than the window keeps the trailing
    window in ring order, and the decode writes slot pos % window."""
    jcfg, tcfg = _cfgs(block_pattern=("attn", "local"), window=6, n_layers=2)
    params, _ = JT.init_params(jax.random.PRNGKey(7), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, jcache = JT.prefill(params, jcfg, jnp.asarray(toks[:, :10]), 16)
    tl, tcache = T.prefill(model, tcfg, toks[:, :10], 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL_LOGIT, atol=ATOL_LOGIT)
    assert tcache[1]["kv"]["k"].shape[1] == 6
    for got, want in zip(tcache, T.cache_from_jax(_np(jcache), tcfg, device="cpu")):
        np.testing.assert_allclose(got["kv"]["k"].numpy(), want["kv"]["k"].numpy(),
                                   rtol=RTOL_H, atol=ATOL_H)
    for t in range(10, 16):
        jl, jcache = JT.decode_step(params, jcfg, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        tl, tcache = T.decode_step(model, tcfg, toks[:, t], tcache, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL_LOGIT,
                                   atol=ATOL_LOGIT)


# --------------------------------------------------------------------------
# init and the weight layouts
# --------------------------------------------------------------------------

def test_init_params_layout_and_scales():
    """The port's init: the JAX tree's shapes layer by layer, the
    reference's 1/√fan_in scales, reproducible from the seed."""
    jcfg, tcfg = _cfgs(d_model=256, n_heads=8, n_kv_heads=4, d_ff=512, n_layers=2)
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
    model = T.init_params(0, tcfg, device="cpu")
    tree = model.tree()
    assert {k: tuple(v.shape) for k, v in tree["embed"].items()} == \
        {k: v.shape for k, v in shapes["embed"].items()}
    for lp, jp in zip(tree["layers"], shapes["rem"]):
        assert jax.tree.map(lambda s: tuple(s.shape), jp) == \
            {n: {k: tuple(v.shape) for k, v in sub.items()} for n, sub in lp.items()}
    d, h, hd = tcfg.d_model, tcfg.n_heads, tcfg.hd
    attn = tree["layers"][0]["attn"]
    for name, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", h * hd)):
        assert abs(attn[name].std().item() * np.sqrt(fan_in) - 1.0) < 0.05, name
    assert abs(tree["embed"]["tok"].std().item() * np.sqrt(d) - 1.0) < 0.05
    assert abs(tree["layers"][1]["mlp"]["w_down"].std().item() * np.sqrt(tcfg.d_ff) - 1) < 0.05
    again = T.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert sum(p.numel() for p in model.parameters()) == tcfg.n_params()


def test_params_from_jax_full_olmo_layout_on_meta():
    """The full olmo_1b tree (16 groups stacked on the leading axis) carried
    across on the meta device: 16 layers of the right shapes, no storage."""
    jcfg, tcfg = jbase.get_config("olmo_1b"), C.get_config("olmo_1b")
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
    assert len(shapes["blocks"]) == 1 and shapes["rem"] == []
    assert shapes["blocks"][0]["attn"]["wq"].shape == (16, 2048, 16, 128)
    meta = jax.tree.map(lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
                        shapes)
    model = T.params_from_jax(meta, tcfg, device="meta")
    assert len(model.layers) == 16 and model.device.type == "meta"
    assert tuple(model.layers[15].attn["wo"].shape) == (16, 128, 2048)
    assert tuple(model.layers[0].mlp["w_gate"].shape) == (2048, 8192)
    assert sum(p.numel() for p in model.parameters()) == tcfg.n_params() == jcfg.n_params()


def test_params_from_jax_unstacks_groups_in_order(run):
    """Layer g of the scanned tree is group g of the stacked leaves; the
    unscanned tree's layer i is ``rem[i]``."""
    params, model = _np(run["params"]), run["model"]
    for i, blk in enumerate(model.layers):
        want = (params["rem"][i]["attn"]["wq"] if not run["tcfg"].scan_layers
                else params["blocks"][0]["attn"]["wq"][i])
        np.testing.assert_array_equal(blk.attn["wq"].numpy(), want)
    with pytest.raises(ValueError, match="layer plan"):
        T.params_from_jax(params, dataclasses.replace(run["tcfg"], n_layers=8), device="cpu")


def test_compute_copy_follows_the_masters():
    """bf16 compute: the cast copy is made once and rebuilt after a weight
    changes in place."""
    tcfg = dataclasses.replace(C.get_smoke_config("olmo_1b"), dtype="bfloat16")
    model = T.init_params(3, tcfg, device="cpu")
    toks = np.arange(12).reshape(2, 6)
    h1 = T.forward_seq(model, tcfg, toks)[0]
    assert h1.dtype == torch.bfloat16
    first = T._cast_params(model, tcfg)
    assert T._cast_params(model, tcfg) is first
    assert first["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    with torch.no_grad():
        model.layers[0].attn["wq"].mul_(2.0)
    assert T._cast_params(model, tcfg) is not first
    assert not torch.equal(T.forward_seq(model, tcfg, toks)[0], h1)


# --------------------------------------------------------------------------
# serve, and what is left to queue A items 18-21
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo_1b", "rwkv6_3b", "recurrentgemma_9b",
                                  "granite_moe_1b_a400m"])
def test_serve_main_runs_on_cpu(capsys, arch):
    toks = tserve.main(["--arch", arch, "--smoke", "--retrieval", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    cfg = C.get_smoke_config(arch)
    assert tuple(toks.shape) == (2, 4)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    assert f"datastore: 252 keys × {cfg.d_model} dims" in capsys.readouterr().out


def test_sharding_ctx_keeps_values():
    mesh = make_serving_mesh(2, device="cpu")
    shd = sharding.ShardingCtx.for_mesh(mesh, seq_shard=False)
    x = torch.arange(6.0)
    assert shd.mesh is mesh and shd.constrain(x, "act_batch") is x
    assert sharding.ShardingCtx.for_mesh(None).mesh is None
    assert sharding.null_ctx().constrain(x) is x
    with pytest.raises(TypeError):
        sharding.ShardingCtx.for_mesh(object())


def _slot_case(over):
    """olmo_1b's smoke config with ``over``, its seeded model, and the model
    placed on 2 × 2 CPU slots."""
    cfg = dataclasses.replace(C.get_smoke_config("olmo_1b"), **over)
    model = T.init_params(3, cfg, device="cpu")
    mesh = make_host_mesh(2, slots=4, device="cpu")
    _, _, (st_sh, _) = steps.build_train(cfg, C.ShapeConfig("t", "train", 12, 2), mesh)
    return cfg, model, steps.place(model.tree(), st_sh["params"])


def _loss_ignores_frames():
    cfg, _, params = _slot_case({})
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    frames = np.ones((2, cfg.encoder_seq, cfg.d_model), np.float32)
    assert float(spmd.loss_fn(params, cfg, {**batch, "frames": frames})[0]) == \
        float(spmd.loss_fn(params, cfg, batch)[0])


def _prefill_with_encoder():
    cfg, model, params = _slot_case(dict(n_encoder_layers=2, encoder_seq=6))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 4))
    frames = np.random.default_rng(2).standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    got, cache = spmd.prefill(params, cfg, toks, 8, frames=frames)
    want, ref = T.prefill(model, cfg, toks, 8, frames=frames)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), rtol=RTOL_LOGIT,
                               atol=ATOL_LOGIT)
    np.testing.assert_allclose(cache[1]["cross"]["k"].gather().numpy(),
                               ref[1]["cross"]["k"].numpy(), rtol=RTOL_LOGIT, atol=ATOL_LOGIT)


def _decode_after_patches():
    cfg, model, params = _slot_case(dict(n_patches=4, patch_dim=16))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 5))
    patches = np.random.default_rng(2).standard_normal((2, 4, 16)).astype(np.float32)
    _, cache = spmd.prefill(params, cfg, toks[:, :4], 12, patches=patches)
    _, ref = T.prefill(model, cfg, toks[:, :4], 12, patches=patches)
    got, _ = spmd.decode_step(params, cfg, toks[:, 4], cache, 8)
    want, _ = T.decode_step(model, cfg, toks[:, 4], ref, 8)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), rtol=RTOL_LOGIT,
                               atol=ATOL_LOGIT)


def _build_prefill_with_patches():
    cfg = dataclasses.replace(C.get_smoke_config("olmo_1b"), n_patches=4)
    _, (p_specs, b_specs), (p_sh, b_sh) = steps.build_prefill(
        cfg, C.SHAPES["prefill_32k"], make_host_mesh(2, slots=4, device="cpu"))
    assert tuple(b_specs["patches"].shape) == (32, 4, cfg.patch_dim)
    assert tuple(b_specs["tokens"].shape) == (32, 32768 - 4)
    assert b_sh["patches"].spec[0] == "data" and "mm_projector" in p_sh


UNPORTED = {
    "spmd loss_fn frames": _loss_ignores_frames,
    "spmd prefill encoder": _prefill_with_encoder,
    "spmd decode_step vlm": _decode_after_patches,
    "spmd check_supported vlm": lambda: spmd.check_supported(
        dataclasses.replace(C.get_smoke_config("olmo_1b"), n_patches=4)),
    "build_prefill vlm": _build_prefill_with_patches,
}


@pytest.mark.parametrize("what", list(UNPORTED))
def test_unported_features_name_queue_a17(what):
    """The calls that refused frames, an encoder and patches until the slot
    program carried them (ROADMAP queue A item 21c) run: frames on a config
    without an encoder are ignored, as the reference ignores them; a
    prefill with an encoder and a decode step after patches match the
    one-device functions (1e-4); ``build_prefill`` places the patches by
    ``act_batch`` beside the projector."""
    UNPORTED[what]()


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        C.get_config("gpt5")
