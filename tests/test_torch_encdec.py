"""The port's encoder-decoder (``repro_torch.models``: the ``enc-attn``
kind, cross-attention and its cache, ``encode``, ``forward_seq(frames=)``,
``prefill(frames=)``, decode with the cross step, ``loss_fn`` with frames)
and the ``whisper_large_v3`` preset, held to the JAX package on the same
seeded numpy inputs.

Whole models run on the JAX ``init_params`` weights carried across with
``params_from_jax`` at ``smoke_config()`` (2 decoder + 2 encoder layers,
d_model 64, 4 heads, ``encoder_seq`` 24, float32, dense attention): the
encoder stacked in one scan (the preset's ``scan_layers``) and unstacked
(``scan_layers=False``), and a flash variant (``attn_chunk`` 8 with
``encoder_seq`` 20, which the chunk does not divide: the padded keys are
masked and the padded query rows cut off).  A 19-token prompt, decode to
24 tokens.  The reference ropes the encoder's self-attention and never
cross-attention: either put on the wrong side passes every shape check and
fails these parities.

Tolerances (``tests/test_torch_moe.py``'s).  float32 single functions
(encode, attention, the cross cache): 1e-5 relative and absolute.  float32
whole models (hidden states, logits, caches, gradients, train steps, the
serving loop's log-probs): 1e-4 relative, 2e-4 absolute.  Decode against
the port's own forward: the reference test's, 1e-4 / 1e-4 for the
prefill's logits, 1e-4 / 2e-4 for each step's
(``tests/test_models.py::test_decode_matches_forward``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import TokenPipeline as JaxPipeline
from repro.launch import steps as JS
from repro.models import knn_lm as JK
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.sharding import null_ctx
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import knn_lm as K
from repro_torch.models import layers as L
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves

TOL_F = (1e-5, 1e-5)               # single functions, float32
TOL_M = (1e-4, 2e-4)               # whole models, float32
ARCH = "whisper_large_v3"
P_LEN, S_LEN = 19, 24
VARIANTS = {"stacked": {}, "unstacked": dict(scan_layers=False),
            "flash": dict(attn_chunk=8, encoder_seq=20)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return (dataclasses.replace(jbase.get_smoke_config(ARCH), **over),
            dataclasses.replace(C.get_smoke_config(ARCH), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0], atol=tol[1], err_msg=what)


def _close_tree(got, want, tol, what=""):
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(np.shape(b)), (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


def _frames(cfg, seed=2, b=2):
    """The reference pipeline's stub frontend: seeded standard normal frames."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _model(jcfg, tcfg, seed=1):
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, T.params_from_jax(_np(params), tcfg, device="cpu")


# --------------------------------------------------------------------------
# the preset, its tables, the weights from JAX
# --------------------------------------------------------------------------

def test_presets_are_the_reference_presets():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(C, get)(ARCH)) == \
            dataclasses.asdict(getattr(jbase, get)(ARCH)), get
    jcfg, tcfg = jbase.get_config(ARCH), C.get_config(ARCH)
    assert tcfg.n_params() == jcfg.n_params() == 1_600_783_360
    assert C.applicable_shapes(tcfg) == jbase.applicable_shapes(jcfg)
    assert ARCH in C.PORTED_ARCHS
    plan = T.encoder_plan(tcfg)
    assert (plan.n_groups, plan.rem_kinds) == (32, ())
    assert T.encoder_plan(dataclasses.replace(tcfg, scan_layers=False)).rem_kinds == \
        ("enc-attn",) * 32


@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_shapes_specs_and_count_match_jax(get, qk_norm):
    """``param_shapes`` and ``param_specs`` against the reference's
    ``init_params`` (under ``eval_shape`` for the published config), the
    decoder's and the encoder's stacked leaves with their leading
    ``"layers"`` axis dropped; a cross-attention has no qk-norm scales even
    where ``qk_norm`` is set (the encoder's self-attention has them); the
    counts agree, and equal ``n_params()`` and the norms it leaves out."""
    jcfg = dataclasses.replace(getattr(jbase, get)(ARCH), qk_norm=qk_norm)
    tcfg = dataclasses.replace(getattr(C, get)(ARCH), qk_norm=qk_norm)
    j_shapes, j_specs = JS.params_specs(jcfg)
    t_shapes, t_specs = T.param_shapes(tcfg), T.param_specs(tcfg)
    assert list(t_shapes) == ["embed", "final_norm", "layers", "encoder"]

    def want(tree, src):
        drop = int(src[0] == "blocks")
        sub = tree["rem"][src[1]] if src[0] == "rem" else tree["blocks"][src[1]]
        return sub, drop

    for what, plan, jt_sh, jt_sp, tt_sh, tt_sp in (
            ("decoder", None, j_shapes, j_specs, t_shapes["layers"], t_specs["layers"]),
            ("encoder", T.encoder_plan(tcfg), j_shapes["encoder"], j_specs["encoder"],
             t_shapes["encoder"]["layers"], t_specs["encoder"]["layers"])):
        for i, (kind, src) in enumerate(T._layer_sources(tcfg, plan)):
            sh, drop = want(jt_sh, src)
            sp, _ = want(jt_sp, src)
            assert tt_sp[i] == jax.tree.map(
                lambda s: tuple(s)[drop:], sp, is_leaf=lambda s: isinstance(s, tuple)), (what, i)
            assert jax.tree.map(lambda m: tuple(m.shape), tt_sh[i]) == \
                jax.tree.map(lambda x: tuple(x.shape)[drop:], sh), (what, i)
            if what == "decoder":
                assert list(tt_sh[i]) == ["norm1", "attn", "normx", "xattn", "norm2", "mlp"]
                assert set(tt_sh[i]["attn"]) - set(tt_sh[i]["xattn"]) == \
                    ({"q_norm", "k_norm"} if qk_norm else set())
            else:
                assert kind == "enc-attn" and "xattn" not in tt_sh[i]
    assert t_specs["encoder"]["norm"] == j_specs["encoder"]["norm"]
    n = sum(t.numel() for t in tree_leaves(t_shapes))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_shapes))
    d = tcfg.d_model
    norms = 2 * d * (3 * tcfg.n_layers + 2 * tcfg.n_encoder_layers + 2)
    qk = qk_norm * 2 * tcfg.hd * (tcfg.n_layers + tcfg.n_encoder_layers)   # self-attention's
    assert n == tcfg.n_params() + norms + qk
    if get == "get_smoke_config":
        model = T.init_params(0, tcfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == n
        assert not any("norm" in k for blk in model.layers for k in blk.xattn)


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_params_and_opt_state_from_jax(layout):
    """Every leaf of the JAX tree lands bit for bit where the port's layout
    puts it — the encoder's scan-stacked ``blocks[0]`` (layer g at index g)
    or its ``rem`` list — and AdamW's moments the same way."""
    jcfg, tcfg = _cfgs(**VARIANTS[layout])
    params, model = _model(jcfg, tcfg)
    enc = params["encoder"]
    assert (len(enc["blocks"]), len(enc["rem"])) == ((1, 0) if layout == "stacked" else (0, 2))
    tree = model.tree()
    for i in range(tcfg.n_encoder_layers):
        src = enc["rem"][i] if enc["rem"] else jax.tree.map(lambda x: x[i], enc["blocks"][0])
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree["encoder"]["layers"][i]))
        for a, b in zip(got, jax.tree.leaves(_np(src))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tree["encoder"]["norm"]["scale"].numpy(),
                                  np.asarray(enc["norm"]["scale"]))
    r = np.random.default_rng(3)
    opt = {"mu": jax.tree.map(lambda x: r.standard_normal(x.shape).astype(np.float32), params),
           "nu": jax.tree.map(lambda x: r.random(x.shape).astype(np.float32), params),
           "count": np.int32(3)}
    t_opt = T.opt_state_from_jax(opt, tcfg, device="cpu")
    for m in ("mu", "nu"):
        want = T.params_from_jax(opt[m], tcfg, device="cpu").tree()
        assert list(t_opt[m]) == list(tree)
        for a, b in zip(tree_leaves(t_opt[m]), tree_leaves(want)):
            assert torch.equal(a, b)
    assert int(t_opt["count"]) == 3
    with pytest.raises(ValueError, match="encoder's layer plan"):
        bad = dict(params, encoder=dict(enc, rem=enc["rem"][:1]) if enc["rem"] else
                   dict(enc, blocks=[], rem=[]))
        T.params_from_jax(_np(bad), tcfg, device="cpu")


# --------------------------------------------------------------------------
# the layers: encode, cross-attention, the cross cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["stacked", "flash"])
def test_encode_matches_jax(variant):
    """The encoder over seeded frames: its bidirectional, roped ``enc-attn``
    layers (dense, or the flash loop over 20 frames in chunks of 8) and its
    norm."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    params, model = _model(jcfg, tcfg)
    frames = _frames(jcfg)
    want = JT.encode(JT._cast_params(params, jcfg), jcfg, jnp.asarray(frames), null_ctx())
    got = T.encode(model, tcfg, frames)
    assert tuple(got.shape) == (2, jcfg.encoder_seq, jcfg.d_model)
    _close(got, want, TOL_F)
    # the encoder's attention is bidirectional: the first frame sees the last
    moved = frames.copy()
    moved[:, -1] = -moved[:, -1]
    assert not torch.allclose(T.encode(model, tcfg, moved)[:, 0], got[:, 0])


def _xattn_case(jcfg, s=19, seed=5):
    p, _ = JL.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32, cross=True)
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    eo = r.standard_normal((2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return p, {k: torch.tensor(np.asarray(v)) for k, v in p.items()}, x, eo


@pytest.mark.parametrize("variant", ["stacked", "flash"], ids=["dense", "flash"])
def test_cross_attention_matches_jax(variant):
    """``attention_forward(encoder_out=)`` (dense, or the flash loop with no
    causal mask when the decoder's 19 tokens pass ``attn_chunk`` 8), one
    decode step with ``encoder_out`` and with ``init_cross_cache``'s K/V;
    no RoPE: the output does not move with the query's position."""
    jcfg, tcfg = _cfgs(**VARIANTS[variant])
    jp, tp, x, eo = _xattn_case(jcfg)
    want = JL.attention_forward(jp, jcfg, jnp.asarray(x), encoder_out=jnp.asarray(eo))
    got = L.attention_forward(tp, tcfg, torch.tensor(x), encoder_out=torch.tensor(eo))
    _close(got, want, TOL_F)
    rows = L.attention_forward(tp, tcfg, torch.tensor(x[:, ::-1].copy()),
                               encoder_out=torch.tensor(eo))
    _close(rows.flip(1), got, TOL_F, "position-free")
    cc = L.init_cross_cache(tp, tcfg, torch.tensor(eo))
    x1 = x[:, 5:6]
    jw, _ = JL.attention_decode(jp, jcfg, jnp.asarray(x1), None, jnp.int32(5),
                                encoder_out=jnp.asarray(eo))
    for kw in (dict(encoder_out=torch.tensor(eo)), dict(cross_cache=cc)):
        out, cache = L.attention_decode(tp, tcfg, torch.tensor(x1), None, 5, **kw)
        assert cache is None
        _close(out, jw, TOL_F, str(list(kw)))
    _close(out[:, 0], got[:, 5], TOL_F, "decode = forward")


def test_init_cross_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    jp, tp, _, eo = _xattn_case(jcfg)
    want = JL.init_cross_cache(jp, jcfg, jnp.asarray(eo))
    got = L.init_cross_cache(tp, tcfg, torch.tensor(eo))
    assert list(got) == ["k", "v"]
    for k in ("k", "v"):
        assert tuple(got[k].shape) == (2, jcfg.encoder_seq, jcfg.n_kv_heads, jcfg.hd)
        _close(got[k], want[k], TOL_F, k)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """JAX and the port on the smoke weights in one layout: the forward with
    and without frames, a prefill of P_LEN tokens with frames and the decode
    steps to S_LEN."""
    jcfg, tcfg = _cfgs(**VARIANTS[request.param])
    params, model = _model(jcfg, tcfg)
    r = np.random.default_rng(1)
    toks = r.integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)
    frames = _frames(jcfg)
    fwd = jax.jit(lambda p, t, f: JT.forward_seq(p, jcfg, t, frames=f)[0])
    j = {"hidden": np.asarray(fwd(params, jnp.asarray(toks), jnp.asarray(frames))),
         "bare": np.asarray(fwd(params, jnp.asarray(toks), None))}
    logits0, cache = jax.jit(lambda p, t, f: JT.prefill(p, jcfg, t, S_LEN, frames=f))(
        params, jnp.asarray(toks[:, :P_LEN]), jnp.asarray(frames))
    j["prefill_logits"], j["cache"], j["decode_logits"] = np.asarray(logits0), _np(cache), []
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    for t in range(P_LEN, S_LEN):
        lg, cache = dec(params, jnp.asarray(toks[:, t]), cache, jnp.int32(t))
        j["decode_logits"].append(np.asarray(lg))
    j["final_cache"] = _np(cache)
    return dict(variant=request.param, jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                toks=toks, frames=frames, j=j)


def test_forward_seq_matches_jax(run):
    """With frames, and without them (no cross-attention runs): each against
    JAX; the frames change the hidden states."""
    model, tcfg, toks, j = run["model"], run["tcfg"], run["toks"], run["j"]
    hidden, aux, states = T.forward_seq(model, tcfg, toks, frames=run["frames"])
    assert states is None and float(aux) == 0.0
    _close(hidden, j["hidden"], TOL_M, "with frames")
    bare, _, _ = T.forward_seq(model, tcfg, toks)
    _close(bare, j["bare"], TOL_M, "without frames")
    assert (hidden - bare).abs().max() > 1e-2


def test_prefill_and_decode_match_jax(run):
    """The prefill's logits and cache (each layer's KV and cross K/V), each
    decode step's logits and the final cache, against JAX's."""
    tcfg, model, toks, j = run["tcfg"], run["model"], run["toks"], run["j"]
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN, frames=run["frames"])
    assert all(list(st) == ["kv", "cross"] for st in cache)
    _close(logits, j["prefill_logits"], TOL_M)
    want = T.cache_from_jax(j["cache"], tcfg, device="cpu")
    assert all(sorted(st) == ["cross", "kv"] for st in want)
    _close_tree(cache, want, TOL_M, "prefill cache")
    for i, t in enumerate(range(P_LEN, S_LEN)):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, j["decode_logits"][i], TOL_M, f"step {t}")
    _close_tree(cache, T.cache_from_jax(j["final_cache"], tcfg, device="cpu"), TOL_M,
                "final cache")


def test_prefill_cross_cache_is_init_cross_cache_of_encode(run):
    """Each decoder layer's prefill cross cache is ``init_cross_cache`` of
    its ``xattn`` over ``encode(frames)``, bit for bit (what the card's
    phase holds)."""
    tcfg, model = run["tcfg"], run["model"]
    _, cache = T.prefill(model, tcfg, run["toks"][:, :P_LEN], S_LEN, frames=run["frames"])
    eo = T.encode(model, tcfg, run["frames"])
    for blk, st in zip(model.layers, cache):
        want = L.init_cross_cache(dict(blk.xattn), tcfg, eo)
        assert torch.equal(st["cross"]["k"], want["k"]) and \
            torch.equal(st["cross"]["v"], want["v"])


def test_decode_from_init_cache_and_bare_prefill_match_jax():
    """The reference's other two cases: a cache from ``init_cache`` (zero
    cross K/V, which decode attends to) and a prefill without frames (no
    ``"cross"`` entry: decode skips cross-attention)."""
    jcfg, tcfg = _cfgs()
    params, model = _model(jcfg, tcfg)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    jcache = JT.init_cache(jcfg, 2, 12)
    cache = T.init_cache(tcfg, 2, 12, device="cpu")
    assert all(float(st["cross"]["k"].abs().max()) == 0 for st in cache)
    _close_tree(cache, T.cache_from_jax(_np(jcache), tcfg, device="cpu"), (0, 0), "init")
    for t in range(4):
        want, jcache = dec(params, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        got, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(got, want, TOL_M, f"init_cache step {t}")
    _, jcache = JT.prefill(params, jcfg, jnp.asarray(toks[:, :8]), 12)
    logits, cache = T.prefill(model, tcfg, toks[:, :8], 12)
    assert all(list(st) == ["kv"] for st in cache)
    assert all(list(st) == ["kv"] for st in T.cache_from_jax(_np(jcache), tcfg, device="cpu"))
    for t in range(8, 12):
        want, jcache = dec(params, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        got, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(got, want, TOL_M, f"bare prefill step {t}")


def test_frames_on_a_decoder_only_config_are_ignored():
    """``olmo_1b``'s smoke model with frames: the same hidden states as
    without them, as in the reference."""
    jcfg, tcfg = jbase.get_smoke_config("olmo_1b"), C.get_smoke_config("olmo_1b")
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    frames = _frames(dataclasses.replace(jcfg, encoder_seq=24))
    got, _, _ = T.forward_seq(model, tcfg, toks, frames=frames)
    assert torch.equal(got, T.forward_seq(model, tcfg, toks)[0])
    want, _, _ = JT.forward_seq(params, jcfg, jnp.asarray(toks), frames=jnp.asarray(frames))
    _close(got, want, TOL_M)


@pytest.mark.parametrize("variant", ["stacked", "flash"])
def test_decode_matches_forward(variant):
    """The port's prefill with frames + token-by-token decode equals its
    forward with frames over the whole sequence, on its own init."""
    _, tcfg = _cfgs(**VARIANTS[variant])
    model = T.init_params(3, tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 20))
    frames = _frames(tcfg, seed=3)
    hidden, _, _ = T.forward_seq(model, tcfg, toks, frames=frames)
    full = L.unembed(model.embed, tcfg, hidden)
    p_len = 12
    logits, cache = T.prefill(model, tcfg, toks[:, :p_len], 20, frames=frames)
    _close(logits, full[:, p_len - 1], (1e-4, 1e-4))
    for t in range(p_len, 20):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, full[:, t], (1e-4, 2e-4), f"step {t}")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_fn_value_and_grad_match_jax(remat):
    """``loss_fn`` with ``batch["frames"]`` and every gradient, the
    encoder's and the cross-attention's included, against
    ``jax.value_and_grad``, with a ``loss_mask``; remat on (the stacked
    encoder's and decoder's layers under per-layer checkpoints) and off."""
    jcfg, tcfg = _cfgs(remat=remat)
    params, model = _model(jcfg, tcfg, seed=4)
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24).peek(4)
    assert b["frames"].shape == (2, jcfg.encoder_seq, jcfg.d_model)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    tl, tm, tg = S.loss_and_grads(model, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    _close(tl, jl, TOL_M)
    _close(tm["xent"], jm["xent"], TOL_M)
    want = T.params_from_jax(_np(jg), tcfg, device="cpu").tree()
    assert float(tg["encoder"]["layers"][0]["attn"]["wq"].abs().max()) > 0
    assert float(tg["layers"][0]["xattn"]["wk"].abs().max()) > 0
    for i, (got, w) in enumerate(zip(tree_leaves(tg), tree_leaves(want))):
        _close(got, w, TOL_M, f"gradient leaf {i}")


def test_train_steps_match_jax():
    """Two ``make_train_step`` steps in both packages from one state, each
    batch with its frames: the metrics and every parameter after each
    step."""
    jcfg, tcfg = _cfgs()
    kw = dict(total_steps=10, warmup_steps=1, moment_dtype=jcfg.opt_state_dtype)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    params, _ = JT.init_params(jax.random.PRNGKey(5), jcfg)
    state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
    tstate = {"params": T.params_from_jax(_np(params), tcfg, device="cpu"),
              "opt": T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")}
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
    step = S.make_train_step(tcfg, topt)
    jpipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24)
    pipe = TokenPipeline(tcfg, C.SHAPES["train_4k"], batch_override=2, seq_override=24)
    for i in range(2):
        state, jm = jstep(state, jpipe.next_batch())
        tstate, m = step(tstate, pipe.next_batch("cpu"))
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k], TOL_M, f"step {i} {k}")
        want = tree_leaves(T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree())
        for got, w in zip(tree_leaves(tstate["params"].tree()), want):
            _close(got, w, TOL_M, f"params after step {i}")


def test_train_main_reaches_the_encoder(tmp_path):
    """``launch/train.py --arch whisper_large_v3 --smoke`` on the CPU: the
    pipeline's frames reach the encoder, whose AdamW moments are nonzero
    after the steps; a checkpoint round trip of the whole state (the
    encoder's leaves among them) is bit for bit."""
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
                      "2", "--seq", "16", "--checkpoint-every", "100", "--log-every", "100",
                      "--ckpt-dir", str(tmp_path / "run")])
    assert out.report.completed and len(out.losses) == 2
    mu = out.state["opt"]["mu"]
    for name in ("wq", "wk", "wv", "wo"):
        assert all(float(layer["attn"][name].abs().max()) > 0 for layer in mu["encoder"]["layers"])
        assert all(float(layer["xattn"][name].abs().max()) > 0 for layer in mu["layers"])
    tree = train.state_tree(out.state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=1)
    mgr.save(7, tree)
    mgr.wait()
    back, _, step = mgr.restore(tree, device="cpu")
    assert step == 7 and len(tree_leaves(back)) == len(tree_leaves(tree))
    assert any("encoder" in str(k) for k in tree["params"])
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert torch.equal(torch.as_tensor(a), b)


# --------------------------------------------------------------------------
# serving with the kNN-LM head
# --------------------------------------------------------------------------

def test_serving_loop_with_frames_matches_jax():
    """The composed loop of the card's phase: ``prefill(frames=)``, then
    greedy steps of ``decode_step_retrieval`` with the in-step
    ``Datastore`` (built by a decoder run without frames, as the reference
    builds it), against the same loop in JAX: tokens equal, log-probs
    within the whole-model tolerance."""
    jcfg, tcfg = _cfgs()
    rc = dict(enabled=True, k=4, lam=0.5)
    jcfg = dataclasses.replace(jcfg, retrieval=jbase.RetrievalConfig(**rc))
    tcfg = dataclasses.replace(tcfg, retrieval=C.RetrievalConfig(**rc))
    params, model = _model(jcfg, tcfg, seed=0)
    r = np.random.default_rng(0)
    corpus = r.integers(0, jcfg.vocab_size, (4, 48)).astype(np.int32)
    prompts = corpus[:2, :16]
    frames = _frames(jcfg, seed=9)
    jds = JK.build_datastore(params, jcfg, [jnp.asarray(corpus)])
    ds = K.build_datastore(model, tcfg, [corpus])
    _close(ds.keys, jds.keys, TOL_M)
    n, total = 6, 16 + 6
    jl, jc = jax.jit(lambda p, t, f: JT.prefill(p, jcfg, t, total, frames=f))(
        params, jnp.asarray(prompts), jnp.asarray(frames))
    logits, cache = T.prefill(model, tcfg, prompts, total, frames=frames)
    _close(logits, jl, TOL_M, "prefill")
    step = jax.jit(lambda p, t, c, pos: JK.decode_step_retrieval(p, jcfg, t, c, pos, jds))
    jtok, tok = jnp.argmax(jl, -1), torch.argmax(logits, -1)
    for i in range(n):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), f"token {i}")
        jl, jc = step(params, jtok, jc, jnp.int32(16 + i))
        logits, cache = K.decode_step_retrieval(model, tcfg, tok, cache, 16 + i, ds)
        _close(logits, jl, TOL_M, f"step {i}")
        jtok, tok = jnp.argmax(jl, -1), torch.argmax(logits, -1)


# --------------------------------------------------------------------------
# the calls the slot program refused until it carried the encoder
# --------------------------------------------------------------------------

def _built_train(cfg, mesh):
    _, (st, b), (st_sh, b_sh) = S.build_train(cfg, C.SHAPES["train_4k"], mesh)
    assert tuple(b["frames"].shape) == (256, cfg.encoder_seq, cfg.d_model)
    assert b_sh["frames"].spec[0] == "data"
    assert len(st["params"]["encoder"]["layers"]) == cfg.n_encoder_layers
    assert st_sh["opt"]["mu"]["layers"][0]["xattn"]["wq"].spec == \
        st_sh["params"]["layers"][0]["attn"]["wq"].spec


def _built_prefill(cfg, mesh):
    _, (_, b), (_, b_sh) = S.build_prefill(cfg, C.SHAPES["prefill_32k"], mesh)
    assert tuple(b["frames"].shape) == (32, cfg.encoder_seq, cfg.d_model)
    assert b_sh["frames"].spec[0] == "data"


def _built_decode(cfg, mesh):
    _, (_, _, cache, _), (_, _, c_sh, _) = S.build_decode(cfg, C.SHAPES["decode_32k"], mesh)
    assert tuple(cache[0]["cross"]["k"].shape) == (128, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    assert c_sh[0]["cross"]["k"].spec[2] == "model"      # 4 KV heads on 2 model slots


def _prefill_without_frames(cfg, mesh):
    """The prefill without frames keeps no cross K/V, as the reference's."""
    jcfg, tcfg = _cfgs()
    _, model = _model(jcfg, tcfg)
    _, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], mesh)
    params = S.place(model.tree(), st_sh["params"])
    toks = np.zeros((1, 4), np.int32)
    got, cache = spmd.prefill(params, tcfg, toks, 8)
    want, ref = T.prefill(model, tcfg, toks, 8)
    _close(got.gather(), want, TOL_M)
    assert [set(st) for st in cache] == [set(st) for st in ref] == [{"kv"}] * tcfg.n_layers


REFUSALS = {
    "build_train": _built_train,
    "build_prefill": _built_prefill,
    "build_decode": _built_decode,
    "spmd.prefill": _prefill_without_frames,
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_slot_program_refuses_whisper(what):
    """The calls the slot program refused until it carried the encoder
    and cross-attention (ROADMAP queue A item 21c) run on 2 × 2 CPU slots:
    the builders place the frames by ``act_batch`` and the cross K/V by
    their KV heads; ``tests/test_torch_encdec_sharded.py`` holds the
    values to JAX."""
    REFUSALS[what](C.get_smoke_config(ARCH), make_host_mesh(2, slots=4, device="cpu"))


def _decode_arg_bytes(cfg, shape, data=16, model=16):
    """A hand count of whisper's per-slot argument bytes in a decode cell
    on the (16, 16) pod: float32 weights, whole but the MLPs' (d_ff splits
    16 ways; 20 heads and a vocab of 51,866 do not); per layer the KV cache
    of the slot's 2,048 positions (20 KV heads do not split, so the
    positions do) and the cross K/V of its rows, whole; the tokens (int64)
    and pos."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    dec = 2 * d + 4 * d * d + 2 * d + 4 * d * d + 2 * d + 2 * d * f // model
    enc = 2 * d + 4 * d * d + 2 * d + 2 * d * f // model
    weights = 2 * v * d + cfg.n_layers * dec + cfg.n_encoder_layers * enc + 2 * 2 * d
    rows, kvh = shape.global_batch // data, cfg.n_kv_heads
    kv = 2 * rows * (shape.seq_len // model) * kvh * hd * 2
    cross = 2 * rows * cfg.encoder_seq * kvh * hd * 2
    return 4 * weights + cfg.n_layers * (kv + cross) + rows * 8 + 4


def test_dryrun_records_whisper_as_refused_by_the_slot_program():
    """whisper's decode cell on the (16, 16) pod traces; its per-slot
    argument bytes equal the hand count, the cross K/V included."""
    rec = dryrun.run_cell(ARCH, "decode_32k", multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    cfg = C.get_config(ARCH)
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _decode_arg_bytes(cfg, C.SHAPES["decode_32k"])
    assert rec["trace"]["encoder_depths"] == [2, 3]
