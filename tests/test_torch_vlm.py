"""The port's VLM path (``repro_torch.models.transformer``: the
``mm_projector``, ``forward_seq(patches=)``, ``prefill(patches=)`` and decode
after it, ``loss_fn`` over the text positions) and the
``llava_next_mistral_7b`` preset, held to the JAX package on the same seeded
numpy inputs.

Whole models run on the JAX ``init_params`` weights carried across with
``params_from_jax`` at ``smoke_config()`` (3 layers, d_model 96, 6/2 heads,
12 patches of 32 features, float32, dense attention): the layers stacked
(the preset's ``scan_layers``), unstacked (``scan_layers=False``), and a
flash variant (``attn_chunk`` 8, which divides neither the prefill's 12 + 15
positions nor the forward's 12 + 21).  A 15-token prompt after the patches,
decode to 21 tokens, at positions P + 15 … P + 20.  A prefill whose decode
continued at position S instead of P + S would rope the steps at the wrong
positions and overwrite the patches' cache slots, and pass every shape
check: the decode parities catch it.

Tolerances (``tests/test_torch_encdec.py``'s).  float32 single functions
(the projector): 1e-5 relative and absolute.  float32 whole models (hidden
states, logits, caches, gradients, train steps, the serving loop's
log-probs): 1e-4 relative, 2e-4 absolute.  Decode against the port's own
forward: the reference test's, 1e-4 / 1e-4 for the prefill's logits, 1e-4 /
2e-4 for each step's (``tests/test_models.py::test_decode_matches_forward``).
bfloat16 projector against JAX's: 2^-7 relative and absolute on under 1 % of
the entries, bit for bit elsewhere (``tests/test_torch_models.py``'s GELU
criterion: XLA's and torch's float32 tanh differ in their last bits)."""
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
from repro.models import transformer as JT
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
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
TOL_BF16 = 2.0 ** -7               # bfloat16 against JAX, about one ulp
ARCH = "llava_next_mistral_7b"
P_LEN, S_LEN = 15, 21              # text tokens: the prompt, the whole sequence
VARIANTS = {"stacked": {}, "unstacked": dict(scan_layers=False),
            "flash": dict(attn_chunk=8)}


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


def _patches(cfg, seed=2, b=2):
    """The reference pipeline's stub vision tower: seeded standard normal
    patch features."""
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)


def _model(jcfg, tcfg, seed=1):
    params, _ = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, T.params_from_jax(_np(params), tcfg, device="cpu")


def _jax_projector(params, jcfg, patches):
    """The reference's projector expression (``repro/models/transformer.py``'s
    ``forward_seq``), on its compute-dtype parameters."""
    pr = JT._cast_params(params, jcfg)["mm_projector"]
    x = jnp.asarray(patches).astype(jnp.dtype(jcfg.dtype))
    pe = jax.nn.gelu(jnp.einsum("bpc,cd->bpd", x, pr["w1"]))
    return jnp.einsum("bpd,de->bpe", pe, pr["w2"])


# --------------------------------------------------------------------------
# the preset, its tables, the weights from JAX
# --------------------------------------------------------------------------

def test_presets_are_the_reference_presets():
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(C, get)(ARCH)) == \
            dataclasses.asdict(getattr(jbase, get)(ARCH)), get
    jcfg, tcfg = jbase.get_config(ARCH), C.get_config(ARCH)
    assert tcfg.n_params() == jcfg.n_params() == 7_241_465_856
    assert (tcfg.n_patches, tcfg.patch_dim, tcfg.attn_chunk) == (2880, 1024, 1024)
    assert C.applicable_shapes(tcfg) == jbase.applicable_shapes(jcfg)
    assert ARCH in C.PORTED_ARCHS and set(C.PORTED_ARCHS) == set(C.ARCH_IDS)


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_param_shapes_specs_and_count_match_jax(get):
    """``param_shapes`` and ``param_specs`` against the reference's
    ``init_params`` (under ``eval_shape`` for the published config), the
    stacked leaves with their leading ``"layers"`` axis dropped, and the
    projector's pair with its logical axes; the counts agree, and equal
    ``n_params()`` with the norms and the projector it leaves out (for the
    published config 7,262,703,616)."""
    jcfg, tcfg = getattr(jbase, get)(ARCH), getattr(C, get)(ARCH)
    j_shapes, j_specs = JS.params_specs(jcfg)
    t_shapes, t_specs = T.param_shapes(tcfg), T.param_specs(tcfg)
    assert list(t_shapes) == ["embed", "final_norm", "layers", "mm_projector"]
    assert t_specs["mm_projector"] == {"w1": ("embed", "mlp"), "w2": ("mlp", "embed")} == \
        jax.tree.map(tuple, j_specs["mm_projector"], is_leaf=lambda s: isinstance(s, tuple))
    assert {k: tuple(v.shape) for k, v in t_shapes["mm_projector"].items()} == \
        {k: tuple(v.shape) for k, v in j_shapes["mm_projector"].items()}
    for i, (_, src) in enumerate(T._layer_sources(tcfg)):
        drop = int(src[0] == "blocks")
        sub = lambda tree: tree["rem"][src[1]] if src[0] == "rem" else tree["blocks"][src[1]]
        assert t_specs["layers"][i] == jax.tree.map(
            lambda s: tuple(s)[drop:], sub(j_specs), is_leaf=lambda s: isinstance(s, tuple))
        assert jax.tree.map(lambda m: tuple(m.shape), t_shapes["layers"][i]) == \
            jax.tree.map(lambda x: tuple(x.shape)[drop:], sub(j_shapes))
    n = sum(t.numel() for t in tree_leaves(t_shapes))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_shapes))
    d = tcfg.d_model
    norms = d * (2 * tcfg.n_layers + 1)
    projector = tcfg.patch_dim * d + d * d
    assert n == tcfg.n_params() + norms + projector
    if get == "get_config":
        assert n == 7_262_703_616 and projector == 20_971_520 and norms == 266_240
    else:
        model = T.init_params(0, tcfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == n
        proj = model.tree()["mm_projector"]
        # drawn at the reference's dense_init scale, 1/√fan_in
        for k, fan_in in (("w1", tcfg.patch_dim), ("w2", d)):
            assert abs(float(proj[k].std()) * fan_in ** 0.5 - 1) < 0.1, k
    olmo = C.get_smoke_config("olmo_1b")
    assert "mm_projector" not in T.param_shapes(olmo)
    assert "mm_projector" not in T.init_params(0, olmo, device="cpu").tree()


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_params_and_opt_state_from_jax(layout):
    """The JAX tree's ``mm_projector`` leaves land bit for bit in the
    port's, beside the layers in either layout, and AdamW's moments the
    same way."""
    jcfg, tcfg = _cfgs(**VARIANTS[layout])
    params, model = _model(jcfg, tcfg)
    assert (len(params["blocks"]), len(params["rem"])) == \
        ((1, 0) if layout == "stacked" else (0, 3))
    tree = model.tree()
    for k in ("w1", "w2"):
        np.testing.assert_array_equal(tree["mm_projector"][k].numpy(),
                                      np.asarray(params["mm_projector"][k]))
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
        np.testing.assert_array_equal(t_opt[m]["mm_projector"]["w2"].numpy(),
                                      opt[m]["mm_projector"]["w2"])
    assert int(t_opt["count"]) == 3


# --------------------------------------------------------------------------
# the projector
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_projector_matches_jax(dtype):
    """GELU(patches · w1) · w2 on the compute-dtype weights, the patches
    cast to the activation dtype first: in float32 within 1e-5, in bf16
    the GELU's criterion."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    params, model = _model(jcfg, tcfg)
    patches = _patches(jcfg)
    want = _jax_projector(params, jcfg, patches)
    got = T.project_patches(model, tcfg, patches)
    assert tuple(got.shape) == (2, jcfg.n_patches, jcfg.d_model)
    assert got.dtype == tcfg.activation_dtype()
    if dtype == "float32":
        _close(got, want, TOL_F)
    else:
        _close(got, want, (TOL_BF16, TOL_BF16))
        assert (_f32(got) != _f32(want)).mean() < 0.01


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(VARIANTS))
def run(request):
    """JAX and the port on the smoke weights in one layout: the forward with
    and without patches, a prefill of P_LEN tokens after the patches and the
    decode steps to S_LEN, at positions from P + P_LEN."""
    jcfg, tcfg = _cfgs(**VARIANTS[request.param])
    params, model = _model(jcfg, tcfg)
    r = np.random.default_rng(1)
    toks = r.integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)
    patches = _patches(jcfg)
    n_p, total = jcfg.n_patches, jcfg.n_patches + S_LEN
    fwd = jax.jit(lambda p, t, x: JT.forward_seq(p, jcfg, t, patches=x)[0])
    j = {"hidden": np.asarray(fwd(params, jnp.asarray(toks), jnp.asarray(patches))),
         "bare": np.asarray(fwd(params, jnp.asarray(toks), None))}
    logits0, cache = jax.jit(lambda p, t, x: JT.prefill(p, jcfg, t, total, patches=x))(
        params, jnp.asarray(toks[:, :P_LEN]), jnp.asarray(patches))
    j["prefill_logits"], j["cache"], j["decode_logits"] = np.asarray(logits0), _np(cache), []
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    for t in range(P_LEN, S_LEN):
        lg, cache = dec(params, jnp.asarray(toks[:, t]), cache, jnp.int32(n_p + t))
        j["decode_logits"].append(np.asarray(lg))
    j["final_cache"] = _np(cache)
    return dict(variant=request.param, jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                toks=toks, patches=patches, j=j)


def test_forward_seq_matches_jax(run):
    """With patches (P + S positions, the patches first) and without them:
    each against JAX; the patches change the text's hidden states."""
    model, tcfg, toks, j = run["model"], run["tcfg"], run["toks"], run["j"]
    hidden, aux, states = T.forward_seq(model, tcfg, toks, patches=run["patches"])
    assert states is None and float(aux) == 0.0
    assert tuple(hidden.shape) == (2, tcfg.n_patches + S_LEN, tcfg.d_model)
    _close(hidden, j["hidden"], TOL_M, "with patches")
    bare, _, _ = T.forward_seq(model, tcfg, toks)
    assert tuple(bare.shape) == (2, S_LEN, tcfg.d_model)
    _close(bare, j["bare"], TOL_M, "without patches")
    assert (hidden[:, tcfg.n_patches:] - bare).abs().max() > 1e-2


def test_prefill_and_decode_match_jax(run):
    """The prefill's logits and cache (P + P_LEN positions filled, padded to
    P + S_LEN), each decode step's logits at position P + t and the final
    cache, against JAX's."""
    tcfg, model, toks, j = run["tcfg"], run["model"], run["toks"], run["j"]
    n_p = tcfg.n_patches
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], n_p + S_LEN,
                              patches=run["patches"])
    assert all(list(st) == ["kv"] and st["kv"]["k"].shape[1] == n_p + S_LEN for st in cache)
    _close(logits, j["prefill_logits"], TOL_M)
    _close_tree(cache, T.cache_from_jax(j["cache"], tcfg, device="cpu"), TOL_M,
                "prefill cache")
    assert all(float(st["kv"]["k"][:, n_p + P_LEN:].abs().max()) == 0 for st in cache)
    for i, t in enumerate(range(P_LEN, S_LEN)):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, n_p + t)
        _close(logits, j["decode_logits"][i], TOL_M, f"step {t}")
    _close_tree(cache, T.cache_from_jax(j["final_cache"], tcfg, device="cpu"), TOL_M,
                "final cache")


def test_patch_positions_see_no_text(run):
    """Two prompts after the same patches: every layer's K/V at the patch
    positions 0 … P−1 equal bit for bit (the card's check (a)); the text's
    differ.  Appended patches, or a mask that let them see text, fail it."""
    tcfg, model, toks = run["tcfg"], run["model"], run["toks"]
    n_p = tcfg.n_patches
    other = (toks[:, :P_LEN] + 1) % tcfg.vocab_size
    _, c1 = T.prefill(model, tcfg, toks[:, :P_LEN], n_p + P_LEN, patches=run["patches"])
    _, c2 = T.prefill(model, tcfg, other, n_p + P_LEN, patches=run["patches"])
    for i, (a, b) in enumerate(zip(c1, c2)):
        for n in ("k", "v"):
            assert torch.equal(a["kv"][n][:, :n_p], b["kv"][n][:, :n_p]), (i, n)
            assert not torch.equal(a["kv"][n][:, n_p:], b["kv"][n][:, n_p:]), (i, n)


@pytest.mark.parametrize("variant", ["stacked", "flash"])
def test_decode_matches_forward(variant):
    """The port's prefill with patches + token-by-token decode from
    position P + p_len equals its forward with patches over the whole
    sequence, on its own init."""
    _, tcfg = _cfgs(**VARIANTS[variant])
    model = T.init_params(3, tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 20))
    patches = _patches(tcfg, seed=3)
    n_p = tcfg.n_patches
    hidden, _, _ = T.forward_seq(model, tcfg, toks, patches=patches)
    full = L.unembed(model.embed, tcfg, hidden)
    p_len = 12
    logits, cache = T.prefill(model, tcfg, toks[:, :p_len], n_p + 20, patches=patches)
    _close(logits, full[:, n_p + p_len - 1], (1e-4, 1e-4))
    for t in range(p_len, 20):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, n_p + t)
        _close(logits, full[:, n_p + t], (1e-4, 2e-4), f"step {t}")


def test_patches_on_a_config_without_n_patches_are_ignored():
    """``olmo_1b``'s smoke model given patches: the same hidden states and
    loss as without them, as in the reference."""
    jcfg, tcfg = jbase.get_smoke_config("olmo_1b"), C.get_smoke_config("olmo_1b")
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    patches = _patches(dataclasses.replace(jcfg, n_patches=4, patch_dim=8))
    got, _, _ = T.forward_seq(model, tcfg, toks, patches=patches)
    assert torch.equal(got, T.forward_seq(model, tcfg, toks)[0])
    want = jax.jit(lambda p, t, x: JT.forward_seq(p, jcfg, t, patches=x)[0])(
        params, jnp.asarray(toks), jnp.asarray(patches))
    _close(got, want, TOL_M)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _ = T.loss_fn(model, tcfg, dict(batch, patches=patches))
    assert torch.equal(loss, T.loss_fn(model, tcfg, batch)[0])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_fn_value_and_grad_match_jax(remat):
    """``loss_fn`` with ``batch["patches"]`` (the loss over the text
    positions alone) and every gradient, the projector's included, against
    ``jax.value_and_grad``, with a ``loss_mask``; remat on (the stacked
    layers under per-layer checkpoints) and off."""
    jcfg, tcfg = _cfgs(remat=remat)
    params, model = _model(jcfg, tcfg, seed=4)
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24).peek(4)
    assert b["patches"].shape == (2, jcfg.n_patches, jcfg.patch_dim)
    assert b["tokens"].shape == b["labels"].shape == (2, 24 - jcfg.n_patches)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    tl, tm, tg = S.loss_and_grads(model, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    _close(tl, jl, TOL_M)
    _close(tm["xent"], jm["xent"], TOL_M)
    want = T.params_from_jax(_np(jg), tcfg, device="cpu").tree()
    assert list(tg) == list(want) == ["embed", "final_norm", "layers", "mm_projector"]
    assert all(float(tg["mm_projector"][k].abs().max()) > 0 for k in ("w1", "w2"))
    for i, (got, w) in enumerate(zip(tree_leaves(tg), tree_leaves(want))):
        _close(got, w, TOL_M, f"gradient leaf {i}")


def test_train_steps_match_jax():
    """Two ``make_train_step`` steps in both packages from one state, each
    batch with its patches: the metrics and every parameter after each
    step, the projector's among them."""
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
    w1 = tstate["params"].tree()["mm_projector"]["w1"].clone()
    for i in range(2):
        state, jm = jstep(state, jpipe.next_batch())
        tstate, m = step(tstate, pipe.next_batch("cpu"))
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k], TOL_M, f"step {i} {k}")
        want = tree_leaves(T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree())
        for got, w in zip(tree_leaves(tstate["params"].tree()), want):
            _close(got, w, TOL_M, f"params after step {i}")
    assert not torch.equal(tstate["params"].tree()["mm_projector"]["w1"], w1)


def test_train_main_moves_the_projector(tmp_path):
    """``launch/train.py --arch llava_next_mistral_7b --smoke`` on the CPU:
    the pipeline's patches reach the projector, whose weights move from
    their init (seed 0) and whose AdamW moments are nonzero."""
    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2", "--batch",
                      "2", "--seq", "24", "--checkpoint-every", "100", "--log-every", "100",
                      "--ckpt-dir", str(tmp_path / "run")])
    assert out.report.completed and len(out.losses) == 2
    init = T.init_params(0, C.get_smoke_config(ARCH), device="cpu").tree()["mm_projector"]
    proj = out.state["params"].tree()["mm_projector"]
    for k in ("w1", "w2"):
        assert not torch.equal(proj[k], init[k]), k
        assert float(out.state["opt"]["mu"]["mm_projector"][k].abs().max()) > 0, k


# --------------------------------------------------------------------------
# serving with the kNN-LM head
# --------------------------------------------------------------------------

def test_serving_loop_with_patches_matches_jax():
    """The composed loop of the card's phase: ``prefill(patches=)``, then
    greedy steps of ``decode_step_retrieval`` from position P + S with the
    in-step ``Datastore`` (built by a decoder run without patches, as the
    reference builds it), against the same loop in JAX: tokens equal,
    log-probs within the whole-model tolerance."""
    jcfg, tcfg = _cfgs()
    rc = dict(enabled=True, k=4, lam=0.5)
    jcfg = dataclasses.replace(jcfg, retrieval=jbase.RetrievalConfig(**rc))
    tcfg = dataclasses.replace(tcfg, retrieval=C.RetrievalConfig(**rc))
    params, model = _model(jcfg, tcfg, seed=0)
    r = np.random.default_rng(0)
    corpus = r.integers(0, jcfg.vocab_size, (4, 48)).astype(np.int32)
    prompts = corpus[:2, :16]
    patches = _patches(jcfg, seed=9)
    jds = JK.build_datastore(params, jcfg, [jnp.asarray(corpus)])
    ds = K.build_datastore(model, tcfg, [corpus])
    _close(ds.keys, jds.keys, TOL_M)
    n, start = 6, jcfg.n_patches + 16
    jl, jc = JT.prefill(params, jcfg, jnp.asarray(prompts), start + n,
                        patches=jnp.asarray(patches))
    logits, cache = T.prefill(model, tcfg, prompts, start + n, patches=patches)
    _close(logits, jl, TOL_M, "prefill")
    step = jax.jit(lambda p, t, c, pos: JK.decode_step_retrieval(p, jcfg, t, c, pos, jds))
    jtok, tok = jnp.argmax(jl, -1), torch.argmax(logits, -1)
    for i in range(n):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok), f"token {i}")
        jl, jc = step(params, jtok, jc, jnp.int32(start + i))
        logits, cache = K.decode_step_retrieval(model, tcfg, tok, cache, start + i, ds)
        _close(logits, jl, TOL_M, f"step {i}")
        jtok, tok = jnp.argmax(jl, -1), torch.argmax(logits, -1)


# --------------------------------------------------------------------------
# the calls the slot program refused until it carried the projector
# --------------------------------------------------------------------------

def _placed(mesh):
    jcfg, tcfg = _cfgs()
    params, model = _model(jcfg, tcfg)
    _, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], mesh)
    return tcfg, model, S.place(model.tree(), st_sh["params"])


def _built_train(cfg, mesh):
    _, (st, b), (st_sh, b_sh) = S.build_train(cfg, C.SHAPES["train_4k"], mesh)
    assert tuple(b["patches"].shape) == (256, cfg.n_patches, cfg.patch_dim)
    assert tuple(b["tokens"].shape) == (256, 4096 - cfg.n_patches)
    assert b_sh["patches"].spec[0] == "data"
    assert st_sh["params"]["mm_projector"]["w1"].spec[1] == "model"
    assert st_sh["opt"]["nu"]["mm_projector"]["w2"].spec[0] == "model"


def _built_prefill(cfg, mesh):
    _, (p, b), (_, b_sh) = S.build_prefill(cfg, C.SHAPES["prefill_32k"], mesh)
    assert tuple(b["patches"].shape) == (32, cfg.n_patches, cfg.patch_dim)
    assert b_sh["patches"].spec[0] == "data" and "mm_projector" in p


def _built_decode(cfg, mesh):
    _, (p, _, cache, _), _ = S.build_decode(cfg, C.SHAPES["decode_32k"], mesh)
    assert tuple(cache[0]["kv"]["k"].shape)[1] == 32768 and "mm_projector" in p


def _prefill_without_patches(cfg, mesh):
    tcfg, model, params = _placed(mesh)
    toks = np.zeros((1, 4), np.int32)
    got, _ = spmd.prefill(params, tcfg, toks, 8)
    _close(got.gather(), T.prefill(model, tcfg, toks, 8)[0], TOL_M)


def _loss_with_patches(cfg, mesh):
    tcfg, model, params = _placed(mesh)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "patches": _patches(tcfg)}
    _close(spmd.loss_fn(params, tcfg, batch)[0], T.loss_fn(model, tcfg, batch)[0], TOL_M)


REFUSALS = {
    "check_supported": lambda cfg, mesh: spmd.check_supported(cfg),
    "build_train": _built_train,
    "build_prefill": _built_prefill,
    "build_decode": _built_decode,
    "spmd.prefill": _prefill_without_patches,
    "spmd.loss_fn": _loss_with_patches,
}


@pytest.mark.parametrize("what", list(REFUSALS))
def test_slot_program_refuses_llava(what):
    """The calls the slot program refused until it carried the projector
    (ROADMAP queue A item 21c) run on 2 × 2 CPU slots: the builders place
    the patches by ``act_batch`` and the projector's d_model over "model";
    a prefill without patches and ``loss_fn`` with them match the
    one-device functions; ``tests/test_torch_vlm_sharded.py`` holds the
    slot program to JAX."""
    REFUSALS[what](C.get_smoke_config(ARCH), make_host_mesh(2, slots=4, device="cpu"))


def _weight_bytes(cfg, model=16):
    """llava's float32 weights a slot of the (16, 16) pod: split 16 ways but
    the norm scales and the 8 KV heads' ``wk`` / ``wv``, which do not
    divide 16."""
    d, f, v, hd = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.hd
    layer = 2 * d + (2 * d * cfg.n_heads * hd + 3 * d * f) // model + 2 * d * cfg.n_kv_heads * hd
    proj = (cfg.patch_dim * d + d * d) // model
    return 4 * (2 * v * d // model + cfg.n_layers * layer + d + proj)


def test_dryrun_records_llava_as_refused_by_the_slot_program():
    """llava's decode and prefill cells on the (16, 16) pod trace; the
    per-slot argument bytes equal a hand count: the weights (the projector
    included), in decode the KV cache by position (8 KV heads do not split
    16 ways: 2,048 positions a slot) and the tokens, in prefill the slot's
    2 rows of text tokens (int64) and of patches (float32)."""
    cfg = C.get_config(ARCH)
    rec = dryrun.run_cell(ARCH, "decode_32k", multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    rows = 128 // 16
    kv = cfg.n_layers * 2 * rows * (32768 // 16) * cfg.n_kv_heads * cfg.hd * 2
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _weight_bytes(cfg) + kv + rows * 8 + 4
    rec = dryrun.run_cell(ARCH, "prefill_32k", multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    rows = 32 // 16
    assert rec["memory_analysis"]["argument_size_in_bytes"] == _weight_bytes(cfg) + \
        rows * (32768 - cfg.n_patches) * 8 + rows * cfg.n_patches * cfg.patch_dim * 4
