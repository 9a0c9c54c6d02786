"""The port's MoE layer (``repro_torch.models.layers``: ``moe_table``,
``init_moe``, ``_moe_cap``, ``_moe_dispatch``, ``apply_moe``), the
``granite_moe_1b_a400m`` and ``qwen3_moe_235b_a22b`` presets and the
transformer paths that run them, held to the JAX package on the same numpy
inputs.

Single layers on ``init_moe`` weights from a JAX key and seeded random
tokens; whole models on the JAX ``init_params`` weights carried across with
``params_from_jax`` at each preset's ``smoke_config()`` (granite: 3
unstacked layers, 4 experts top-2; qwen3_moe: 3 scanned layers, 8 experts
top-2, qk-norm), a 19-token prompt and 5 decode steps.  The capacity
matters: at the published factor 1.25 a forward over the whole sequence
may drop assignments that a one-token decode never drops, so the layer is
also held where the reference drops (factor 0.5) and at factor 16 (nothing
dropped), and decode against forward only at 16, as
``tests/test_models.py:85-93`` does.  Each JAX reference is computed once per
module.

Tolerances (``tests/test_torch_recurrent.py``'s).  float32 single
functions: 1e-5 relative and absolute.  float32 whole models (hidden
states, aux, logits, caches, gradients, train steps): 1e-4 relative, 2e-4
absolute.  bfloat16, an attention + MoE block against the reference run op
by op: ``TOL_BF16``, one bf16 ulp (2^-7), on under 1 % of the entries, as
the packages' float32 softmax differ in the last bit now and then and may
flip a gate's bf16 rounding; with the reference's softmax in the router,
bit for bit."""
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
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import knn_lm as K
from repro_torch.models import layers as L
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.sharding import ShardingCtx
from repro_torch.utils import tree_leaves

TOL_F = (1e-5, 1e-5)               # single functions, float32
TOL_M = (1e-4, 2e-4)               # whole models, float32
TOL_BF16 = (2.0 ** -7, 2.0 ** -7)  # bfloat16 activations
ARCHS = ("granite_moe_1b_a400m", "qwen3_moe_235b_a22b")
P_LEN, S_LEN = 19, 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capacity(cfg, factor):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _cfgs(arch, factor=None, **over):
    j = dataclasses.replace(jbase.get_smoke_config(arch), **over)
    t = dataclasses.replace(C.get_smoke_config(arch), **over)
    if factor is not None:
        j, t = _capacity(j, factor), _capacity(t, factor)
    return j, t


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


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(_f32(a)).to(dtype), tree)


def _dropped(jcfg, params, x):
    """The reference's count of dropped top-k assignments of one MoE layer
    on x (B, S, D), from its own router and ``_moe_cap``."""
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, params["router"]).astype(jnp.float32))
    eidx = np.asarray(jax.lax.top_k(probs, jcfg.moe.top_k)[1])
    counts = np.bincount(eidx.reshape(-1), minlength=jcfg.moe.n_experts)
    return int(np.maximum(counts - JL._moe_cap(jcfg, xt.shape[0]), 0).sum())


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_cap_matches_jax(arch):
    for get in ("get_config", "get_smoke_config"):
        jcfg, tcfg = getattr(jbase, get)(arch), getattr(C, get)(arch)
        for factor in (0.5, 1.25, 16.0):
            j, t = _capacity(jcfg, factor), _capacity(tcfg, factor)
            for n in list(range(1, 300)) + [1024, 1040, 2048, 4096, 32768, 1 << 20]:
                assert L._moe_cap(t, n) == JL._moe_cap(j, n), (get, factor, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_table_and_init_match_jax(arch):
    """``moe_table``'s shapes and axes are the reference ``init_moe``'s specs
    (smoke and full, the full one from shapes alone); ``init_moe`` draws
    those shapes in the parameter dtype with the reference's scales; the
    full presets' ``param_shapes`` count the reference's parameters:
    ``n_params()`` and the norm (and qk-norm) scales it leaves out."""
    for get in ("get_config", "get_smoke_config"):
        jcfg, tcfg = getattr(jbase, get)(arch), getattr(C, get)(arch)
        box = {}

        def capture(key):
            p, box["s"] = JL.init_moe(key, jcfg, jnp.float32)
            return p

        shapes = jax.eval_shape(capture, jax.random.PRNGKey(0))
        table = L.moe_table(tcfg)
        assert list(table) == ["router", "w_gate", "w_up", "w_down"]
        assert {k: (tuple(shp), tuple(ax)) for k, (shp, ax) in table.items()} == \
            {k: (tuple(shapes[k].shape), tuple(box["s"][k])) for k in shapes}
    tcfg = C.get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(gen, tcfg, torch.bfloat16, device="cpu")
    d, f = tcfg.d_model, tcfg.moe.d_expert
    for k, fan_in in (("router", d), ("w_gate", d), ("w_up", d), ("w_down", f)):
        assert p[k].dtype == torch.bfloat16 and tuple(p[k].shape) == L.moe_table(tcfg)[k][0]
        assert abs(p[k].float().std().item() * fan_in ** 0.5 - 1.0) < 0.1, k
    full = C.get_config(arch)
    n = sum(t.numel() for t in tree_leaves(T.param_shapes(full)))
    scales = (2 * full.n_layers + 1) * full.d_model + full.qk_norm * 2 * full.n_layers * full.hd
    assert n == full.n_params() + scales
    j_shapes, _ = JS.params_specs(jbase.get_config(arch))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_shapes))


def test_top_k_breaks_ties_as_jax():
    """``_top_k`` is ``jax.lax.top_k``: a tie goes to the lower index
    (``torch.topk`` returns [2, 4, 1] on the first row)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]], np.float32)
    vals, idx = L._top_k(torch.tensor(probs), 3)
    assert idx.tolist() == [[1, 2, 4]] == np.asarray(jax.lax.top_k(probs, 3)[1]).tolist()
    r = np.random.default_rng(0)
    many = (r.integers(0, 4, (200, 32)) / 8.0).astype(np.float32)     # ties everywhere
    for k in (1, 2, 8, 9, 32):
        jv, ji = jax.lax.top_k(many, k)
        tv, ti = L._top_k(torch.tensor(many), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _layer_case(arch, factor, dtype=jnp.float32, seed=1, rows=48):
    jcfg, tcfg = _cfgs(arch, factor)
    p, _ = JL.init_moe(jax.random.PRNGKey(seed), jcfg, dtype)
    x = np.random.default_rng(seed).normal(size=(2, rows // 2, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, x


@pytest.mark.parametrize("factor", [0.5, 16.0], ids=["drops", "cap16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, factor):
    """float32 output and aux against the reference where it drops
    assignments (factor 0.5) and where it drops none (16)."""
    jcfg, tcfg, p, x = _layer_case(arch, factor)
    n_drop = _dropped(jcfg, p, x)
    assert (n_drop > 0) if factor < 1 else (n_drop == 0)
    jo, ja = jax.jit(lambda p, x: JL.apply_moe(p, jcfg, x))(p, jnp.asarray(x))
    to, ta = L.apply_moe(_t(p), tcfg, torch.tensor(x))
    assert ta.dtype == torch.float32 and to.dtype == torch.float32
    _close(to, jo, TOL_F)
    _close(ta, ja, TOL_F)


def test_router_ties_match_jax():
    """Exact ties in the router's probabilities (duplicated router columns;
    inputs and router on a dyadic grid, so every logit is exact in float32
    and equal columns give equal probabilities): the experts chosen, the
    aux and the output equal the reference's.  Each expert has its own
    weights, so a tie broken the other way moves the output."""
    jcfg, tcfg, p, x = _layer_case("granite_moe_1b_a400m", 1.25, seed=4)
    e = jcfg.moe.n_experts
    r = np.random.default_rng(4)
    x = (r.integers(-4, 5, x.shape) / 4.0).astype(np.float32)
    router = (r.integers(-2, 3, (jcfg.d_model, e)) / 8.0).astype(np.float32)
    router[:, 2] = router[:, 3] = router[:, 1]                        # experts 1, 2, 3 tie
    p = dict(_np(p), router=router)
    xt = x.reshape(-1, jcfg.d_model)
    jprobs = jax.nn.softmax(jnp.einsum("td,de->te", xt, router).astype(jnp.float32))
    tprobs = torch.softmax((torch.tensor(xt) @ torch.tensor(router)).float(), dim=-1)
    for c in (2, 3):
        np.testing.assert_array_equal(tprobs.numpy()[:, 1], tprobs.numpy()[:, c])
        np.testing.assert_array_equal(np.asarray(jprobs)[:, 1], np.asarray(jprobs)[:, c])
    # The trio on top: top-2 keeps experts 1 and 2 and drops 3 at an exact tie.
    on_top = np.asarray(jprobs)[:, 1] > np.asarray(jprobs)[:, 0]
    assert 0.2 < on_top.mean() < 0.8
    jv, ji = jax.lax.top_k(jprobs, jcfg.moe.top_k)
    tv, ti = L._top_k(tprobs, tcfg.moe.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti.numpy()[on_top] == [1, 2]).all()
    jo, ja = JL.apply_moe(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    to, ta = L.apply_moe(_t(p), tcfg, torch.tensor(x))
    _close(to, jo, TOL_F)
    _close(ta, ja, TOL_F)


@pytest.mark.parametrize("arch", ARCHS[:1])
def test_block_bf16_matches_jax(arch, monkeypatch):
    """One attention + MoE block on bfloat16 weights and activations, with
    its KV collected, against the reference run op by op.  The two
    packages' float32 softmax (their exponentials) differ in the last bit
    now and then, which may flip a gate's bf16 rounding: the output is
    within one bf16 ulp (``TOL_BF16``) on under 1 % of the entries and equal
    elsewhere.  With the reference's softmax in the port's router (the
    logits are bit-identical) the block's output is bit for bit the
    reference's: the dispatch, the expert products and the combine's order
    of adds.  The float32 aux (a mean over tokens, summed in another order)
    is within the float32 bound."""
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
    jp, _ = JT._init_layer(jax.random.PRNGKey(9), jcfg, "attn", jnp.bfloat16, cross=False)
    x = np.random.default_rng(9).normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    with jax.disable_jit():
        want, jaux, jst = JT._apply_layer_seq(jp, jcfg, "attn", jnp.asarray(x, jnp.bfloat16),
                                              JT.null_ctx(), cache_len=32, collect=True)
    tp, tx = _t(jp, torch.bfloat16), torch.tensor(x).bfloat16()
    got, aux, st = T._apply_layer_seq(tp, tcfg, "attn", tx, cache_len=32, collect=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, TOL_BF16)
    assert (_f32(got) != _f32(want)).mean() < 0.01
    for g, w in zip(tree_leaves(st), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(_f32(g), _f32(w))
    _close(aux, jaux, TOL_F)

    def jax_softmax(params, xt):
        logits = (xt @ params["router"]).float()
        return torch.tensor(np.asarray(jax.nn.softmax(jnp.asarray(logits.numpy()), axis=-1)))

    monkeypatch.setattr(L, "_router_probs", jax_softmax)
    with jax.disable_jit():
        got, aux, _ = T._apply_layer_seq(tp, tcfg, "attn", tx, cache_len=32, collect=True)
    np.testing.assert_array_equal(_f32(got), _f32(want))


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, f) for a in ARCHS for f in (1.25, 16.0)],
                ids=lambda p: f"{p[0].split('_')[0]}-cap{p[1]:g}")
def run(request):
    """JAX and the port on one preset's smoke weights at one capacity: the
    forward (hidden, aux), a prefill of P_LEN tokens and the decode steps
    to S_LEN."""
    arch, factor = request.param
    jcfg, tcfg = _cfgs(arch, factor)
    params, _ = JT.init_params(jax.random.PRNGKey(1), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)
    hidden, aux, _ = jax.jit(lambda p, t: JT.forward_seq(p, jcfg, t))(params, jnp.asarray(toks))
    logits0, cache = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, S_LEN))(
        params, jnp.asarray(toks[:, :P_LEN]))
    j = {"hidden": np.asarray(hidden), "aux": float(aux), "prefill_logits": np.asarray(logits0),
         "cache": _np(cache), "decode_logits": []}
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    for t in range(P_LEN, S_LEN):
        lg, cache = dec(params, jnp.asarray(toks[:, t]), cache, jnp.int32(t))
        j["decode_logits"].append(np.asarray(lg))
    j["final_cache"] = _np(cache)
    return dict(arch=arch, factor=factor, jcfg=jcfg, tcfg=tcfg, params=params, model=model,
                toks=toks, j=j)


def test_layer_plans(run):
    """granite's smoke model is unstacked, qwen3_moe's scanned; both carry an
    ``moe`` sublayer in every layer, the (e, d, f) leaves unstacked."""
    tcfg, model, params = run["tcfg"], run["model"], run["params"]
    plan = T.layer_plan(tcfg)
    assert plan.n_groups == (0 if run["arch"].startswith("granite") else 3)
    assert (len(params["blocks"]), len(params["rem"])) == \
        ((0, 3) if plan.n_groups == 0 else (1, 0))
    e, d, f = tcfg.moe.n_experts, tcfg.d_model, tcfg.moe.d_expert
    for blk in model.layers:
        assert "moe" in blk.sublayers and "mlp" not in blk.sublayers
        assert tuple(blk.moe["w_gate"].shape) == (e, d, f)
        assert tuple(blk.moe["w_down"].shape) == (e, f, d)


def test_forward_seq_matches_jax(run):
    hidden, aux, states = T.forward_seq(run["model"], run["tcfg"], run["toks"])
    assert states is None and aux.dtype == torch.float32 and float(aux) > 0
    _close(hidden, run["j"]["hidden"], TOL_M)
    _close(aux, run["j"]["aux"], TOL_M)


def test_prefill_and_decode_match_jax(run):
    """The prefill's logits and cache, each decode step's logits and the
    final cache, against JAX's."""
    tcfg, model, toks, j = run["tcfg"], run["model"], run["toks"], run["j"]
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    _close(logits, j["prefill_logits"], TOL_M)
    _close_tree(cache, T.cache_from_jax(j["cache"], tcfg, device="cpu"), TOL_M, "prefill cache")
    for i, t in enumerate(range(P_LEN, S_LEN)):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, j["decode_logits"][i], TOL_M, f"step {t}")
    _close_tree(cache, T.cache_from_jax(j["final_cache"], tcfg, device="cpu"), TOL_M,
                "final cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's prefill + token-by-token decode equals its forward over the
    whole sequence at capacity 16, where neither drops an assignment (at
    the published capacity a forward over the whole sequence may drop what
    a one-token decode keeps), on the port's own init."""
    _, tcfg = _cfgs(arch, 16.0)
    model = T.init_params(3, tcfg, device="cpu")
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, S_LEN))
    hidden, _, _ = T.forward_seq(model, tcfg, toks)
    full = L.unembed(model.embed, tcfg, hidden)
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    steps = [logits]
    for t in range(P_LEN, S_LEN):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        steps.append(logits)
    _close(torch.stack(steps, 1), full[:, P_LEN - 1:], TOL_M)


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

TRAIN_CASES = {"qwen3_moe": ("qwen3_moe_235b_a22b", {}),
               "granite-scanned-dots": ("granite_moe_1b_a400m",
                                        dict(scan_layers=True, remat_policy="dots"))}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_loss_fn_value_and_grad_match_jax(case):
    """``loss_fn`` (xent + 0.01 · aux) and every gradient, the router's
    included, against ``jax.value_and_grad`` at the published capacity,
    with a ``loss_mask``; remat on: every layer runs under a per-layer
    checkpoint that returns the aux beside x (qwen3_moe's smoke model is
    scanned; granite's, unstacked, is scanned here, with the "dots"
    policy; its unstacked layers train in ``test_train_steps_match_jax``)."""
    arch, over = TRAIN_CASES[case]
    jcfg, tcfg = _cfgs(arch, **over)
    assert tcfg.remat
    params, _ = JT.init_params(jax.random.PRNGKey(4), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24).peek(4)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    tl, tm, tg = S.loss_and_grads(model, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    assert float(tm["moe_aux"]) > 0
    _close(tl, jl, TOL_M)
    _close(tm["xent"], jm["xent"], TOL_M)
    _close(tm["moe_aux"], jm["moe_aux"], TOL_M)
    want = T.params_from_jax(_np(jg), tcfg, device="cpu").tree()
    assert any(float(g["moe"]["router"].abs().max()) > 0 for g in tg["layers"])
    for i, (got, w) in enumerate(zip(tree_leaves(tg), tree_leaves(want))):
        _close(got, w, TOL_M, f"gradient leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Two ``make_train_step`` steps in both packages from one state: the
    metrics (``moe_aux`` among them) and every parameter after each step."""
    jcfg, tcfg = _cfgs(arch)
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
        assert float(m["moe_aux"]) > 0
        for k in ("loss", "grad_norm", "lr", "moe_aux"):
            _close(m[k], jm[k], TOL_M, f"step {i} {k}")
        want = tree_leaves(T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree())
        for got, w in zip(tree_leaves(tstate["params"].tree()), want):
            _close(got, w, TOL_M, f"params after step {i}")


def test_decode_step_retrieval_matches_jax():
    """The kNN-LM head over the granite smoke model: the datastore, then
    three retrieval decode steps from the JAX prefill's cache."""
    jcfg, tcfg = _cfgs("granite_moe_1b_a400m")
    jcfg = dataclasses.replace(jcfg, retrieval=jbase.RetrievalConfig(enabled=True, k=4, lam=0.5))
    tcfg = dataclasses.replace(tcfg, retrieval=C.RetrievalConfig(enabled=True, k=4, lam=0.5))
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    corpus = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 48)).astype(np.int32)
    jds = JK.build_datastore(params, jcfg, [jnp.asarray(corpus)])
    ds = K.build_datastore(model, tcfg, [corpus])
    assert ds.size == 4 * 47 and tuple(ds.keys.shape) == (188, jcfg.d_model)
    _close(ds.keys, jds.keys, TOL_M)
    _, jcache = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, 30))(params,
                                                                  jnp.asarray(corpus[:, :20]))
    cache = T.cache_from_jax(_np(jcache), tcfg, device="cpu")
    step = jax.jit(lambda p, t, c, pos: JK.decode_step_retrieval(p, jcfg, t, c, pos, jds))
    for t in range(20, 23):
        want, jcache = step(params, jnp.asarray(corpus[:, t]), jcache, jnp.int32(t))
        got, cache = K.decode_step_retrieval(model, tcfg, corpus[:, t], cache, t, ds)
        _close(got, want, TOL_M, f"step {t}")


# --------------------------------------------------------------------------
# presets, the slot program's entry points, the dispatch's choice
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_presets_are_the_reference_presets(arch):
    """The configs, the analytic counts, every parameter's logical axes, and
    the smoke model's parameter count."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(C, get)(arch)) == \
            dataclasses.asdict(getattr(jbase, get)(arch)), get
    jcfg, tcfg = jbase.get_config(arch), C.get_config(arch)
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()
    assert C.applicable_shapes(tcfg) == jbase.applicable_shapes(jcfg)
    assert arch in C.PORTED_ARCHS
    _, j_specs = JS.params_specs(jcfg)
    t_specs = T.param_specs(tcfg)
    for i, (_, src) in enumerate(T._layer_sources(tcfg)):
        want = j_specs["rem"][src[1]] if src[0] == "rem" else j_specs["blocks"][src[1]]
        drop = int(src[0] == "blocks")
        want = jax.tree.map(lambda s: tuple(s)[drop:], want, is_leaf=lambda s: isinstance(s, tuple))
        assert t_specs["layers"][i] == want, i
    smoke = C.get_smoke_config(arch)
    model = T.init_params(0, smoke, device="cpu")
    jp, _ = JT.init_params(jax.random.PRNGKey(0), jbase.get_smoke_config(arch))
    assert sum(p.numel() for p in model.parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jp))


def _placed_smoke():
    cfg = C.get_smoke_config("granite_moe_1b_a400m")
    mesh = make_host_mesh(2, slots=4, device="cpu")
    return cfg, mesh


ENTRY_POINTS = ("spmd.loss_fn", "spmd.prefill", "spmd.decode_step", "build_train",
                "build_prefill", "build_decode")


@pytest.mark.parametrize("what", ENTRY_POINTS)
def test_slot_program_runs_moe(what):
    """Each entry point of the slot program runs granite's smoke model on 2 ×
    2 CPU slots (2 experts a slot): the shapes its callers expect, finite
    values, ``moe_aux`` above 0 where a loss is taken.  The values are held
    to the JAX package in ``tests/test_torch_moe_sharded.py``."""
    cfg, mesh = _placed_smoke()
    b, s = 2, 8
    model = T.init_params(0, cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s + 1)))
    opt = O.OptConfig(total_steps=2, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)
    step, _, (st_sh, _) = S.build_train(cfg, C.ShapeConfig("t", "train", s, b), mesh, opt)
    params = S.place(model.tree(), st_sh["params"])
    if what in ("spmd.loss_fn", "build_train"):
        batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
        if what == "spmd.loss_fn":
            loss, m = spmd.loss_fn(params, cfg, batch)
            vals = [loss, m["xent"]]
        else:
            state, m = step(S.init_placed_state(model.tree(), opt, st_sh), batch)
            loss = m["loss"]
            vals = [loss, m["grad_norm"]] + [a.gather() for a in tree_leaves(state["params"])]
        assert loss.shape == () and float(m["moe_aux"]) > 0
    else:
        fn, _, (p_sh, b_sh) = S.build_prefill(cfg, C.ShapeConfig("p", "prefill", s + 1, b), mesh)
        if what == "build_prefill":
            logits, cache = fn(params, S.place({"tokens": toks[:, :s]}, b_sh))
        else:
            logits, cache = spmd.prefill(params, cfg, toks[:, :s], s + 1)
        if what.endswith("decode_step"):
            logits, cache = spmd.decode_step(params, cfg, toks[:, s], cache, s)
        elif what == "build_decode":
            dec, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
                cfg, C.ShapeConfig("d", "decode", s + 1, b), mesh)
            placed = S.place(T.init_cache(cfg, b, s + 1, device="cpu"), c_sh)
            logits, cache = dec(params, tok_sh.place(toks[:, s]), placed,
                                pos_sh.place(torch.tensor(s, dtype=torch.int32)))
        assert logits.shape == (b, cfg.vocab_size) and len(cache) == cfg.n_layers
        vals = [logits.gather()] + [a.gather() for a in tree_leaves(cache)]
    assert all(bool(torch.isfinite(v).all()) for v in vals)


GLOBAL_PATHS = {"odd_tokens": (2, True, (1, 3)), "one_data_slot": (1, True, (2, 3)),
                "option_off": (2, False, (2, 3))}


@pytest.mark.parametrize("case", list(GLOBAL_PATHS))
def test_sharded_dispatch_takes_the_global_path_where_the_reference_does(case):
    """``moe_sharded_dispatch`` cuts the tokens into one buffer a data slot
    only where the reference's ``apply_moe`` does: an odd token count on 2
    data slots, one data slot, or the option off take the global dispatch,
    bit for bit the layer without a mesh (through ``apply_moe`` and
    ``forward_seq``'s ``shd``)."""
    n_data, on, shape = GLOBAL_PATHS[case]
    cfg = dataclasses.replace(C.get_smoke_config("granite_moe_1b_a400m"), moe_sharded_dispatch=on)
    shd = ShardingCtx.for_mesh(make_host_mesh(1, slots=n_data, device="cpu"))
    assert L.moe_chunks(cfg, shape[0] * shape[1], n_data) == 1
    p = L.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32, device="cpu")
    x = torch.randn(*shape, cfg.d_model, generator=torch.Generator().manual_seed(1))
    for got, want in zip(L.apply_moe(p, cfg, x, shd), L.apply_moe(p, cfg, x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    model = T.init_params(0, cfg, device="cpu")
    toks = np.zeros(shape, np.int64)
    for got, want in zip(T.forward_seq(model, cfg, toks, shd)[:2],
                         T.forward_seq(model, cfg, toks)[:2]):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
