"""The port's recurrent mixers (``repro_torch.models.{rglru,rwkv6}``), the
``rwkv6_3b`` and ``recurrentgemma_9b`` presets and the transformer paths
that run them, held to the JAX package on the same numpy inputs.

Single functions on seeded random inputs and states (the gates' weights
and biases, Λ, the decay and the bonus perturbed off their init values);
whole models on the JAX ``init_params`` weights carried across with
``params_from_jax`` at each preset's ``smoke_config()`` (``rwkv6_3b``: 3
scanned layers; ``recurrentgemma_9b``: 8 = 2 × (rglru, rglru, local) + 2
unstacked rglru layers, window 16), with a 19-token prompt (the local ring
wraps; 19 is no multiple of ``rnn_chunk`` 16) and 5 decode steps.  Each
JAX reference is computed once per module.

Tolerances.  float32 single functions: 1e-5 relative and absolute.
float32 whole models (hidden states, logits, caches, gradients, train
steps): ``tests/test_models.py:82-110``'s 1e-4 relative, 2e-4 absolute
(the recurrences sum in another order: XLA's scan against the port's
loop of fused multiply-adds).  bfloat16 activations: 2^-7 relative and
absolute, ``test_layers_bf16_match_jax``'s bound for the layers that do
not match bit for bit (one bf16 ulp), on single blocks and the 3-layer
rwkv6_3b; the JAX side runs op by op.  The two packages' float32
exponentials differ in their last bits, which now and then flips a bf16
rounding of the softmax (1 of 3,072 entries of a local layer's attention
output here); over recurrentgemma's 8 layers such flips compound past one
ulp (0.0164 on 11 of 768 hidden entries), so its whole-model bf16 case
takes ``tests/test_torch_models.py``'s bound for two rounding orders,
2^-4."""
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
from repro.models import rglru as JR
from repro.models import rwkv6 as JW
from repro.models import transformer as JT
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.models import knn_lm as K
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import rwkv6 as W
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves

TOL_F = (1e-5, 1e-5)               # single functions, float32
TOL_M = (1e-4, 2e-4)               # whole models, float32
TOL_BF16 = (2.0 ** -7, 2.0 ** -7)  # bfloat16 activations
TOL_BF16_PATHS = (2.0 ** -4, 2.0 ** -4)   # bf16, flips compounded over 8 layers
ARCHS = ("rwkv6_3b", "recurrentgemma_9b")
P_LEN, S_LEN = 19, 24


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **over):
    return (dataclasses.replace(jbase.get_smoke_config(arch), **over),
            dataclasses.replace(C.get_smoke_config(arch), **over))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol[0], atol=tol[1], err_msg=what)


def _t(tree):
    """A numpy / JAX tree as float32-or-int tensors (a copy)."""
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close_tree(got, want, tol, what=""):
    """Two trees of the port's layout, leaf by leaf."""
    g, w = tree_leaves(got), tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(np.shape(b)), (what, i)
        _close(a, b, tol, f"{what} leaf {i}")


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def _rglru_setup(seed=0):
    _, tcfg = _cfgs("recurrentgemma_9b")
    jcfg = jbase.get_smoke_config("recurrentgemma_9b")
    p, _ = JR.init_rglru(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = _np(p)
    r = np.random.default_rng(seed)
    rd = jcfg.rnn_d
    for name, (lo, hi) in {"lam": (-1.0, 1.0), "w_i": (0.5, 1.5), "b_i": (-0.5, 0.5),
                           "w_a": (0.5, 1.5), "b_a": (-0.5, 0.5)}.items():
        p[name] = r.uniform(lo, hi, rd).astype(np.float32)
    state = {"h": r.normal(size=(2, rd)).astype(np.float32),
             "conv": r.normal(size=(2, jcfg.conv_width - 1, rd)).astype(np.float32)}
    return jcfg, tcfg, p, state, r


def test_causal_conv_with_carry_matches_jax():
    r = np.random.default_rng(1)
    x, w, carry = (r.normal(size=s).astype(np.float32) for s in ((2, 11, 8), (4, 8), (2, 3, 8)))
    jo, jc = JR._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(carry))
    to, tc = R._causal_conv(torch.tensor(x), torch.tensor(w), torch.tensor(carry))
    _close(to, jo, TOL_F)
    _close(tc, jc, TOL_F)


def test_gates_match_jax():
    jcfg, tcfg, p, _, r = _rglru_setup(2)
    xt = (2.0 * r.normal(size=(2, 7, jcfg.rnn_d))).astype(np.float32)
    ji, ja = JR._gates(jax.tree.map(jnp.asarray, p), jnp.asarray(xt))
    ti, ta = R._gates(_t(p), torch.tensor(xt))
    assert ti.dtype == ta.dtype == torch.float32
    _close(ti, ji, TOL_F)
    _close(ta, ja, TOL_F)


@pytest.mark.parametrize("s", [37, 1], ids=["ragged", "one"])
def test_rglru_forward_matches_jax(s):
    """37 tokens in chunks of 16 (the last padded in the reference), from a
    nonzero state; and one token, ``rglru_decode``."""
    jcfg, tcfg, p, state, r = _rglru_setup(3)
    x = r.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jfn = JR.rglru_forward if s > 1 else JR.rglru_decode
    tfn = R.rglru_forward if s > 1 else R.rglru_decode
    jo, jst = jfn(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                  jax.tree.map(jnp.asarray, state))
    to, tst = tfn(_t(p), tcfg, torch.tensor(x), _t(state))
    _close(to, jo, TOL_F)
    assert tst["h"].dtype == torch.float32 and tst["conv"].dtype == torch.float32
    _close(tst["h"], jst["h"], TOL_F)
    _close(tst["conv"], jst["conv"], TOL_F)


def test_rglru_decode_steps_match_forward():
    """Token by token from the zero state equals the sequence forward."""
    jcfg, tcfg, p, _, r = _rglru_setup(4)
    x = torch.tensor(r.normal(size=(2, 6, jcfg.d_model)).astype(np.float32))
    full, fst = R.rglru_forward(_t(p), tcfg, x)
    st = R.init_rglru_state(tcfg, 2, torch.float32, device="cpu")
    outs = []
    for t in range(6):
        o, st = R.rglru_decode(_t(p), tcfg, x[:, t:t + 1], st)
        outs.append(o)
    _close(torch.cat(outs, 1), full, TOL_F)
    _close(st["h"], fst["h"], TOL_F)


# --------------------------------------------------------------------------
# RWKV-6
# --------------------------------------------------------------------------

def _rwkv_setup(seed=0):
    _, tcfg = _cfgs("rwkv6_3b")
    jcfg = jbase.get_smoke_config("rwkv6_3b")
    p, _ = JW.init_rwkv(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = _np(p)
    r = np.random.default_rng(seed)
    d, hd = jcfg.d_model, jcfg.rnn_head_dim
    p["u"] = (0.5 * r.normal(size=p["u"].shape)).astype(np.float32)
    p["w0"] = r.uniform(-3.0, -0.5, d).astype(np.float32)
    for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "cm_mu_k", "cm_mu_r"):
        p[name] = r.uniform(0.1, 0.9, d).astype(np.float32)
    for name in ("ln_scale", "ln1", "ln2"):
        p[name] = r.uniform(0.5, 1.5, d).astype(np.float32)
    state = {"wkv": r.normal(size=(2, d // hd, hd, hd)).astype(np.float32),
             "shift_tm": r.normal(size=(2, d)).astype(np.float32),
             "shift_cm": r.normal(size=(2, d)).astype(np.float32)}
    return jcfg, tcfg, p, state, r


def test_rms_and_group_norm_match_jax():
    r = np.random.default_rng(5)
    x = (3.0 * r.normal(size=(2, 5, 64)) + 0.5).astype(np.float32)
    scale = r.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(W._rms(torch.tensor(x), torch.tensor(scale)),
           JW._rms(jnp.asarray(x), jnp.asarray(scale)), TOL_F)
    _close(W._group_norm(torch.tensor(x), torch.tensor(scale), 4),
           JW._group_norm(jnp.asarray(x), jnp.asarray(scale), 4), TOL_F)


def test_wkv_scan_matches_jax():
    r = np.random.default_rng(6)
    b, s, h, hd = 2, 9, 3, 8
    rr, k, v = (r.normal(size=(b, s, h, hd)).astype(np.float32) for _ in range(3))
    w = r.uniform(0.2, 1.0, (b, s, h, hd)).astype(np.float32)
    u = r.normal(size=(h, hd)).astype(np.float32)
    s0 = r.normal(size=(b, h, hd, hd)).astype(np.float32)
    jy, js = JW._wkv_scan(*map(jnp.asarray, (rr, k, v, w, u, s0)))
    ty, ts = W._wkv_scan(*map(torch.tensor, (rr, k, v, w, u, s0)))
    _close(ty, jy, TOL_F)
    _close(ts, js, TOL_F)


@pytest.mark.parametrize("s", [37, 1], ids=["ragged", "one"])
def test_rwkv_forward_matches_jax(s):
    """37 tokens in chunks of 16 (the last padded in the reference), from a
    nonzero state; and one token, ``rwkv_decode``."""
    jcfg, tcfg, p, state, r = _rwkv_setup(7)
    x = r.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    jfn = JW.rwkv_forward if s > 1 else JW.rwkv_decode
    tfn = W.rwkv_forward if s > 1 else W.rwkv_decode
    jo, jst = jfn(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                  jax.tree.map(jnp.asarray, state))
    to, tst = tfn(_t(p), tcfg, torch.tensor(x), _t(state))
    _close(to, jo, TOL_F)
    for name in ("wkv", "shift_tm", "shift_cm"):
        _close(tst[name], jst[name], TOL_F, name)


def test_rwkv_shift_states_hold_the_normed_inputs():
    """``shift_tm`` / ``shift_cm`` are the last token of the normed inputs
    (not of x), and the block adds its own residuals."""
    jcfg, tcfg, p, _, r = _rwkv_setup(8)
    x = torch.tensor(r.normal(size=(2, 5, jcfg.d_model)).astype(np.float32))
    out, st = W.rwkv_forward(_t(p), tcfg, x)
    _close(st["shift_tm"], W._rms(x, torch.tensor(p["ln1"]))[:, -1], TOL_F)
    assert not torch.allclose(st["shift_tm"], x[:, -1])
    zero = {k: np.zeros_like(v) for k, v in p.items()}
    zero.update(ln1=p["ln1"], ln2=p["ln2"], ln_scale=p["ln_scale"])
    same, _ = W.rwkv_forward(_t(zero), tcfg, x)       # every projection 0: out = x
    _close(same, x, TOL_F)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rglru", "local", "rwkv"])
def test_blocks_bf16_match_jax(kind):
    """One block of each kind on bfloat16 weights and activations (the
    card's dtypes; recurrentgemma's local layer is MQA), from a nonzero
    state, against the reference run op by op:
    ``test_layers_bf16_match_jax``'s criterion, within one bf16 ulp (2^-7)
    on under 1 % of the entries and equal elsewhere; the float32 recurrent
    states within the float32 bound."""
    arch = "rwkv6_3b" if kind == "rwkv" else "recurrentgemma_9b"
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", param_dtype="bfloat16")
    jp, _ = JT._init_layer(jax.random.PRNGKey(9), jcfg, kind, jnp.bfloat16, cross=False)
    r = np.random.default_rng(9)
    x = r.normal(size=(2, 21, jcfg.d_model)).astype(np.float32)
    st = JT._layer_state_shape(jcfg, kind, 2, 32, jnp.bfloat16, cross=False)
    st = jax.tree.map(lambda a: jnp.asarray(r.normal(size=a.shape), a.dtype), st)
    with jax.disable_jit():
        want, _, jst = JT._apply_layer_seq(jp, jcfg, kind, jnp.asarray(x, jnp.bfloat16),
                                           JT.null_ctx(), state=st, cache_len=32, collect=True)
    tp = jax.tree.map(lambda a: torch.tensor(_f32(a)).bfloat16(), jp)
    tst = jax.tree.map(lambda a: torch.tensor(_f32(a)).to(
        torch.float32 if a.dtype == jnp.float32 else torch.bfloat16), st)
    got, _, gst = T._apply_layer_seq(tp, tcfg, kind, torch.tensor(x).bfloat16(), state=tst,
                                     cache_len=32, collect=True)
    assert got.dtype == torch.bfloat16
    for g, w in [(got, want)] + list(zip(tree_leaves(gst), jax.tree.leaves(jst))):
        if g.dtype == torch.float32:          # the recurrent state: float32 sums
            _close(g, w, TOL_F)
            continue
        _close(g, w, TOL_BF16)
        assert (_f32(g) != _f32(w)).mean() < 0.01


@pytest.fixture(scope="module", params=[(a, dt) for a in ARCHS for dt in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    """JAX and the port on one preset's smoke weights: the forward, a
    prefill of P_LEN tokens and the decode steps to S_LEN."""
    arch, dt = request.param
    over = dict(dtype="bfloat16") if dt == "bf16" else {}
    jcfg, tcfg = _cfgs(arch, **over)
    params, _ = JT.init_params(jax.random.PRNGKey(1), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)
    eager = dt == "bf16"          # bf16 op by op, as the port rounds per op
    jit = (lambda f: f) if eager else jax.jit
    fwd = jit(lambda p, t: JT.forward_seq(p, jcfg, t)[0])
    pre = jit(lambda p, t: JT.prefill(p, jcfg, t, S_LEN))
    dec = jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    unemb = jit(lambda p, h: JL.unembed(p["embed"], jcfg, h))
    with jax.disable_jit(eager):
        hidden = fwd(params, jnp.asarray(toks))
        logits0, cache = pre(params, jnp.asarray(toks[:, :P_LEN]))
        j = {"hidden": np.asarray(hidden), "full_logits": np.asarray(unemb(params, hidden)),
             "prefill_logits": np.asarray(logits0), "cache": _np(cache), "decode_logits": []}
        for t in range(P_LEN, S_LEN):
            lg, cache = dec(params, jnp.asarray(toks[:, t]), cache, jnp.int32(t))
            j["decode_logits"].append(np.asarray(lg))
        j["final_cache"] = _np(cache)
    tol = TOL_M if not eager else TOL_BF16_PATHS if arch == "recurrentgemma_9b" else TOL_BF16
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, params=params, model=model, toks=toks, j=j,
                tol=tol)


def test_forward_seq_matches_jax(run):
    hidden, aux, states = T.forward_seq(run["model"], run["tcfg"], run["toks"])
    assert states is None and float(aux) == 0.0
    assert hidden.dtype == run["tcfg"].activation_dtype()
    _close(hidden, run["j"]["hidden"], run["tol"])


def test_prefill_and_decode_match_jax(run):
    """The prefill's logits and every layer's cache (the rolled local ring,
    the recurrent states), then each decode step's logits and the final
    cache, against JAX's."""
    tcfg, model, toks, j = run["tcfg"], run["model"], run["toks"], run["j"]
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    _close(logits, j["prefill_logits"], run["tol"])
    want = T.cache_from_jax(j["cache"], tcfg, device="cpu")
    _close_tree(cache, want, run["tol"], "prefill cache")
    for i, t in enumerate(range(P_LEN, S_LEN)):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, j["decode_logits"][i], run["tol"], f"step {t}")
    _close_tree(cache, T.cache_from_jax(j["final_cache"], tcfg, device="cpu"), run["tol"],
                "final cache")


def test_decode_matches_forward(run):
    """``tests/test_models.py``'s check on the port: prefill + token-by-token
    decode equals the full-sequence forward (bf16: the bf16 bound)."""
    tcfg, model, toks = run["tcfg"], run["model"], run["toks"]
    hidden, _, _ = T.forward_seq(model, tcfg, toks)
    full = L.unembed(model.embed, tcfg, hidden)
    bf16 = tcfg.dtype == "bfloat16"
    tol = run["tol"] if bf16 else (1e-4, 1e-4)
    logits, cache = T.prefill(model, tcfg, toks[:, :P_LEN], S_LEN)
    _close(logits, full[:, P_LEN - 1], tol)
    step_tol = run["tol"] if bf16 else TOL_M
    for t in range(P_LEN, S_LEN):
        logits, cache = T.decode_step(model, tcfg, toks[:, t], cache, t)
        _close(logits, full[:, t], step_tol, f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_states_two_chunks(arch):
    """A prefill in two chunks, the second carrying the first's states in
    (given in ``cache_from_jax``'s layout), against JAX's same two chunks:
    hidden states and collected states.  RWKV carries all it needs, so the
    two chunks also equal the whole prefill; recurrentgemma's local
    attention layers ignore their entry (as the reference's do), so there
    only the layers before the first attention layer carry over exactly."""
    jcfg, tcfg = _cfgs(arch)
    params, _ = JT.init_params(jax.random.PRNGKey(2), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, S_LEN)).astype(np.int32)
    cut = 11
    fs = jax.jit(lambda p, t, st: JT.forward_seq(p, jcfg, t, states=st, collect=True,
                                                 cache_len=S_LEN))
    f0 = jax.jit(lambda p, t: JT.forward_seq(p, jcfg, t, collect=True, cache_len=S_LEN))
    _, _, jst1 = f0(params, jnp.asarray(toks[:, :cut]))
    jh2, _, jst2 = fs(params, jnp.asarray(toks[:, cut:]), jst1)
    st1 = T.cache_from_jax(_np(jst1), tcfg, device="cpu")
    h2, _, st2 = T.forward_seq(model, tcfg, toks[:, cut:], states=st1, collect=True,
                               cache_len=S_LEN)
    _close(h2, jh2, TOL_M)
    _close_tree(st2, T.cache_from_jax(_np(jst2), tcfg, device="cpu"), TOL_M, "states")
    whole, _, wst = T.forward_seq(model, tcfg, toks, collect=True, cache_len=S_LEN)
    if arch == "rwkv6_3b":
        _close(h2, whole[:, cut:], TOL_M)
        _close_tree(st2, wst, TOL_M, "states against the whole prefill")
    else:
        first_attn = T.layer_plan(tcfg).kinds.index("local")
        _close_tree(st2[:first_attn], wst[:first_attn], TOL_M, "rglru states before attention")
    with pytest.raises(ValueError, match="entries"):
        T.forward_seq(model, tcfg, toks, states=st1[:-1])


def test_recurrentgemma_layer_order():
    """The smoke plan, 8 = 2 × (rglru, rglru, local) + 2: ``params_from_jax``
    and ``cache_from_jax`` put group g's position p at layer 3g + p, then
    the two unstacked rglru layers."""
    jcfg, tcfg = _cfgs("recurrentgemma_9b")
    plan = T.layer_plan(tcfg)
    assert (plan.n_groups, plan.rem_kinds) == (2, ("rglru", "rglru"))
    assert plan.kinds == ("rglru", "rglru", "local") * 2 + ("rglru", "rglru")
    params, _ = JT.init_params(jax.random.PRNGKey(3), jcfg)
    pn = _np(params)
    model = T.params_from_jax(pn, tcfg, device="cpu")
    assert [b.kind for b in model.layers] == list(plan.kinds)
    for i, blk in enumerate(model.layers):
        want = (pn["rem"][i - 6] if i >= 6 else
                jax.tree.map(lambda x: x[i // 3], pn["blocks"][i % 3]))
        assert sorted(blk.tree()) == sorted(want)
        for got, w in zip(tree_leaves(blk.tree()), tree_leaves(want)):
            np.testing.assert_array_equal(_f32(got), w)
    jcache = _np(JT.init_cache(jcfg, 2, 20))
    marked = jax.tree.map(np.array, jcache)
    for pos in range(3):
        for leaf in jax.tree.leaves(marked["blocks"][pos]):
            leaf[...] = np.arange(2).reshape((2,) + (1,) * (leaf.ndim - 1)) * 10 + pos
    for i, leaf in enumerate(jax.tree.leaves(marked["rem"])):
        leaf[...] = 100 + i
    cache = T.cache_from_jax(marked, tcfg, device="cpu")
    for i, st in enumerate(cache):
        kind = plan.kinds[i]
        assert set(st) == ({"kv"} if kind == "local" else {"rnn"})
        val = float(tree_leaves(st)[0].flatten()[0])
        assert val == (100 + 2 * (i - 6) if i >= 6 else 10 * (i // 3) + i % 3)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grad_match_jax(arch):
    """``loss_fn`` and every gradient against ``jax.value_and_grad``, with a
    ``loss_mask``; seq 24 over ``rnn_chunk`` 16, so the scan runs two
    checkpointed chunks inside each remat'd layer."""
    jcfg, tcfg = _cfgs(arch)
    params, _ = JT.init_params(jax.random.PRNGKey(4), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24).peek(4)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    tl, tm, tg = S.loss_and_grads(model, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    _close(tl, jl, TOL_M)
    _close(tm["xent"], jm["xent"], TOL_M)
    want = tree_leaves(T.params_from_jax(_np(jg), tcfg, device="cpu").tree())
    for i, (got, w) in enumerate(zip(tree_leaves(tg), want)):
        _close(got, w, TOL_M, f"gradient leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Two ``make_train_step`` steps in both packages from one state: the
    metrics and every parameter after each step."""
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
        for k in ("loss", "grad_norm", "lr"):
            _close(m[k], jm[k], TOL_M, f"step {i} {k}")
        want = tree_leaves(T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree())
        for got, w in zip(tree_leaves(tstate["params"].tree()), want):
            _close(got, w, TOL_M, f"params after step {i}")


def test_decode_step_retrieval_matches_jax():
    """The kNN-LM head over the rwkv6_3b smoke model: the datastore, then
    three retrieval decode steps from the JAX prefill's recurrent states."""
    jcfg, tcfg = _cfgs("rwkv6_3b")
    jcfg = dataclasses.replace(jcfg, retrieval=jbase.RetrievalConfig(enabled=True, k=4, lam=0.5))
    tcfg = dataclasses.replace(tcfg, retrieval=C.RetrievalConfig(enabled=True, k=4, lam=0.5))
    params, _ = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    corpus = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 48)).astype(np.int32)
    jds = JK.build_datastore(params, jcfg, [jnp.asarray(corpus)])
    ds = K.build_datastore(model, tcfg, [corpus])
    assert ds.size == 4 * 47 and tuple(ds.keys.shape) == (188, jcfg.d_model)
    _close(ds.keys, jds.keys, TOL_M)
    _, jcache = JT.prefill(params, jcfg, jnp.asarray(corpus[:, :20]), 30)
    cache = T.cache_from_jax(_np(jcache), tcfg, device="cpu")
    step = jax.jit(lambda p, t, c, pos: JK.decode_step_retrieval(p, jcfg, t, c, pos, jds))
    for t in range(20, 23):
        want, jcache = step(params, jnp.asarray(corpus[:, t]), jcache, jnp.int32(t))
        got, cache = K.decode_step_retrieval(model, tcfg, corpus[:, t], cache, t, ds)
        _close(got, want, TOL_M, f"step {t}")


# --------------------------------------------------------------------------
# presets, specs, refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_presets_are_the_reference_presets(arch):
    """The configs, the analytic counts, the initialized parameter count
    (every leaf of the reference's tree, from shapes alone at full size),
    every parameter's logical axes, and ``long_500k`` eligibility."""
    for get in ("get_config", "get_smoke_config"):
        assert dataclasses.asdict(getattr(C, get)(arch)) == \
            dataclasses.asdict(getattr(jbase, get)(arch)), get
    jcfg, tcfg = jbase.get_config(arch), C.get_config(arch)
    assert tcfg.n_params() == jcfg.n_params()
    assert "long_500k" in C.applicable_shapes(tcfg) == jbase.applicable_shapes(jcfg)
    j_shapes, j_specs = JS.params_specs(jcfg)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_shapes))
    assert sum(t.numel() for t in tree_leaves(T.param_shapes(tcfg))) == n_jax
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


def test_attention_refuses_a_recurrent_kind():
    cfg = C.get_smoke_config("recurrentgemma_9b")
    with pytest.raises(ValueError, match="not an attention kind"):
        L.attention_forward({}, cfg, torch.zeros(1, 2, 64), kind="rglru")
    with pytest.raises(ValueError, match="not an attention kind"):
        L.attention_decode({}, cfg, torch.zeros(1, 1, 64), {}, 0, kind="rwkv")
    with pytest.raises(ValueError, match="unknown layer kind"):
        T.init_params(0, dataclasses.replace(cfg, block_pattern=("mamba",)), device="cpu")
