"""The encoder-decoder in the slot program (``models/spmd.py``: the encoder
per data group, cross-attention after each decoder layer's mixer, the
cross K/V written by prefill and read by decode) on CPU slot meshes, held
to the JAX package's one-device functions under ``jax.jit`` on the same
numpy weights and frames (``whisper_large_v3``'s smoke config: 2 + 2
layers, d_model 64, 4 heads, ``encoder_seq`` 24):

  * 2 × 2: 2 heads a slot, the KV cache and the cross K/V split by heads;
  * 2 × 3: 4 heads do not divide 3, so attention runs whole on every model
    slot, the cross K/V replicate and the KV cache splits by position (8
    of 24 a slot: decode at 14 … 17 crosses from slot 1 into slot 2);
  * 2 × 2 with ``fsdp`` and the flash loop (``attn_chunk`` 8 with
    ``encoder_seq`` 20, which the chunk does not divide);
  * 2 × 2 with a batch of 1, which does not split over the data groups.

``build_prefill`` with ``build_decode``'s steps (each continuing from the
prefill's own cache) against ``transformer.prefill`` / ``decode_step``; the
reference's other two cases (a zero cross cache from ``init_cache``, a
prefill without frames); ``loss_fn``'s value and every gradient, the
encoder's included, against ``jax.value_and_grad`` with remat on and off;
two ``build_train`` steps against ``make_train_step``.  A slot program
that skipped the encoder or cross-attention would pass every shape check:
the parities catch it, and ``test_frames_move_the_sharded_prefill`` holds
that other frames move the logits.  One smoke cell traced on ``meta``
slots gives the record and output bytes of its run on CPU slots.

Tolerances (``tests/test_torch_moe_sharded.py``'s).  Serving: 1e-4
relative and absolute on logits and cache leaves.  Training: 1e-5 relative
(atol 1e-5) on losses and learning rates, 1e-4 on the gradient norm, ``mu``
to 1e-4 relative and 1e-5 absolute, the masters to 1e-4 but for AdamW sign
flips (at most one element in 10,000, none past 2·lr + 1e-4); gradients
1e-4 relative, 2e-4 absolute."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import TokenPipeline as JaxPipeline
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch.data import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.sharding import SlotArray
from repro_torch.utils import tree_leaves
from test_torch_dryrun import _trace_on_cpu
from test_torch_recurrent_sharded import _blocks_as_specs, _hold_state

RTOL, ATOL = 1e-4, 1e-4
RTOL_L, ATOL_L = 1e-5, 1e-5
TOL_MU = (1e-4, 1e-5)
GNORM_RTOL = 1e-4
FLIP_SHARE = 1e-4
TOL_G = (1e-4, 2e-4)
ARCH = "whisper_large_v3"
PROMPT, CACHE_LEN, N_STEPS, SEQ, N_TRAIN = 14, 24, 4, 16, 2

# name: (overrides, (data, model), batch, the cross K/V's model dim)
CASES = {
    "2x2": ({}, (2, 2), 2, 2),
    "2x3_whole": ({}, (2, 3), 2, None),
    "fsdp_flash_2x2": (dict(fsdp=True, attn_chunk=8, encoder_seq=20), (2, 2), 2, 2),
    "batch1_2x2": ({}, (2, 2), 1, 2),
}
TRAIN_CASES = ("fsdp_flash_2x2", "batch1_2x2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(over):
    """(the JAX config, the port's): ``fsdp`` only places the port's
    weights, so the JAX one-device run is the one without it."""
    jover = {k: v for k, v in over.items() if k != "fsdp"}
    return (dataclasses.replace(jbase.get_smoke_config(ARCH), **jover),
            dataclasses.replace(C.get_smoke_config(ARCH), **over))


def _key(case):
    over, _, batch, _ = CASES[case]
    return tuple(sorted((k, v) for k, v in over.items() if k != "fsdp")), batch


def _mesh(shape):
    return make_host_mesh(shape[1], slots=shape[0] * shape[1], device="cpu")


def _frames(cfg, batch, seed=2):
    """The reference pipeline's stub frontend: seeded standard normal frames."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _placed_model(tcfg, params_np, mesh):
    model = T.params_from_jax(params_np, tcfg, device="cpu")
    _, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], mesh)
    return model, S.place(model.tree(), st_sh["params"])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serve():
    """Per case, computed once: the JAX weights (numpy), the prompt, decode
    tokens and frames, JAX's prefill and decode steps (logits and cache
    after each, numpy)."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            over, _, batch, _ = CASES[case]
            jcfg, _ = _cfgs(over)
            params, _ = JT.init_params(jax.random.PRNGKey(4), jcfg)
            r = np.random.default_rng(5)
            prompt = r.integers(0, jcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
            toks = r.integers(0, jcfg.vocab_size, (N_STEPS, batch)).astype(np.int32)
            frames = _frames(jcfg, batch)
            logits, cache = jax.jit(lambda p, t, f: JT.prefill(p, jcfg, t, CACHE_LEN, frames=f))(
                params, prompt, frames)
            dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
            runs = [(np.asarray(logits), _np(cache))]
            for i in range(N_STEPS):
                logits, cache = dec(params, toks[i], cache, np.int32(PROMPT + i))
                runs.append((np.asarray(logits), _np(cache)))
            memo[_key(case)] = (_np(params), prompt, toks, frames, runs)
        return memo[_key(case)]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, jax_serve):
    """``build_prefill``'s step with the frames, then ``build_decode``'s
    steps from its cache: the logits and every cache leaf (KV and cross
    K/V) against JAX's after the prefill and after each step."""
    over, shape, batch, cross_dim = CASES[case]
    _, tcfg = _cfgs(over)
    params_np, prompt, toks, frames, runs = jax_serve(case)
    mesh = _mesh(shape)
    fn, _, (p_sh, b_sh) = S.build_prefill(tcfg, C.ShapeConfig("p", "prefill", CACHE_LEN, batch),
                                          mesh)
    params = S.place(T.params_from_jax(params_np, tcfg, device="cpu").tree(), p_sh)
    if over.get("fsdp"):
        assert params["encoder"]["layers"][0]["mlp"]["w_in"].sharding.spec[0] == "data"
    logits, cache = fn(params, S.place({"tokens": torch.as_tensor(prompt),
                                        "frames": torch.as_tensor(frames)}, b_sh))
    np.testing.assert_allclose(logits.gather().numpy(), runs[0][0], rtol=RTOL, atol=ATOL)
    _hold_state(cache, runs[0][1], tcfg, "prefill")
    _blocks_as_specs(cache)
    assert spmd.model_dim(cache[0]["cross"]["k"]) == cross_dim

    step, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
        tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, batch), mesh)
    assert [a.sharding.spec for a in tree_leaves(cache)] == [s.spec for s in tree_leaves(c_sh)]
    for i in range(N_STEPS):
        logits, cache = step(params, tok_sh.place(torch.as_tensor(toks[i])), cache,
                             pos_sh.place(torch.tensor(PROMPT + i, dtype=torch.int32)))
        np.testing.assert_allclose(logits.gather().numpy(), runs[i + 1][0], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _hold_state(cache, runs[i + 1][1], tcfg, f"step {i}")


@pytest.mark.parametrize("shape", [(2, 2), (2, 3)], ids=["2x2", "2x3"])
def test_zero_cross_cache_and_bare_prefill_match_jax(shape):
    """The reference's other two cases in the slot program: decode from
    ``init_cache``'s zero cross K/V placed by ``build_decode``'s shardings
    (decode attends to them), and a prefill without frames (it keeps no
    cross K/V; decode skips cross-attention), each against JAX."""
    jcfg, tcfg = _cfgs({})
    params, _ = JT.init_params(jax.random.PRNGKey(6), jcfg)
    _, placed = _placed_model(tcfg, _np(params), _mesh(shape))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (2, CACHE_LEN)).astype(np.int32)
    dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
    step, _, (_, _, c_sh, _) = S.build_decode(tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, 2),
                                              _mesh(shape))
    jcache = JT.init_cache(jcfg, 2, CACHE_LEN)
    cache = S.place(T.init_cache(tcfg, 2, CACHE_LEN, device="cpu"), c_sh)
    for t in range(3):
        want, jcache = dec(params, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        got, cache = step(placed, toks[:, t], cache, t)
        np.testing.assert_allclose(got.gather().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"init_cache step {t}")
    want, jcache = JT.prefill(params, jcfg, jnp.asarray(toks[:, :PROMPT]), CACHE_LEN)
    got, cache = spmd.prefill(placed, tcfg, toks[:, :PROMPT], CACHE_LEN)
    np.testing.assert_allclose(got.gather().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert [set(st) for st in cache] == [{"kv"}] * tcfg.n_layers
    for t in range(PROMPT, PROMPT + 3):
        want, jcache = dec(params, jnp.asarray(toks[:, t]), jcache, jnp.int32(t))
        got, cache = step(placed, toks[:, t], cache, t)
        np.testing.assert_allclose(got.gather().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=f"bare prefill step {t}")


def test_frames_move_the_sharded_prefill(jax_serve):
    """Other frames move the sharded prefill's logits and cross K/V far
    past the serving tolerance (a skipped encoder or cross-attention would
    leave them), and leave the decoder's self-attention K/V of the first
    layer as they were (they see no frames)."""
    _, tcfg = _cfgs({})
    params_np, prompt, _, frames, _ = jax_serve("2x2")
    _, placed = _placed_model(tcfg, params_np, _mesh((2, 2)))
    a, ca = spmd.prefill(placed, tcfg, prompt, CACHE_LEN, frames=frames)
    b, cb = spmd.prefill(placed, tcfg, prompt, CACHE_LEN, frames=_frames(tcfg, 2, seed=9))
    assert float((a.gather() - b.gather()).abs().max()) > 100 * ATOL
    assert float((ca[1]["cross"]["v"].gather() - cb[1]["cross"]["v"].gather()).abs().max()) > \
        100 * ATOL
    assert torch.equal(ca[0]["kv"]["k"].gather(), cb[0]["kv"]["k"].gather())


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat,shape", [(True, (2, 2)), (False, (2, 3))],
                         ids=["remat_2x2", "no-remat_2x3"])
def test_loss_fn_value_and_grads_match_jax(remat, shape):
    """The slot program's ``loss_fn`` with ``batch["frames"]`` and a
    ``loss_mask``, and every gradient summed over the block's replicas (the
    encoder's and the cross-attention's included), against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, tcfg = _cfgs(dict(remat=remat))
    params, _ = JT.init_params(jax.random.PRNGKey(7), jcfg)
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=SEQ).peek(3)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    _, placed = _placed_model(tcfg, _np(params), _mesh(shape))
    loss, m, grads = S._slot_grads(placed, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL_L, atol=ATOL_L)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), rtol=RTOL_L, atol=ATOL_L)
    want = T.params_from_jax(_np(jg), tcfg, device="cpu").tree()
    assert float(want["encoder"]["layers"][0]["attn"]["wq"].abs().max()) > 0
    for i, (a, g, w) in enumerate(zip(tree_leaves(placed), grads, tree_leaves(want))):
        np.testing.assert_allclose(SlotArray(a.sharding, a.shape, g).gather().numpy(), w.numpy(),
                                   rtol=TOL_G[0], atol=TOL_G[1], err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_steps_match_jax(case):
    """Two ``build_train`` steps, each batch with its frames, against
    ``make_train_step`` from the same state: the metrics, ``mu`` and the
    masters after the second step."""
    over, shape, batch, _ = CASES[case]
    jcfg, tcfg = _cfgs(over)
    kw = dict(total_steps=10, warmup_steps=1, moment_dtype=jcfg.opt_state_dtype)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    params, _ = JT.init_params(jax.random.PRNGKey(5), jcfg)
    state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
    fn, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], _mesh(shape), topt)
    tstate = S.init_placed_state(T.params_from_jax(_np(params), tcfg, device="cpu").tree(), topt,
                                 st_sh)
    _blocks_as_specs(tstate)
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
    jpipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=batch, seq_override=SEQ)
    pipe = TokenPipeline(tcfg, C.SHAPES["train_4k"], batch_override=batch, seq_override=SEQ)
    lr_sum = 0.0
    for i in range(N_TRAIN):
        state, jm = jstep(state, jpipe.next_batch())
        tstate, m = fn(tstate, pipe.next_batch("cpu"))
        lr_sum += float(m["lr"])
        for k in ("loss", "xent", "grad_norm", "lr"):
            rtol = GNORM_RTOL if k == "grad_norm" else RTOL_L
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol, atol=ATOL_L,
                                       err_msg=f"{case} step {i} {k}")
    mu = T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")["mu"]
    for g, r in zip(tree_leaves(tstate["opt"]["mu"]), tree_leaves(mu)):
        np.testing.assert_allclose(g.gather().numpy(), r.numpy(), rtol=TOL_MU[0], atol=TOL_MU[1],
                                   err_msg=f"{case} mu")
    final = T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree()
    far = total = 0
    for g, r in zip(tree_leaves(tstate["params"]), tree_leaves(final)):
        gap = (g.gather() - r).abs()
        assert gap.max().item() <= 2 * lr_sum + ATOL, (case, gap.max().item())
        far += int((gap > ATOL + RTOL * r.abs()).sum())
        total += gap.numel()
    assert far <= FLIP_SHARE * total, (case, far, total)


# --------------------------------------------------------------------------
# meta against the loops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "decode"])
def test_whisper_meta_trace_equals_the_loops(kind):
    """whisper's smoke cell traced on CPU slots and on ``meta`` slots of
    2 × 2 records the same collectives on every slot and the same per-slot
    output bytes (a train step runs the encoder, a decode step reads the
    cross K/V)."""
    cfg = C.get_smoke_config(ARCH)
    shape = C.ShapeConfig(kind, kind, 12, 4)
    mesh = _mesh((2, 2))
    cpu_rec, cpu_out = _trace_on_cpu(cfg, shape, mesh)
    meta_rec, meta_out = dryrun.trace(cfg, shape, dryrun.on_meta(mesh), one_group=False)
    for field in ("bytes", "counts", "bytes_once", "counts_once"):
        a, b = getattr(cpu_rec, field), getattr(meta_rec, field)
        assert all(np.array_equal(a[k], b[k]) for k in a), field
    assert np.array_equal(cpu_out, meta_out)
