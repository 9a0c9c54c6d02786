"""The VLM in the slot program (``models/spmd.py``: the projector per data
group, ``w1``'s columns and ``w2``'s rows on "model", its output prepended
to the embeddings) on CPU slot meshes, held to the JAX package's one-device
functions under ``jax.jit`` on the same numpy weights and patches
(``llava_next_mistral_7b``'s smoke config: 3 layers, d_model 96, 6/2
heads, 12 patches of 32 features):

  * 2 × 2: 3 query heads and 1 KV head a slot, the cache split by heads;
  * 2 × 3: 2 query heads a slot, the 2 KV heads repeated to them, the
    cache split by position (10 of 30 a slot): the prefill writes the 12
    patch and 6 text positions over slots 0 and 1, decode at 18 … 21
    crosses into slot 2;
  * 2 × 2 with ``fsdp`` (the projector's d_model rows of ``w1`` and columns
    of ``w2`` gathered over "data") and the flash loop (``attn_chunk`` 8);
  * 2 × 3 with a batch of 1, which does not split over the data groups.

``build_prefill`` with the patches and ``build_decode``'s steps from its
cache, from position P + S, against ``transformer.prefill`` /
``decode_step``; ``loss_fn``'s value and every gradient, the projector's
included, against ``jax.value_and_grad`` with remat on and off; two
``build_train`` steps against ``make_train_step``.  A slot program that
skipped the projector would pass every shape check: the parities catch it,
and ``test_patches_move_the_text_not_the_patches`` holds that other patches
move the logits while another prompt leaves the patches' K/V bit for bit.
One smoke cell traced on ``meta`` slots gives the record and output bytes
of its run on CPU slots.  ``configs.registry()`` is the reference's.

Tolerances (``tests/test_torch_encdec_sharded.py``'s)."""
import dataclasses

import jax
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
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.sharding import SlotArray
from repro_torch.utils import tree_leaves
from test_torch_dryrun import _trace_on_cpu
from test_torch_encdec_sharded import (ATOL, ATOL_L, FLIP_SHARE, GNORM_RTOL, RTOL, RTOL_L, TOL_G,
                                       TOL_MU, _mesh, _np)
from test_torch_recurrent_sharded import _blocks_as_specs, _hold_state

ARCH = "llava_next_mistral_7b"
PROMPT, CACHE_LEN, N_STEPS, SEQ, N_TRAIN = 6, 30, 4, 24, 2

# name: (overrides, (data, model), batch, the KV cache's model dim)
CASES = {
    "2x2": ({}, (2, 2), 2, 2),
    "2x3_seq": ({}, (2, 3), 2, 1),
    "fsdp_flash_2x2": (dict(fsdp=True, attn_chunk=8), (2, 2), 2, 2),
    "batch1_2x3": ({}, (2, 3), 1, 1),
}
TRAIN_CASES = ("fsdp_flash_2x2", "batch1_2x3")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(over):
    jover = {k: v for k, v in over.items() if k != "fsdp"}
    return (dataclasses.replace(jbase.get_smoke_config(ARCH), **jover),
            dataclasses.replace(C.get_smoke_config(ARCH), **over))


def _key(case):
    over, _, batch, _ = CASES[case]
    return tuple(sorted((k, v) for k, v in over.items() if k != "fsdp")), batch


def _patches(cfg, batch, seed=2):
    """The reference pipeline's stub vision tower: seeded standard normal
    patch features."""
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_patches, cfg.patch_dim)).astype(np.float32)


def _placed(tcfg, params_np, mesh):
    model = T.params_from_jax(params_np, tcfg, device="cpu")
    _, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], mesh)
    return S.place(model.tree(), st_sh["params"])


def test_registry_is_the_references():
    got, want = C.registry(), jbase.registry()
    assert list(got) == list(want) == C.ARCH_IDS
    assert all(dataclasses.asdict(got[a]) == dataclasses.asdict(want[a]) for a in want)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serve():
    """Per case, computed once: the JAX weights (numpy), the prompt, decode
    tokens and patches, JAX's prefill and decode steps from position
    P + S (logits and cache after each, numpy)."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            over, _, batch, _ = CASES[case]
            jcfg, _ = _cfgs(over)
            params, _ = JT.init_params(jax.random.PRNGKey(4), jcfg)
            r = np.random.default_rng(5)
            prompt = r.integers(0, jcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
            toks = r.integers(0, jcfg.vocab_size, (N_STEPS, batch)).astype(np.int32)
            patches = _patches(jcfg, batch)
            logits, cache = jax.jit(
                lambda p, t, x: JT.prefill(p, jcfg, t, CACHE_LEN, patches=x))(
                params, prompt, patches)
            dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
            runs = [(np.asarray(logits), _np(cache))]
            for i in range(N_STEPS):
                pos = jcfg.n_patches + PROMPT + i
                logits, cache = dec(params, toks[i], cache, np.int32(pos))
                runs.append((np.asarray(logits), _np(cache)))
            memo[_key(case)] = (_np(params), prompt, toks, patches, runs)
        return memo[_key(case)]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, jax_serve):
    """``build_prefill``'s step with the patches before the prompt, then
    ``build_decode``'s steps from its cache at P + S …: the logits and every
    cache leaf against JAX's after the prefill and after each step."""
    over, shape, batch, kv_dim = CASES[case]
    _, tcfg = _cfgs(over)
    params_np, prompt, toks, patches, runs = jax_serve(case)
    mesh = _mesh(shape)
    fn, (_, b_specs), (p_sh, b_sh) = S.build_prefill(
        tcfg, C.ShapeConfig("p", "prefill", CACHE_LEN, batch), mesh)
    assert tuple(b_specs["tokens"].shape) == (batch, CACHE_LEN - tcfg.n_patches)
    params = S.place(T.params_from_jax(params_np, tcfg, device="cpu").tree(), p_sh)
    if over.get("fsdp"):
        assert params["mm_projector"]["w1"].sharding.spec == ("data", "model")
    placed_in = S.place({"tokens": torch.as_tensor(prompt), "patches": torch.as_tensor(patches)},
                        b_sh)
    logits, cache = fn(params, placed_in)
    np.testing.assert_allclose(logits.gather().numpy(), runs[0][0], rtol=RTOL, atol=ATOL)
    _hold_state(cache, runs[0][1], tcfg, "prefill")
    _blocks_as_specs(cache)
    assert spmd.model_dim(cache[0]["kv"]["k"]) == kv_dim

    step, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
        tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, batch), mesh)
    assert [a.sharding.spec for a in tree_leaves(cache)] == [s.spec for s in tree_leaves(c_sh)]
    for i in range(N_STEPS):
        pos = tcfg.n_patches + PROMPT + i
        logits, cache = step(params, tok_sh.place(torch.as_tensor(toks[i])), cache,
                             pos_sh.place(torch.tensor(pos, dtype=torch.int32)))
        np.testing.assert_allclose(logits.gather().numpy(), runs[i + 1][0], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _hold_state(cache, runs[i + 1][1], tcfg, f"step {i}")


def test_patches_move_the_text_not_the_patches(jax_serve):
    """On 2 × 3: other patches move the sharded prefill's logits far past
    the serving tolerance (a skipped projector would leave them); another
    prompt after the same patches leaves every layer's K/V at the patch
    positions bit for bit (they see no text) and moves the text's."""
    _, tcfg = _cfgs({})
    params_np, prompt, _, patches, _ = jax_serve("2x3_seq")
    placed = _placed(tcfg, params_np, _mesh((2, 3)))
    n_p = tcfg.n_patches
    a, ca = spmd.prefill(placed, tcfg, prompt, CACHE_LEN, patches=patches)
    b, _ = spmd.prefill(placed, tcfg, prompt, CACHE_LEN, patches=_patches(tcfg, 2, seed=9))
    assert float((a.gather() - b.gather()).abs().max()) > 100 * ATOL
    _, cc = spmd.prefill(placed, tcfg, (prompt + 1) % tcfg.vocab_size, CACHE_LEN,
                         patches=patches)
    for st, st2 in zip(ca, cc):
        for n in ("k", "v"):
            assert torch.equal(st["kv"][n].gather()[:, :n_p], st2["kv"][n].gather()[:, :n_p])
    assert not torch.equal(ca[0]["kv"]["k"].gather()[:, n_p:], cc[0]["kv"]["k"].gather()[:, n_p:])


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat,shape", [(True, (2, 2)), (False, (2, 3))],
                         ids=["remat_2x2", "no-remat_2x3"])
def test_loss_fn_value_and_grads_match_jax(remat, shape):
    """The slot program's ``loss_fn`` with ``batch["patches"]`` (the text
    positions scored) and a ``loss_mask``, and every gradient summed over
    the block's replicas (the projector's included), against
    ``jax.value_and_grad`` of the reference's ``loss_fn``."""
    jcfg, tcfg = _cfgs(dict(remat=remat))
    params, _ = JT.init_params(jax.random.PRNGKey(7), jcfg)
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=SEQ).peek(3)
    assert b["tokens"].shape == (2, SEQ - jcfg.n_patches)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        params)
    placed = _placed(tcfg, _np(params), _mesh(shape))
    loss, m, grads = S._slot_grads(placed, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL_L, atol=ATOL_L)
    np.testing.assert_allclose(float(m["xent"]), float(jm["xent"]), rtol=RTOL_L, atol=ATOL_L)
    want = T.params_from_jax(_np(jg), tcfg, device="cpu").tree()
    assert all(float(want["mm_projector"][k].abs().max()) > 0 for k in ("w1", "w2"))
    for i, (a, g, w) in enumerate(zip(tree_leaves(placed), grads, tree_leaves(want))):
        np.testing.assert_allclose(SlotArray(a.sharding, a.shape, g).gather().numpy(), w.numpy(),
                                   rtol=TOL_G[0], atol=TOL_G[1], err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_steps_match_jax(case):
    """Two ``build_train`` steps, each batch with its patches, against
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

@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_llava_meta_trace_equals_the_loops(kind):
    """llava's smoke cell traced on CPU slots and on ``meta`` slots of
    2 × 2 records the same collectives on every slot and the same per-slot
    output bytes (the patches through the projector in both)."""
    cfg = C.get_smoke_config(ARCH)
    shape = C.ShapeConfig(kind, kind, cfg.n_patches + 8, 4)
    mesh = _mesh((2, 2))
    cpu_rec, cpu_out = _trace_on_cpu(cfg, shape, mesh)
    meta_rec, meta_out = dryrun.trace(cfg, shape, dryrun.on_meta(mesh), one_group=False)
    for field in ("bytes", "counts", "bytes_once", "counts_once"):
        a, b = getattr(cpu_rec, field), getattr(meta_rec, field)
        assert all(np.array_equal(a[k], b[k]) for k in a), field
    assert np.array_equal(cpu_out, meta_out)
