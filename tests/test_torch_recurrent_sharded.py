"""The recurrent presets in the slot program (``models/spmd.py``'s ``rwkv``,
``rglru`` and ``local`` layers) on CPU slot meshes, held to the JAX
package's one-device functions under ``jax.jit`` on the same numpy weights:
the sharded train step (2 steps) against ``make_train_step``, and
``build_prefill`` with ``build_decode``'s steps against
``transformer.prefill`` / ``decode_step``.

The port's model is carried to JAX (``test_torch_train._jax_params``).  The
serving half places the same weights by ``build_prefill``'s shardings, runs
the prompt, then carries the JAX prefill cache across (``cache_from_jax``),
places it by ``build_decode``'s shardings and runs the decode steps; the
logits and every state leaf (gathered) are held to JAX's after the prefill
and after each step.  The training half runs two sharded steps from the
same weights and pipeline batches as two JAX steps and holds the metrics,
the masters and the moments to JAX's.

The layouts:

  * ``rwkv6_3b`` smoke on 2 × 2: 4 heads of 16, two a slot (``u`` and the
    ``wkv`` state sharded by heads);
  * ``rwkv6_3b`` with ``d_model=96``, 6 heads, on 2 × 4: 24 channels, 1.5
    heads a slot (``u`` and ``wkv`` whole over "model": the pod's straddle);
  * ``rwkv6_3b`` with ``fsdp`` on 2 × 2 (the embed dims sharded over
    "data");
  * ``recurrentgemma_9b`` smoke on 2 × 4: the RG-LRU channel-parallel, the
    local layers' Q sharded and their one KV head replicated, the ring of 16
    sharded by position; a prompt of 24 wraps it, and 5 decode steps
    (positions 24–28, ring slots 8–12) cross from one slot's block into the
    next;
  * ``rwkv6_3b`` smoke with a batch of 1 on 2 × 2: ``act_batch`` does not
    resolve, every data group runs the row.

The serving half takes the port's ``init_params(4)`` weights, as
``tests/test_torch_serve_sharded.py`` does, and its tolerances: 1e-4
relative and absolute on logits and state leaves.  The training half takes
the JAX package's ``init_params(PRNGKey(5))`` weights, as
``tests/test_torch_recurrent.py``'s two-step test does: from the port's
``init_params(2)`` the first AdamW step throws the rwkv smoke model where its
float32 gradient is ill-conditioned (its norm 26 → 768, and the one-device
port's own step 2 misses JAX's by 7e-3).  There, as in
``tests/test_torch_train_sharded.py``: 1e-5 relative (atol 1e-5) on losses
and learning rates, ``mu`` to 1e-4 relative and 1e-5 absolute, the masters
to 1e-4 relative and absolute.  Two float32 limits of these small recurrent
models, which bind the one-device port against JAX as well:

  * the gradient norm is held to 1e-4 relative, ``test_torch_recurrent``'s
    whole-model bound: at ``d_model=96`` the float32 gradient itself is only
    good to 2e-4 (from the port's init, its norm after one step is
    122.302614 on one device, 122.294201 on 2 × 4 and 122.279846 in float64);
  * AdamW's first step moves a master by ±lr wherever its gradient is
    clear of eps, so an element whose gradient sits within float32 noise of
    0 may flip: at most one element in 10,000 may stray past 1e-4, and none
    past 2·lr + 1e-4 (a lost or misplaced block would move all of its
    elements).  ``nu``, the square of what ``mu`` holds element by element,
    is not held.  The flips make step 2 a step from other masters: with
    fewer tokens than ``train_sharded``'s 4 × 32 (one row of 24), many
    gradients sit near 0 and step 2's loss moved 3e-4 from JAX's (the
    one-device port's 7e-5), so the batches keep its 32 tokens a row.
"""
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
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves
from test_torch_train import _jax_params, _np

RTOL, ATOL = 1e-4, 1e-4
RTOL_L, ATOL_L = 1e-5, 1e-5
TOL_MU = (1e-4, 1e-5)
GNORM_RTOL = 1e-4
FLIP_SHARE = 1e-4
PROMPT, CACHE_LEN, SEQ, N_TRAIN = 24, 32, 32, 2
STRADDLE = dict(d_model=96, n_heads=6, n_kv_heads=6)

# name: (arch, overrides, (data, model), batch, decode steps)
CASES = {
    "rwkv_2x2_heads": ("rwkv6_3b", {}, (2, 2), 4, 3),
    "rwkv_2x4_straddle": ("rwkv6_3b", STRADDLE, (2, 4), 4, 3),
    "rwkv_fsdp_2x2": ("rwkv6_3b", dict(fsdp=True), (2, 2), 4, 3),
    "recurrentgemma_2x4": ("recurrentgemma_9b", {}, (2, 4), 4, 5),
    "rwkv_batch1_2x2": ("rwkv6_3b", {}, (2, 2), 1, 3),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, over):
    """(the JAX config, the port's): ``fsdp`` only places the port's weights,
    so the JAX one-device run is the one without it."""
    jover = {k: v for k, v in over.items() if k != "fsdp"}
    return (dataclasses.replace(jbase.get_smoke_config(arch), **jover),
            dataclasses.replace(C.get_smoke_config(arch), **over))


def _key(case):
    arch, over, _, batch, n_steps = CASES[case]
    return arch, tuple(sorted((k, v) for k, v in over.items() if k != "fsdp")), batch, n_steps


def _mesh(shape):
    return make_host_mesh(shape[1], slots=shape[0] * shape[1], device="cpu")


def _opt(cfg):
    return dict(total_steps=10, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)


@pytest.fixture(scope="module")
def jax_serve():
    """Per case, computed once: the port's model, the prompt and decode
    tokens, and JAX's prefill and decode steps (logits and cache after
    each, numpy)."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            arch, over, _, batch, n_steps = CASES[case]
            jcfg, tcfg = _cfgs(arch, over)
            model = T.init_params(4, tcfg, device="cpu")
            params = _jax_params(model, tcfg)
            r = np.random.default_rng(5)
            prompt = r.integers(0, tcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
            toks = r.integers(0, tcfg.vocab_size, (n_steps, batch)).astype(np.int32)
            pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, CACHE_LEN))
            dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
            logits, cache = pre(params, prompt)
            runs = [(np.asarray(logits), _np(cache))]
            for i in range(n_steps):
                logits, cache = dec(params, toks[i], cache, np.int32(PROMPT + i))
                runs.append((np.asarray(logits), _np(cache)))
            memo[_key(case)] = (model, prompt, toks, runs)
        return memo[_key(case)]

    return get


def _hold_state(got, want_np, tcfg, where):
    want = T.cache_from_jax(want_np, tcfg, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (where, i)
        for grp in g:
            for n in g[grp]:
                np.testing.assert_allclose(g[grp][n].gather().float().numpy(),
                                           w[grp][n].float().numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{where} layer {i} {grp}/{n}")


def _blocks_as_specs(tree):
    for arr in tree_leaves(tree):
        assert [tuple(b.shape) for b in arr.blocks] == \
            [arr.sharding.shard_shape(arr.shape)] * len(arr.blocks)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, jax_serve):
    arch, over, shape, batch, n_steps = CASES[case]
    _, tcfg = _cfgs(arch, over)
    model, prompt, toks, runs = jax_serve(case)
    mesh = _mesh(shape)

    fn, _, (p_sh, b_sh) = S.build_prefill(tcfg, C.ShapeConfig("p", "prefill", CACHE_LEN, batch),
                                          mesh)
    params = S.place(model.tree(), p_sh)
    logits, cache = fn(params, S.place({"tokens": torch.as_tensor(prompt)}, b_sh))
    assert logits.shape == (batch, tcfg.vocab_size)
    np.testing.assert_allclose(logits.gather().numpy(), runs[0][0], rtol=RTOL, atol=ATOL)
    _hold_state(cache, runs[0][1], tcfg, "prefill")
    _blocks_as_specs(cache)

    step, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
        tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, batch), mesh)
    placed = S.place(T.cache_from_jax(runs[0][1], tcfg, device="cpu"), c_sh)
    kinds = T.layer_plan(tcfg).kinds
    if arch == "rwkv6_3b":
        wkv, shift = placed[0]["rnn"]["wkv"], placed[0]["rnn"]["shift_tm"]
        assert spmd.model_dim(shift) == 1
        assert spmd.model_dim(wkv) == (None if over == STRADDLE else 1)
        rows = None if batch == 1 else "data"
        assert wkv.sharding.spec[0] == rows and shift.sharding.spec[0] == rows
    else:
        ring = placed[kinds.index("local")]["kv"]["k"]
        assert spmd.model_dim(ring) == 1 and ring.shape[1] == tcfg.window
        assert spmd.model_dim(placed[0]["rnn"]["h"]) == 1
    for i in range(n_steps):
        pos = PROMPT + i
        before = [[b.clone() for b in placed[j]["kv"]["k"].blocks]
                  for j, kind in enumerate(kinds) if kind == "local"]
        logits, placed = step(params, tok_sh.place(torch.as_tensor(toks[i])), placed,
                              pos_sh.place(torch.tensor(pos, dtype=torch.int32)))
        np.testing.assert_allclose(logits.gather().numpy(), runs[i + 1][0], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _hold_state(placed, runs[i + 1][1], tcfg, f"step {i}")
        rings = [placed[j]["kv"]["k"] for j, kind in enumerate(kinds) if kind == "local"]
        for ring, old in zip(rings, before):
            block = ring.shape[1] // shape[1]
            owner = (pos % ring.shape[1]) // block
            changed = {s for s, (a, b) in enumerate(zip(old, ring.blocks)) if not torch.equal(a, b)}
            assert changed == {s for s in range(len(ring.blocks))
                               if ring.sharding.coords(s)["model"] == owner}, (case, i, changed)
    if arch == "recurrentgemma_9b":      # the decode steps crossed a ring block boundary
        assert len({((PROMPT + i) % tcfg.window) // (tcfg.window // shape[1])
                    for i in range(n_steps)}) == 2


@pytest.fixture(scope="module")
def jax_train():
    """N_TRAIN JAX one-device steps per case, computed once: the initial
    weights (numpy), each step's metrics, and the final params and moments
    in the port's layout."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            arch, over, _, batch, _ = CASES[case]
            jcfg, tcfg = _cfgs(arch, over)
            jopt = JO.OptConfig(**_opt(jcfg))
            params, _ = JT.init_params(jax.random.PRNGKey(5), jcfg)
            state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
            jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
            pipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=batch,
                               seq_override=SEQ)
            metrics = []
            for _ in range(N_TRAIN):
                state, m = jstep(state, pipe.next_batch())
                metrics.append({k: float(v) for k, v in m.items()})
            final = {"params": T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree(),
                     "opt": T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")}
            memo[_key(case)] = (_np(params), metrics, final)
        return memo[_key(case)]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_train_steps_match_jax(case, jax_train):
    arch, over, shape, batch, _ = CASES[case]
    _, tcfg = _cfgs(arch, over)
    params0, want, final = jax_train(case)
    topt = O.OptConfig(**_opt(tcfg))
    fn, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], _mesh(shape), topt)
    state = S.init_placed_state(T.params_from_jax(params0, tcfg, device="cpu").tree(), topt,
                                st_sh)
    _blocks_as_specs(state)
    pipe = TokenPipeline(tcfg, C.SHAPES["train_4k"], batch_override=batch, seq_override=SEQ)
    lr_sum = 0.0
    for i in range(N_TRAIN):
        state, m = fn(state, pipe.next_batch("cpu"))
        lr_sum += float(m["lr"])
        for k, v in want[i].items():
            rtol = GNORM_RTOL if k == "grad_norm" else RTOL_L
            np.testing.assert_allclose(float(m[k]), v, rtol=rtol, atol=ATOL_L,
                                       err_msg=f"{case} step {i} {k}")
    for g, r in zip(tree_leaves(state["opt"]["mu"]), tree_leaves(final["opt"]["mu"])):
        np.testing.assert_allclose(g.gather().numpy(), r.numpy(), rtol=TOL_MU[0], atol=TOL_MU[1],
                                   err_msg=f"{case} mu")
    far = total = 0
    for g, r in zip(tree_leaves(state["params"]), tree_leaves(final["params"])):
        gap = (g.gather() - r).abs()
        assert gap.max().item() <= 2 * lr_sum + ATOL, (case, gap.max().item())
        far += int((gap > ATOL + RTOL * r.abs()).sum())
        total += gap.numel()
    assert far <= FLIP_SHARE * total, (case, far, total)
