"""The sharded serving steps on CPU slot meshes (``launch.steps.build_prefill``
/ ``build_decode`` over ``models/spmd.prefill`` / ``decode_step``) held to
the JAX package's one-device ``transformer.prefill`` and ``decode_step``
under ``jax.jit`` on the same numpy weights, tokens and cache.

The port's model is carried to JAX (``test_torch_train._jax_params``); the
port places the same weights by ``build_prefill``'s shardings and runs the
prompt, then carries the JAX prefill cache across (``cache_from_jax``),
places it by ``cache_shapes_and_shardings`` and runs 3 decode steps: the
logits (gathered from their ``("act_batch", "act_vocab")`` blocks) and the
gathered cache are held to JAX's after the prefill and after every step.
A GSPMD sharding never changes values, so the one-device JAX functions are
the yardstick (the JAX sharded steps do not run under this jax).

The layouts: ``olmo_1b`` on 2 × 2 (its KV heads divide the model axis: a
heads-sharded cache), ``qwen3_14b`` (6 heads, 2 KV heads) on 2 × 4
(attention replicated, the cache sharded by position) and on 2 × 3 (Q
sharded, K/V replicated, the cache sharded by position: ``cache_len`` 24 a
multiple of 3), ``llama3_405b`` with ``fsdp`` on 2 × 2 (weights gathered
over "data"), and ``olmo_1b`` on a (2, 2, 2) ``("pod", "data", "model")``
mesh.  Each slot's cache block has the shape its resolved spec gives, and a
decode step changes the blocks of the slots holding ``pos`` only.

Tolerances (float32 smoke configs, sums taken in other orders: the
row-parallel partial sums, the partial softmax terms of a position-sharded
cache combined across slots): 1e-4 relative and absolute on logits and
cached K/V, as ``tests/test_torch_models.py`` holds the one-device prefill
and decode steps to JAX."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as JT
from repro_torch import configs as C
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from test_torch_train import _jax_params

RTOL, ATOL = 1e-4, 1e-4
BATCH, PROMPT, CACHE_LEN, N_STEPS = 4, 12, 24, 3

CASES = {
    "olmo_2x2_heads": ("olmo_1b", {}, (2, 2), 2),
    "qwen3_2x4_replicated_attn": ("qwen3_14b", {}, (2, 4), 1),
    "qwen3_2x3_q_sharded": ("qwen3_14b", {}, (2, 3), 1),
    "llama3_fsdp_2x2": ("llama3_405b", dict(fsdp=True), (2, 2), 2),
    "olmo_pod_2x2x2": ("olmo_1b", {}, (2, 2, 2), 2),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    if len(shape) == 3:
        return Mesh(("pod", "data", "model"), shape, ("cpu",) * int(np.prod(shape)))
    return make_host_mesh(shape[1], slots=shape[0] * shape[1], device="cpu")


def _inputs(vocab):
    r = np.random.default_rng(5)
    return (r.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32),
            r.integers(0, vocab, (N_STEPS, BATCH)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_runs():
    """Per (arch, overrides), computed once: the port's model, the prompt and
    the decode tokens, and JAX's prefill and 3 decode steps (logits and
    cache after each, numpy)."""
    memo = {}

    def get(arch, over):
        key = (arch, tuple(sorted(over.items())))
        if key not in memo:
            jcfg = dataclasses.replace(jbase.get_smoke_config(arch), **over)
            tcfg = dataclasses.replace(C.get_smoke_config(arch), **over)
            model = T.init_params(4, tcfg, device="cpu")
            params = _jax_params(model, tcfg)
            prompt, toks = _inputs(tcfg.vocab_size)
            pre = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, CACHE_LEN))
            dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
            logits, cache = pre(params, prompt)
            runs = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
            for i in range(N_STEPS):
                logits, cache = dec(params, toks[i], cache, np.int32(PROMPT + i))
                runs.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
            memo[key] = (tcfg, model, prompt, toks, runs)
        return memo[key]

    return get


def _hold_cache(got, want_np, tcfg, where):
    want = T.cache_from_jax(want_np, tcfg, device="cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        for n in ("k", "v"):
            np.testing.assert_allclose(g["kv"][n].gather().numpy(), w["kv"][n].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{where} layer {i} {n}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, jax_runs):
    arch, over, shape, cache_dim = CASES[case]
    tcfg, model, prompt, toks, runs = jax_runs(arch, over)
    mesh = _mesh(shape)
    n_slots, n_data, n_model = len(mesh.slot_devices), int(np.prod(shape[:-1])), shape[-1]

    fn, _, (p_sh, b_sh) = S.build_prefill(tcfg, C.ShapeConfig("p", "prefill", CACHE_LEN, BATCH),
                                          mesh)
    params = S.place(model.tree(), p_sh)
    logits, cache = fn(params, S.place({"tokens": torch.as_tensor(prompt)}, b_sh))
    assert logits.shape == (BATCH, tcfg.vocab_size)
    assert logits.sharding.spec[1] == "model"          # every case's vocab splits
    np.testing.assert_allclose(logits.gather().numpy(), runs[0][0], rtol=RTOL, atol=ATOL)
    _hold_cache(cache, runs[0][1], tcfg, "prefill")

    step, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
        tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, BATCH), mesh)
    placed = S.place(T.cache_from_jax(runs[0][1], tcfg, device="cpu"), c_sh)
    k0 = placed[0]["kv"]["k"]
    assert k0.sharding.spec == c_sh[0]["kv"]["k"].spec and spmd.model_dim(k0) == cache_dim
    block = k0.sharding.shard_shape(k0.shape)
    assert block == (BATCH // n_data, CACHE_LEN // (n_model if cache_dim == 1 else 1),
                     tcfg.n_kv_heads // (n_model if cache_dim == 2 else 1), tcfg.hd)
    for layer in placed:
        for n in ("k", "v"):
            assert all(tuple(b.shape) == block for b in layer["kv"][n].blocks), (case, n)

    for i in range(N_STEPS):
        pos = PROMPT + i
        before = [b.clone() for layer in placed for b in layer["kv"]["k"].blocks]
        logits, placed = step(params, tok_sh.place(torch.as_tensor(toks[i])), placed,
                              pos_sh.place(torch.tensor(pos, dtype=torch.int32)))
        np.testing.assert_allclose(logits.gather().numpy(), runs[i + 1][0], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _hold_cache(placed, runs[i + 1][1], tcfg, f"step {i}")
        after = [b for layer in placed for b in layer["kv"]["k"].blocks]
        changed = {j % n_slots for j, (a, b) in enumerate(zip(before, after))
                   if not torch.equal(a, b)}
        owner = pos // block[1] if cache_dim == 1 else None
        want = {s for s in range(n_slots)
                if owner is None or k0.sharding.coords(s)["model"] == owner}
        assert changed == want, (case, i, changed, want)


def test_build_cell_dispatches_on_the_kind():
    cfg = C.get_smoke_config("olmo_1b")
    mesh = make_host_mesh(2, slots=4, device="cpu")
    for name, build in (("train_4k", S.build_train), ("prefill_32k", S.build_prefill),
                        ("decode_32k", S.build_decode)):
        shape = C.ShapeConfig(name, C.SHAPES[name].kind, 16, 4)
        fn, specs, shardings = S.build_cell(cfg, shape, mesh)
        _, ref_specs, _ = build(cfg, shape, mesh)
        assert len(specs) == len(ref_specs) == len(shardings)
        assert fn.__name__ == {"train": "train_step", "prefill": "prefill_fn",
                               "decode": "serve_step"}[shape.kind]
