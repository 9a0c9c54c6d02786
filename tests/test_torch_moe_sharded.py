"""The MoE presets in the slot program (``models/spmd.py``'s MoE sublayer:
expert parallelism, the ``expert_mlp`` fallback, the global dispatch across
data groups, the per-data-shard dispatch) on CPU slot meshes, held to the
JAX package's one-device functions under ``jax.jit`` on the same numpy
weights: ``build_prefill`` with ``build_decode``'s steps against
``transformer.prefill`` / ``decode_step``, and two sharded train steps
against ``make_train_step``, ``moe_aux`` among the metrics.

Every case runs at capacity factor 0.5, where the reference's own router
drops assignments (counted from inside its jitted functions,
``_jax_drops``): at the smoke defaults it drops almost none, and a case
that drops none cannot tell a global position from a group's own.

The layouts:

  * ``granite_moe_1b_a400m`` smoke on 2 × 2: 2 of the 4 experts a slot
    (EP), the KV heads sharded, the global dispatch across the 2 data
    groups;
  * ``qwen3_moe_235b_a22b`` smoke with ``fsdp`` on 2 × 4: 2 of the 8
    experts a slot, the router and the experts gathered over "data", the 6
    heads whole on 4 slots;
  * ``granite_moe_1b_a400m`` smoke on 1 × 8: 4 experts do not divide 8
    slots, so the ``expert_mlp`` fallback splits d_expert (serving only);
  * ``granite_moe_1b_a400m`` smoke with a batch of 1 on 2 × 2: the row is
    replicated over the data groups and the global dispatch is its own.

``test_layouts_run_both_presets`` runs both presets in all three layouts
(EP, the fallback, nothing split) against the one-device port.  The
per-data-shard dispatch (``moe_sharded_dispatch``) has the port's copy of
the reference's ``tests/test_distributed.py::test_moe_sharded_dispatch_
equivalence`` (8 × 1 slots, capacity 16: the per-shard buffers equal the
global one), and is held where capacity binds to the reference's split
path, computed from the JAX package's own ``_moe_dispatch`` and ``_moe_cap``
under ``jax.vmap`` over the chunks with the mean of the aux values (its
``apply_moe`` on that path; its own test needs 8 JAX devices): the layer,
and the slot program's ``loss_fn`` value and gradient, where the rows split
over the data groups and where one row's chunks cut through its sequence
(a row of 48 or 64 tokens: a chunk of 8 tokens cannot drop, as an expert
takes a token once and holds at least 8).
One MoE cell traced on ``meta`` slots gives the record and output bytes of
its run on CPU slots: no shape depends on the data.

Tolerances (``tests/test_torch_recurrent_sharded.py``'s).  Serving: 1e-4
relative and absolute on logits and cache leaves.  Training: 1e-5 relative
(atol 1e-5) on losses, ``moe_aux`` and learning rates, 1e-4 on the gradient
norm, ``mu`` to 1e-4 relative and 1e-5 absolute, the masters to 1e-4 but
for AdamW sign flips (at most one element in 10,000, none past 2·lr +
1e-4).  The per-data-shard layer: 1e-5 (float32 single functions); its
gradients: 1e-4 relative, 2e-4 absolute (``tests/test_torch_moe.py``'s
whole-model bound)."""
import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import TokenPipeline as JaxPipeline
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch.data import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.sharding import ShardingCtx, SlotArray
from repro_torch.utils import tree_leaves
from test_torch_dryrun import _trace_on_cpu
from test_torch_recurrent_sharded import _blocks_as_specs, _hold_state
from test_torch_train import _jax_params, _np

RTOL, ATOL = 1e-4, 1e-4
RTOL_L, ATOL_L = 1e-5, 1e-5
TOL_MU = (1e-4, 1e-5)
GNORM_RTOL = 1e-4
FLIP_SHARE = 1e-4
TOL_F = (1e-5, 1e-5)
TOL_G = (1e-4, 2e-4)
FACTOR = 0.5
PROMPT, CACHE_LEN, SEQ, N_TRAIN, N_STEPS = 12, 16, 16, 2, 3

# name: (arch, overrides, (data, model), batch, the MoE layout)
CASES = {
    "granite_2x2_ep": ("granite_moe_1b_a400m", {}, (2, 2), 4, "ep"),
    "qwen3_moe_fsdp_2x4": ("qwen3_moe_235b_a22b", dict(fsdp=True), (2, 4), 4, "ep"),
    "granite_1x8_fallback": ("granite_moe_1b_a400m", {}, (1, 8), 4, "tp"),
    "granite_batch1_2x2": ("granite_moe_1b_a400m", {}, (2, 2), 1, "ep"),
}
TRAIN_CASES = ("granite_2x2_ep", "qwen3_moe_fsdp_2x4", "granite_batch1_2x2")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capacity(cfg, factor, **over):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor),
                               **over)


def _cfgs(arch, over, factor=FACTOR, **more):
    """(the JAX config, the port's) at capacity ``factor``: ``fsdp`` only
    places the port's weights, so the JAX one-device run is the one without
    it."""
    jover = {k: v for k, v in over.items() if k != "fsdp"}
    return (_capacity(dataclasses.replace(jbase.get_smoke_config(arch), **jover), factor, **more),
            _capacity(dataclasses.replace(C.get_smoke_config(arch), **over), factor, **more))


def _key(case):
    arch, over, _, batch, _ = CASES[case]
    return arch, tuple(sorted((k, v) for k, v in over.items() if k != "fsdp")), batch


def _mesh(shape):
    return make_host_mesh(shape[1], slots=shape[0] * shape[1], device="cpu")


def _opt(cfg):
    return dict(total_steps=10, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)


@contextlib.contextmanager
def _jax_drops():
    """The reference's own count of dropped assignments, one entry a
    ``_moe_dispatch`` call traced inside the block (summed over a
    ``vmap``'s chunks), from its router's top-k and the capacity, through
    ``jax.debug.callback``."""
    got = []
    orig = JL._moe_dispatch

    def probe(params, cfg, xt, cap):
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, params["router"]).astype(jnp.float32))
        eidx = jax.lax.top_k(probs, cfg.moe.top_k)[1]
        counts = jnp.zeros(cfg.moe.n_experts, jnp.int32).at[eidx.reshape(-1)].add(1)
        jax.debug.callback(lambda n: got.append(int(np.sum(n))),
                           jnp.maximum(counts - cap, 0).sum())
        return orig(params, cfg, xt, cap)

    with mock.patch.object(JL, "_moe_dispatch", probe):
        yield got


def _split_apply_moe(n_data):
    """The reference's ``apply_moe`` on its split path for a mesh of
    ``n_data`` data slots: the flat tokens cut into ``n_data`` chunks, its
    own ``_moe_dispatch`` under ``jax.vmap`` with ``_moe_cap`` of a chunk,
    the mean of the aux values.  A decode step (no sharding context) and a
    token count ``n_data`` does not divide take its global path."""
    orig = JL.apply_moe

    def apply_moe(params, cfg, x, shd=None):
        b, s, d = x.shape
        t = b * s
        if shd is None or not (cfg.moe_sharded_dispatch and t % n_data == 0):
            return orig(params, cfg, x, shd)
        cap = JL._moe_cap(cfg, t // n_data)
        out, aux = jax.vmap(lambda xi: JL._moe_dispatch(params, cfg, xi, cap))(
            x.reshape(n_data, t // n_data, d))
        return out.reshape(b, s, d), jnp.mean(aux)

    return apply_moe


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_serve():
    """Per case, computed once: the port's model, the prompt and decode
    tokens, JAX's prefill and decode steps (logits and cache after each,
    numpy) and its prefill's dropped assignments."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            arch, over, _, batch, _ = CASES[case]
            jcfg, tcfg = _cfgs(arch, over)
            model = T.init_params(4, tcfg, device="cpu")
            params = _jax_params(model, tcfg)
            r = np.random.default_rng(5)
            prompt = r.integers(0, tcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
            toks = r.integers(0, tcfg.vocab_size, (N_STEPS, batch)).astype(np.int32)
            with _jax_drops() as drops:
                logits, cache = jax.jit(lambda p, t: JT.prefill(p, jcfg, t, CACHE_LEN))(
                    params, prompt)
            dec = jax.jit(lambda p, t, c, pos: JT.decode_step(p, jcfg, t, c, pos))
            runs = [(np.asarray(logits), _np(cache))]
            for i in range(N_STEPS):
                logits, cache = dec(params, toks[i], cache, np.int32(PROMPT + i))
                runs.append((np.asarray(logits), _np(cache)))
            memo[_key(case)] = (model, prompt, toks, runs, list(drops))
        return memo[_key(case)]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_prefill_and_decode_match_jax(case, jax_serve):
    arch, over, shape, batch, layout = CASES[case]
    _, tcfg = _cfgs(arch, over)
    model, prompt, toks, runs, drops = jax_serve(case)
    assert len(drops) == tcfg.n_layers and sum(drops) > 0, drops
    mesh = _mesh(shape)

    fn, _, (p_sh, b_sh) = S.build_prefill(tcfg, C.ShapeConfig("p", "prefill", CACHE_LEN, batch),
                                          mesh)
    params = S.place(model.tree(), p_sh)
    prog = spmd._Program(params, tcfg)
    assert {spmd._moe_layout(lp["moe"]) for lp in prog.layers} == {layout}
    if over.get("fsdp"):
        assert params["layers"][0]["moe"]["w_gate"].sharding.spec[1] == "data"
    logits, cache = fn(params, S.place({"tokens": torch.as_tensor(prompt)}, b_sh))
    assert logits.shape == (batch, tcfg.vocab_size)
    np.testing.assert_allclose(logits.gather().numpy(), runs[0][0], rtol=RTOL, atol=ATOL)
    _hold_state(cache, runs[0][1], tcfg, "prefill")
    _blocks_as_specs(cache)

    step, _, (_, tok_sh, c_sh, pos_sh) = S.build_decode(
        tcfg, C.ShapeConfig("d", "decode", CACHE_LEN, batch), mesh)
    placed = S.place(T.cache_from_jax(runs[0][1], tcfg, device="cpu"), c_sh)
    for i in range(N_STEPS):
        logits, placed = step(params, tok_sh.place(torch.as_tensor(toks[i])), placed,
                              pos_sh.place(torch.tensor(PROMPT + i, dtype=torch.int32)))
        np.testing.assert_allclose(logits.gather().numpy(), runs[i + 1][0], rtol=RTOL,
                                   atol=ATOL, err_msg=f"step {i}")
        _hold_state(placed, runs[i + 1][1], tcfg, f"step {i}")


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_train():
    """N_TRAIN JAX one-device steps per case, computed once: the initial
    weights (numpy), each step's metrics, the final params and moments in
    the port's layout, and the dropped assignments of the steps."""
    memo = {}

    def get(case):
        if _key(case) not in memo:
            arch, over, _, batch, _ = CASES[case]
            jcfg, tcfg = _cfgs(arch, over)
            jopt = JO.OptConfig(**_opt(jcfg))
            params, _ = JT.init_params(jax.random.PRNGKey(5), jcfg)
            state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
            pipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=batch,
                               seq_override=SEQ)
            metrics = []
            with _jax_drops() as drops:
                jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
                for _ in range(N_TRAIN):
                    state, m = jstep(state, pipe.next_batch())
                    metrics.append({k: float(v) for k, v in m.items()})
            final = {"params": T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree(),
                     "opt": T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")}
            memo[_key(case)] = (_np(params), metrics, final, list(drops))
        return memo[_key(case)]

    return get


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_train_steps_match_jax(case, jax_train):
    arch, over, shape, batch, _ = CASES[case]
    _, tcfg = _cfgs(arch, over)
    params0, want, final, drops = jax_train(case)
    assert sum(drops) > 0
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
        assert float(m["moe_aux"]) > 0
        for k, v in want[i].items():
            rtol = GNORM_RTOL if k == "grad_norm" else RTOL_L
            np.testing.assert_allclose(float(m[k]), v, rtol=rtol, atol=ATOL_L,
                                       err_msg=f"{case} step {i} {k}")
    for g, r in zip(tree_leaves(state["opt"]["mu"]), tree_leaves(final["opt"]["mu"])):
        np.testing.assert_allclose(g.gather().float().numpy(), r.float().numpy(), rtol=TOL_MU[0],
                                   atol=TOL_MU[1], err_msg=f"{case} mu")
    far = total = 0
    for g, r in zip(tree_leaves(state["params"]), tree_leaves(final["params"])):
        gap = (g.gather() - r).abs()
        assert gap.max().item() <= 2 * lr_sum + ATOL, (case, gap.max().item())
        far += int((gap > ATOL + RTOL * r.abs()).sum())
        total += gap.numel()
    assert far <= FLIP_SHARE * total, (case, far, total)


# --------------------------------------------------------------------------
# the three layouts, both presets
# --------------------------------------------------------------------------

# (arch, model axis, layout): granite's 4 experts and qwen3_moe's 8 split on
# 2 slots; on 3 (granite also 8) only d_expert 96 divides; on 5 nothing does.
LAYOUTS = [("granite_moe_1b_a400m", 2, "ep"), ("granite_moe_1b_a400m", 3, "tp"),
           ("granite_moe_1b_a400m", 5, None), ("qwen3_moe_235b_a22b", 2, "ep"),
           ("qwen3_moe_235b_a22b", 3, "tp"), ("qwen3_moe_235b_a22b", 5, None)]


@pytest.mark.parametrize("arch,model_axis,layout", LAYOUTS)
def test_layouts_run_both_presets(arch, model_axis, layout):
    """``spmd.prefill``, ``decode_step`` and ``loss_fn`` with its gradient
    on 2 × ``model_axis`` slots in each MoE layout, against the one-device
    port (which ``tests/test_torch_moe.py`` holds to JAX) at the serving
    tolerance, capacity 0.5."""
    _, cfg = _cfgs(arch, {})
    model = T.init_params(2, cfg, device="cpu")
    b, s = 2, 8
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s + 1)))
    mesh = make_host_mesh(model_axis, slots=2 * model_axis, device="cpu")
    _, _, (st_sh, _) = S.build_train(cfg, C.ShapeConfig("t", "train", s, b), mesh)
    params = S.place(model.tree(), st_sh["params"])
    assert spmd._moe_layout(spmd._Program(params, cfg).layers[0]["moe"]) == layout
    want, cache = T.prefill(model, cfg, toks[:, :s], s + 1)
    got, pc = spmd.prefill(params, cfg, toks[:, :s], s + 1)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    want, _ = T.decode_step(model, cfg, toks[:, s], cache, s)
    got, _ = spmd.decode_step(params, cfg, toks[:, s], pc, s)
    np.testing.assert_allclose(got.gather().numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    batch = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    wl, wm, wg = S.loss_and_grads(model, cfg, batch)
    gl, gm, gg = S._slot_grads(params, cfg, batch)
    for k in ("xent", "moe_aux"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=RTOL_L, atol=ATOL_L)
    for a, g, w in zip(tree_leaves(params), gg, tree_leaves(wg)):
        np.testing.assert_allclose(SlotArray(a.sharding, a.shape, g).gather().numpy(), w.numpy(),
                                   rtol=TOL_G[0], atol=TOL_G[1])


# --------------------------------------------------------------------------
# the per-data-shard dispatch
# --------------------------------------------------------------------------

def test_moe_sharded_dispatch_equivalence():
    """The port's copy of ``tests/test_distributed.py::test_moe_sharded_
    dispatch_equivalence``: on 8 × 1 slots, 8 rows of 16 tokens at capacity
    16 (nothing dropped), the per-data-shard dispatch equals the global one
    within 1e-4 — the one-device ``forward_seq`` with that mesh's
    ``ShardingCtx``, and the slot program's prefill (logits and every cache
    leaf, which later layers compute from the MoE layers' output)."""
    cfg = jbase.get_smoke_config("granite_moe_1b_a400m")
    params, _ = JT.init_params(jax.random.PRNGKey(0), cfg)
    hi = _capacity(C.get_smoke_config("granite_moe_1b_a400m"), 16.0)
    sh = dataclasses.replace(hi, moe_sharded_dispatch=True)
    model = T.params_from_jax(_np(params), hi, device="cpu")
    mesh = make_host_mesh(1, slots=8, device="cpu")
    shd = ShardingCtx.for_mesh(mesh, seq_shard=False)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    assert L.moe_chunks(sh, toks.size, 8) == 8
    h1 = T.forward_seq(model, hi, toks, shd)[0]
    h2 = T.forward_seq(model, sh, toks, shd)[0]
    assert float((h1 - h2).abs().max()) < 1e-4
    outs = []
    for cfg_ in (hi, sh):
        fn, _, (p_sh, b_sh) = S.build_prefill(cfg_, C.ShapeConfig("p", "prefill", 16, 8), mesh)
        logits, cache = fn(S.place(model.tree(), p_sh), S.place({"tokens": torch.as_tensor(toks)},
                                                                 b_sh))
        outs.append([logits.gather()] + [a.gather() for a in tree_leaves(cache)])
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) < 1e-4


@pytest.mark.parametrize("rows", [4, 1], ids=["rows_split", "seq_cut"])
def test_sharded_dispatch_layer_matches_jax(rows):
    """``apply_moe`` with a 2-data-slot mesh's ``ShardingCtx`` against the
    reference's split path where it drops assignments: 4 rows of 16 tokens
    (a chunk a data slot's rows) and one row of 64 (the chunks cut through
    the sequence; a chunk of 8 tokens cannot drop, as an expert takes a
    token once and holds at least 8)."""
    jcfg, tcfg = _cfgs("granite_moe_1b_a400m", {}, moe_sharded_dispatch=True)
    p, _ = JL.init_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(1).normal(size=(rows, 64 // rows, jcfg.d_model)).astype(np.float32)
    shd = ShardingCtx.for_mesh(make_host_mesh(2, slots=4, device="cpu"))
    assert L.moe_chunks(tcfg, x.shape[0] * x.shape[1], 2) == 2
    with _jax_drops() as drops:
        jo, ja = jax.jit(lambda p, x: _split_apply_moe(2)(p, jcfg, x, JT.null_ctx()))(
            p, jnp.asarray(x))
    assert sum(drops) > 0
    to, ta = L.apply_moe(jax.tree.map(lambda a: torch.tensor(np.asarray(a)), p), tcfg,
                         torch.tensor(x), shd)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL_F[0], atol=TOL_F[1])
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL_F[0], atol=TOL_F[1])


@pytest.mark.parametrize("batch,seq", [(4, 16), (1, 48)], ids=["rows_split", "seq_cut"])
def test_sharded_dispatch_loss_matches_jax(batch, seq):
    """The slot program's ``loss_fn`` value and gradient on 2 × 2 slots with
    ``moe_sharded_dispatch`` against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` on its split path for 2 data slots, where it
    drops assignments: 4 rows of 16 tokens (each data group's own buffer,
    the aux the mean over the groups) and one row of 48 (every group cuts
    it into two chunks)."""
    jcfg, tcfg = _cfgs("granite_moe_1b_a400m", {}, moe_sharded_dispatch=True)
    params, _ = JT.init_params(jax.random.PRNGKey(6), jcfg)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (batch, seq + 1)).astype(
        np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with mock.patch.object(JL, "apply_moe", _split_apply_moe(2)), _jax_drops() as drops:
        (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b),
                                                  has_aux=True))(params)
    assert sum(drops) > 0
    model = T.params_from_jax(_np(params), tcfg, device="cpu")
    mesh = make_host_mesh(2, slots=4, device="cpu")
    _, _, (st_sh, _) = S.build_train(tcfg, C.ShapeConfig("t", "train", seq, batch), mesh)
    placed = S.place(model.tree(), st_sh["params"])
    loss, m, grads = S._slot_grads(placed, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL_L, atol=ATOL_L)
    for k in ("xent", "moe_aux"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL_L, atol=ATOL_L)
    want = tree_leaves(T.params_from_jax(_np(jg), tcfg, device="cpu").tree())
    for i, (a, g, w) in enumerate(zip(tree_leaves(placed), grads, want)):
        np.testing.assert_allclose(SlotArray(a.sharding, a.shape, g).gather().numpy(), w.numpy(),
                                   rtol=TOL_G[0], atol=TOL_G[1], err_msg=f"gradient leaf {i}")


# --------------------------------------------------------------------------
# meta against the loops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,mshape", [("granite_moe_1b_a400m", "train", (2, 2)),
                                             ("qwen3_moe_235b_a22b", "prefill", (2, 4))])
def test_moe_meta_trace_equals_the_loops(arch, kind, mshape):
    """An MoE smoke cell traced on CPU slots (real routing, drops at
    capacity 0.5) and on ``meta`` slots (shapes alone) records the same
    collectives on every slot and the same per-slot output bytes: no
    buffer's shape depends on the data."""
    _, cfg = _cfgs(arch, {})
    shape = C.ShapeConfig(kind, kind, 12, 4)
    mesh = make_host_mesh(mshape[1], slots=mshape[0] * mshape[1], device="cpu")
    cpu_rec, cpu_out = _trace_on_cpu(cfg, shape, mesh)
    meta_rec, meta_out = dryrun.trace(cfg, shape, dryrun.on_meta(mesh), one_group=False)
    for field in ("bytes", "counts", "bytes_once", "counts_once"):
        a, b = getattr(cpu_rec, field), getattr(meta_rec, field)
        assert all(np.array_equal(a[k], b[k]) for k in a), field
    assert np.array_equal(cpu_out, meta_out)
    assert int(cpu_rec.counts["all-to-all"].max()) > 0
