"""The port's dense training path (``repro_torch.data.pipeline``,
``models.layers.chunked_xent``, ``models.transformer.loss_fn`` and its
remat, ``launch.steps``, ``launch.train``, the dense presets) held to the
JAX package on the same numpy inputs.

Optimizer state crosses with ``opt_state_from_jax``, batches come from each package's ``TokenPipeline``
(bit-identical), and 3 train steps run in both from that one state: the
four dense smoke presets (``yi_9b``'s at seq 80 through its 64-token flash
loop, ``llama3_405b``'s with bf16 moments, ``qwen3_14b``'s qk-norm and
GQA), ``micro_steps=2``, a scanned 4-layer stack under remat "full" and
"dots", and bf16 activations.  Each JAX reference is computed once per
module.

Tolerances, as ``tests/test_torch_models.py:13-24`` sets them.  float32:
1e-5 relative (atol 1e-5) on losses, gradient norms, learning rates and
gradients; 1e-4 relative and absolute on the parameters after each step
(a step moves a weight by up to the learning rate, 3e-4, so the bound is a
third of one step's move).  bfloat16 activations: 2^-7 relative and
absolute, one bf16 ulp (under ``jit`` XLA may keep float32 across a
fusion where the port rounds per op; an Adam step moves a weight by the
learning rate whatever the gradient's rounding, so the parameters stay
far inside the bound).  The JAX side's weights are the port's
``init_params``, restacked into its layout (``_jax_params``)."""
import dataclasses
import os
import shutil

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
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves

RTOL, ATOL = 1e-5, 1e-5
RTOL_P, ATOL_P = 1e-4, 1e-4
TOL_BF16 = 2.0 ** -7
N_STEPS = 3
BATCH, SEQ = 4, 80
DENSE = ("olmo_1b", "qwen3_14b", "yi_9b", "llama3_405b")

VARIANTS = {
    "olmo_1b": ("olmo_1b", {}),
    "qwen3_14b": ("qwen3_14b", {}),
    "yi_9b": ("yi_9b", {}),
    "llama3_405b": ("llama3_405b", {}),
    "micro2": ("olmo_1b", dict(micro_steps=2)),
    "remat_full": ("olmo_1b", dict(scan_layers=True, n_layers=4)),
    "remat_dots": ("olmo_1b", dict(scan_layers=True, n_layers=4, remat_policy="dots")),
    "bf16": ("olmo_1b", dict(dtype="bfloat16")),
}


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


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol, err_msg=what)


def _jax_params(model, cfg):
    """The port's weights in the JAX package's layout (the inverse of
    ``params_from_jax``): the scanned groups stacked on a leading axis
    under ``blocks``, the tail under ``rem``."""
    plan = T.layer_plan(cfg)
    tree = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), model.tree())
    n, lp = plan.n_groups * len(plan.pattern), len(plan.pattern)
    blocks = [jax.tree.map(lambda *xs: jnp.stack(xs), *tree["layers"][pos:n:lp])
              for pos in range(lp)] if plan.n_groups else []
    return {"embed": tree["embed"], "final_norm": tree["final_norm"], "blocks": blocks,
            "rem": tree["layers"][n:]}


def _port_leaves(params_np, tcfg):
    """A JAX parameter (or gradient) tree's leaves in the port's order."""
    return tree_leaves(T.params_from_jax(params_np, tcfg, device="cpu").tree())


@pytest.fixture(scope="module", params=list(VARIANTS))
def steps_run(request):
    """N_STEPS train steps in both packages from one state; the JAX
    metrics and parameters after every step."""
    arch, over = VARIANTS[request.param]
    jcfg, tcfg = _cfgs(arch, **over)
    kw = dict(total_steps=10, warmup_steps=1, moment_dtype=jcfg.opt_state_dtype)
    jopt, topt = JO.OptConfig(**kw), O.OptConfig(**kw)
    model = T.init_params(2, tcfg, device="cpu")
    params = _jax_params(model, tcfg)
    state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
    tstate = {"params": model,
              "opt": T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")}
    jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
    pipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=BATCH, seq_override=SEQ)
    want = []
    for _ in range(N_STEPS):
        state, m = jstep(state, pipe.next_batch())
        want.append(({k: float(v) for k, v in m.items()}, _np(state["params"])))
    tol = (TOL_BF16, TOL_BF16) if jcfg.dtype == "bfloat16" else None
    return dict(name=request.param, tcfg=tcfg, topt=topt, tstate=tstate, want=want, tol=tol)


def test_train_steps_match_jax(steps_run):
    r = steps_run
    tcfg = r["tcfg"]
    step = S.make_train_step(tcfg, r["topt"])
    pipe = TokenPipeline(tcfg, C.SHAPES["train_4k"], batch_override=BATCH, seq_override=SEQ)
    state = r["tstate"]
    for i, (jm, jparams) in enumerate(r["want"]):
        state, m = step(state, pipe.next_batch("cpu"))
        assert set(m) == set(jm) == {"loss", "xent", "moe_aux", "grad_norm", "lr"}
        for k in ("loss", "xent", "grad_norm", "lr"):
            rtol, atol = r["tol"] or (RTOL, ATOL)
            _close(m[k], jm[k], rtol, atol, f"{r['name']} step {i} {k}")
        assert m["moe_aux"].item() == jm["moe_aux"] == 0.0
        rtol, atol = r["tol"] or (RTOL_P, ATOL_P)
        for got, want in zip(tree_leaves(state["params"].tree()),
                             _port_leaves(jparams, tcfg)):
            _close(got, want, rtol, atol, f"{r['name']} params after step {i}")
    assert int(state["opt"]["count"]) == N_STEPS
    moment_dt = C.torch_dtype(tcfg.opt_state_dtype)
    assert all(mu.dtype == moment_dt for mu in tree_leaves(state["opt"]["mu"]))


def test_chunked_xent_matches_jax():
    """Ragged: seq 20 in chunks of 8 (padded to 24), a mask with zeros;
    the value and the gradients with respect to x and the unembedding."""
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 20, 16)).astype(np.float32)
    w = (r.normal(size=(16, 40)) / 4.0).astype(np.float32)
    labels = r.integers(0, 40, (2, 20)).astype(np.int32)
    mask = (r.random((2, 20)) < 0.8).astype(np.float32)

    def jloss(x, w):
        return JL.chunked_xent(lambda xc: xc @ w, x, jnp.asarray(labels), jnp.asarray(mask),
                               chunk=8)

    jv, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    tv = L.chunked_xent(lambda xc: xc @ tw, tx, torch.tensor(labels).long(),
                        torch.tensor(mask), chunk=8)
    tgx, tgw = torch.autograd.grad(tv, (tx, tw))
    _close(tv, jv, RTOL, ATOL)
    _close(tgx, jgx, RTOL, ATOL)
    _close(tgw, jgw, RTOL, ATOL)
    with torch.no_grad():                                     # no checkpoint, same value
        assert L.chunked_xent(lambda xc: xc @ tw, tx, torch.tensor(labels).long(),
                              torch.tensor(mask), chunk=8).item() == tv.item()
    zero = L.chunked_xent(lambda xc: xc @ tw, tx, torch.tensor(labels).long(),
                          torch.zeros(2, 20), chunk=8)
    assert zero.item() == 0.0                                 # sum / max(0, 1)


@pytest.mark.parametrize("arch", ["olmo_1b", "yi_9b"])
def test_loss_fn_value_and_grad_match_jax(arch):
    """``loss_fn`` with a ``loss_mask`` against ``jax.value_and_grad``:
    the tied (olmo) and the untied (yi) unembedding, every gradient."""
    jcfg, tcfg = _cfgs(arch)
    model = T.init_params(3, tcfg, device="cpu")
    b = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=2, seq_override=24).peek(4)
    b["loss_mask"] = (np.random.default_rng(6).random(b["labels"].shape) < 0.7).astype(
        np.float32)
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: JT.loss_fn(p, jcfg, b), has_aux=True))(
        _jax_params(model, tcfg))
    tl, tm, tg = S.loss_and_grads(model, tcfg, {k: torch.as_tensor(v) for k, v in b.items()})
    _close(tl, jl, RTOL, ATOL)
    _close(tm["xent"], jm["xent"], RTOL, ATOL)
    assert tm["moe_aux"].item() == 0.0
    for got, want in zip(tree_leaves(tg), _port_leaves(_np(jg), tcfg)):
        _close(got, want, RTOL, ATOL)
    assert not tl.requires_grad and all(not g.requires_grad for g in tree_leaves(tg))


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_on_and_off_identical(policy, monkeypatch):
    """Two scanned groups of (attn, local) and an unscanned tail layer, with
    the flash loop: the loss and every gradient equal with and without
    remat; remat checkpoints each scanned layer and not the tail ("dots"
    keeping matmul outputs), and never the serving path."""
    cfg = dataclasses.replace(C.get_smoke_config("olmo_1b"), scan_layers=True, n_layers=5,
                              block_pattern=("attn", "local"), window=24, attn_chunk=32,
                              remat_policy=policy)
    batch = TokenPipeline(cfg, C.SHAPES["train_4k"], batch_override=2,
                          seq_override=SEQ).next_batch("cpu")
    calls, saved = [], []
    real_ckpt, real_save = T.checkpoint, T._save_dots
    monkeypatch.setattr(T, "checkpoint", lambda *a, **kw: calls.append(1) or real_ckpt(*a, **kw))
    monkeypatch.setattr(T, "_save_dots", lambda *a, **kw: saved.append(real_save(*a, **kw))
                        or saved[-1])
    out = {}
    for remat in (True, False):
        model = T.init_params(4, dataclasses.replace(cfg, remat=remat), device="cpu")
        calls.clear()
        out[remat] = S.loss_and_grads(model, dataclasses.replace(cfg, remat=remat), batch)
        assert len(calls) == (4 if remat else 0)      # the 4 scanned layers, not the tail
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)
    from torch.utils.checkpoint import CheckpointPolicy
    assert (CheckpointPolicy.MUST_SAVE in saved) == (policy == "dots")
    calls.clear()
    T.prefill(model, cfg, batch["tokens"][:, :16], 16)   # serving: no checkpoint
    assert not calls


def test_token_pipeline_matches_jax():
    """Bit-identical batches at several steps; int64 tensors on the device;
    the cursor's save / load round trip and the seed check."""
    for arch in DENSE:
        jcfg, tcfg = _cfgs(arch)
        kw = dict(seed=3, batch_override=2, seq_override=24)
        jp = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], **kw)
        tp = TokenPipeline(tcfg, C.SHAPES["train_4k"], **kw)
        for step in (0, 1, 7, 123):
            want, got = jp.peek(step), tp.peek(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype == np.int32
    tp = TokenPipeline(tcfg, C.SHAPES["train_4k"], seed=3, batch_override=2, seq_override=24)
    for step in range(3):
        b = tp.next_batch("cpu")
        assert b["tokens"].dtype == torch.int64 and b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["labels"].numpy(), jp.peek(step)["labels"])
    sd = tp.state_dict()
    assert sd == {"step": 3, "seed": 3}
    fresh = TokenPipeline(tcfg, C.SHAPES["train_4k"], seed=3, batch_override=2, seq_override=24)
    fresh.load_state_dict(sd)
    np.testing.assert_array_equal(fresh.next_batch("cpu")["tokens"].numpy(), jp.peek(3)["tokens"])
    with pytest.raises(AssertionError, match="seed mismatch"):
        TokenPipeline(tcfg, C.SHAPES["train_4k"], seed=4).load_state_dict(sd)
    specs = S.batch_specs(tcfg, C.ShapeConfig("t", "train", 24, 2))
    assert {k: (tuple(v.shape), v.dtype, v.device.type) for k, v in specs.items()} == {
        "tokens": ((2, 24), torch.int64, "meta"), "labels": ((2, 24), torch.int64, "meta")}


def test_dense_presets_are_the_reference_presets():
    for arch in DENSE:
        for get in ("get_config", "get_smoke_config"):
            assert dataclasses.asdict(getattr(C, get)(arch)) == \
                dataclasses.asdict(getattr(jbase, get)(arch)), (arch, get)
    assert C.get_config("llama3_405b").param_dtype == "bfloat16"
    assert C.get_smoke_config("llama3_405b").opt_state_dtype == "bfloat16"


def _main(ckpt, *extra):
    return train.main(["--smoke", "--device", "cpu", "--steps", "12", "--batch", "4",
                       "--seq", "32", "--checkpoint-every", "5", "--ckpt-dir", str(ckpt),
                       "--log-every", "100", *extra])


def test_train_main_fault_drill_and_resume(tmp_path, capsys):
    """The trainer on the CPU: a fault at step 7 restores step 5 and replays
    to the same losses and parameters as an uninterrupted run; the loss
    improves; ``--resume`` after the last checkpoint is lost continues from
    step 10 with the pipeline cursor, to the same losses and parameters."""
    clean = _main(tmp_path / "clean")
    drill = _main(tmp_path / "drill", "--inject-fault", "7")
    assert clean.report.completed and clean.report.restarts == 0
    assert drill.report.completed and drill.report.restarts == 1
    assert drill.report.failures == [(7, "RuntimeError('injected fault at step 7')")]
    assert [s for s, _ in drill.losses] == [0, 1, 2, 3, 4, 5, 6, 5, 6, 7, 8, 9, 10, 11]
    assert dict(drill.losses) == dict(clean.losses)
    out = capsys.readouterr().out
    assert "[train] restored step 5" in out and "(improved)" in out
    first, last = (np.mean([l for _, l in clean.losses[s]]) for s in (slice(0, 5), slice(-5, None)))
    assert last < first
    final = [p.detach().clone() for p in clean.state["params"].parameters()]
    assert all(torch.equal(a, b) for a, b in zip(final, drill.state["params"].parameters()))
    # the last save (step 12) lost: --resume continues from step 10
    shutil.rmtree(tmp_path / "drill" / "step-000000012")
    os.remove(tmp_path / "drill" / "LATEST")
    resumed = _main(tmp_path / "drill", "--resume")
    assert resumed.report.completed and resumed.report.restarts == 0
    assert resumed.losses == [(10, dict(clean.losses)[10]), (11, dict(clean.losses)[11])]
    assert "[train] restored step 10" in capsys.readouterr().out
    assert all(torch.equal(a, b) for a, b in zip(final, resumed.state["params"].parameters()))


def test_train_main_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cuda' was requested"):
        train.main(["--smoke", "--steps", "1"])
