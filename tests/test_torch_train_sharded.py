"""The sharded train step on CPU slot meshes (``sharding.NamedSharding`` /
``SlotArray``, ``models/spmd.py``, ``launch.steps`` on a placed state) held
to the JAX package's one-device step, the reference's own SPMD assertion,
the global gradient norm, the elastic restore and the trainer on a mesh.

The JAX reference runs ``jax.jit(make_train_step(...))`` on one device (a
GSPMD sharding never changes values; the reference's 2 × 4 test,
``tests/test_distributed.py:151-179``, does not run under this jax), from
the port's ``init_params`` carried across (``test_torch_train._jax_params``)
and each package's bit-identical ``TokenPipeline``.  The port places the
same weights on a slot mesh and runs 2 steps; its losses, metrics and
gathered masters and moments are held to JAX's: ``olmo_1b`` on 2 × 4 (every
weight sharded over "model"), ``qwen3_14b`` on 2 × 4 (6 heads: attention
replicated, the MLP and vocabulary sharded) and on 2 × 3 (Q sharded, its 2
K/V heads replicated), ``llama3_405b`` with ``fsdp`` on 2 × 2 (every embed
dim, norm scales too, sharded over "data"), and ``micro_steps=2``.

Tolerances, as ``tests/test_torch_train.py`` sets them: 1e-5 relative
(atol 1e-5) on losses, gradient norms and learning rates; 1e-4 relative and
absolute on the masters after each step (a third of one step's 3e-4 move).
The slot program adds float32 reorderings (partial sums over the model
slots, a gradient summed over its replicas), each a few ulps.  The moments
are linear and quadratic in the gradient: ``mu`` to 1e-4 relative and 1e-5
absolute, ``nu`` (values to ~1e-3) to 1e-4 relative and 1e-8 absolute;
``llama3_405b``'s bfloat16 moments to 2^-7 relative, one bf16 ulp (a
reordered float32 value may round to the neighbouring bf16 value)."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import TokenPipeline as JaxPipeline
from repro.launch import steps as JS
from repro import optim as JO
from repro_torch import configs as C
from repro_torch import optim as O
from repro_torch import sharding as SH
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import TokenPipeline
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.utils import tree_leaves
from test_torch_train import _jax_params, _np

RTOL, ATOL = 1e-5, 1e-5
RTOL_P, ATOL_P = 1e-4, 1e-4
TOL_MU, TOL_NU = (1e-4, 1e-5), (1e-4, 1e-8)
TOL_BF16 = 2.0 ** -7
N_STEPS = 2
BATCH, SEQ = 4, 32

CASES = {
    "olmo_2x4": ("olmo_1b", {}, (2, 4)),
    "qwen3_2x4": ("qwen3_14b", {}, (2, 4)),
    "qwen3_2x3": ("qwen3_14b", {}, (2, 3)),
    "llama3_fsdp_2x2": ("llama3_405b", dict(fsdp=True), (2, 2)),
    "micro2_2x4": ("olmo_1b", dict(micro_steps=2), (2, 4)),
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


def _opt(cfg):
    return dict(total_steps=10, warmup_steps=1, moment_dtype=cfg.opt_state_dtype)


def _pipe(cfg):
    return TokenPipeline(cfg, C.SHAPES["train_4k"], batch_override=BATCH, seq_override=SEQ)


def _mesh(shape):
    return make_host_mesh(shape[1], slots=shape[0] * shape[1], device="cpu")


def _placed_state(model, tcfg, topt, shape):
    """``model``'s weights and fresh moments placed on a ``shape`` mesh, and
    the sharded step."""
    fn, _, (st_sh, _) = S.build_train(tcfg, C.SHAPES["train_4k"], _mesh(shape), topt)
    return S.init_placed_state(model.tree(), topt, st_sh), fn


@pytest.fixture(scope="module")
def jax_runs():
    """N_STEPS JAX one-device steps per (arch, overrides), computed once:
    the port's initial model, each step's metrics, and the final params and
    moments in the port's layout."""
    memo = {}

    def get(arch, over):
        key = (arch, tuple(sorted(over.items())))
        if key not in memo:
            jcfg, tcfg = _cfgs(arch, **over)
            jopt = JO.OptConfig(**_opt(jcfg))
            model = T.init_params(2, tcfg, device="cpu")
            params = _jax_params(model, tcfg)
            state = {"params": params, "opt": JO.init_opt_state(params, jopt)}
            jstep = jax.jit(JS.make_train_step(jcfg, jopt, None))
            pipe = JaxPipeline(jcfg, jbase.SHAPES["train_4k"], batch_override=BATCH,
                               seq_override=SEQ)
            metrics = []
            for _ in range(N_STEPS):
                state, m = jstep(state, pipe.next_batch())
                metrics.append({k: float(v) for k, v in m.items()})
            final = {"params": T.params_from_jax(_np(state["params"]), tcfg, device="cpu").tree(),
                     "opt": T.opt_state_from_jax(_np(state["opt"]), tcfg, device="cpu")}
            memo[key] = (model, metrics, final)
        return memo[key]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_steps_match_jax(case, jax_runs):
    arch, over, shape = CASES[case]
    _, tcfg = _cfgs(arch, **over)
    model0, want, final = jax_runs(arch, over)
    model = T.init_params(2, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), model0.parameters()))
    topt = O.OptConfig(**_opt(tcfg))
    state, step = _placed_state(model, tcfg, topt, shape)
    for arr in tree_leaves(state):          # each slot's block as the spec cuts it
        assert [tuple(b.shape) for b in arr.blocks] == \
            [arr.sharding.shard_shape(arr.shape)] * len(arr.blocks)
    pipe = _pipe(tcfg)
    for i in range(N_STEPS):
        state, m = step(state, pipe.next_batch("cpu"))
        for k, v in want[i].items():
            np.testing.assert_allclose(float(m[k]), v, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{case} step {i} {k}")
    for name, got, ref, (rtol, atol) in (
            ("params", state["params"], final["params"], (RTOL_P, ATOL_P)),
            ("mu", state["opt"]["mu"], final["opt"]["mu"], TOL_MU),
            ("nu", state["opt"]["nu"], final["opt"]["nu"], TOL_NU)):
        for g, r in zip(tree_leaves(got), tree_leaves(ref)):
            if g.dtype == torch.bfloat16:        # one bf16 ulp of a rounding boundary
                rtol = max(rtol, TOL_BF16)
            np.testing.assert_allclose(g.gather().float().numpy(), r.float().numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{case} {name}")
    assert int(state["opt"]["count"].gather()) == N_STEPS
    assert all(int(b) == N_STEPS for b in state["opt"]["count"].blocks)


def test_train_step_spmd_on_host_mesh():
    """The reference's 2 × 4 DP × TP test on CPU slots: ``qwen3_14b``'s smoke
    config, ``seq_shard=False``, 8 steps; every loss finite and the mean of
    the last three below the first three's."""
    cfg = C.get_smoke_config("qwen3_14b")
    mesh = _mesh((2, 4))
    shd = SH.ShardingCtx.for_mesh(mesh, seq_shard=False)
    model = T.init_params(0, cfg, device="cpu")
    opt_cfg = O.OptConfig(total_steps=10, warmup_steps=1)
    shardings = shd.param_shardings(model.tree(), T.param_specs(cfg))
    state = {"params": S.place(model.tree(), shardings),
             "opt": S.place(O.init_opt_state(model.tree(), opt_cfg),
                            {"mu": shardings, "nu": shardings,
                             "count": SH.NamedSharding(mesh, SH.PartitionSpec())})}
    step = S.make_train_step(cfg, opt_cfg, shd)
    pipe = _pipe(cfg)
    losses = []
    for _ in range(8):
        state, m = step(state, pipe.next_batch("cpu"))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_grad_norm_counts_each_element_once():
    """One step's ``grad_norm`` on one device, 2 × 4 and 4 × 2 agrees within
    float32 reordering: a replica counted twice would scale it by up to √2
    (2 data replicas) or √m."""
    cfg = C.get_smoke_config("olmo_1b")
    topt = O.OptConfig(**_opt(cfg))
    batch = _pipe(cfg).next_batch("cpu")
    model = T.init_params(3, cfg, device="cpu")
    _, one = S.make_train_step(cfg, topt)(
        {"params": model, "opt": O.init_opt_state(model.tree(), topt)}, batch)
    ref = float(one["grad_norm"])
    for shape in ((2, 4), (4, 2)):
        state, step = _placed_state(T.init_params(3, cfg, device="cpu"), cfg, topt, shape)
        got = float(step(state, batch)[1]["grad_norm"])
        assert got == pytest.approx(ref, rel=RTOL), shape
        for f in (math.sqrt(2), 2.0, math.sqrt(shape[1])):
            assert abs(got / ref - f) > 0.1, (shape, f)


def test_elastic_restore_onto_other_meshes(tmp_path):
    """A 2 × 4 state saved once restores onto 4 × 2 and onto one device
    (``P()`` over a one-slot mesh) bit for bit, and a step from the 4 × 2
    restore stays within the step tolerance of the 2 × 4 state's."""
    cfg = C.get_smoke_config("olmo_1b")
    topt = O.OptConfig(**_opt(cfg))
    state, step = _placed_state(T.init_params(4, cfg, device="cpu"), cfg, topt, (2, 4))
    pipe = _pipe(cfg)
    state, _ = step(state, pipe.next_batch("cpu"))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, state)
    saved = [a.gather() for a in tree_leaves(state)]
    _, _, (sh42, _) = S.build_train(cfg, C.SHAPES["train_4k"], _mesh((4, 2)), topt)
    got42, _, at = mgr.restore(state, shardings=sh42)
    one = SH.NamedSharding(make_host_mesh(device="cpu"), SH.PartitionSpec())
    got1, _, _ = mgr.restore(state, shardings=one)
    assert at == 1
    for want, a42, a1 in zip(saved, tree_leaves(got42), tree_leaves(got1)):
        assert a42.sharding.mesh.sizes == (4, 2) and len(a1.blocks) == 1
        assert torch.equal(a42.gather(), want) and torch.equal(a1.blocks[0], want)
        assert a1.blocks[0].dtype == want.dtype
    batch = pipe.next_batch("cpu")
    _, m24 = step(state, batch)
    _, m42 = S.build_train(cfg, C.SHAPES["train_4k"], _mesh((4, 2)), topt)[0](got42, batch)
    for k in ("loss", "grad_norm"):
        assert float(m42[k]) == pytest.approx(float(m24[k]), rel=RTOL), k


def test_trainer_on_slot_mesh_survives_fault(tmp_path):
    """``launch/train.py --model-axis 2 --slots 4`` with ``--inject-fault``:
    one restart, ``completed=True``, the replayed steps' losses equal to an
    uninterrupted run's, and the state placed on the 2 × 2 mesh."""
    flags = ["--arch", "olmo_1b", "--smoke", "--device", "cpu", "--model-axis", "2",
             "--slots", "4", "--steps", "8", "--batch", "4", "--seq", "32",
             "--checkpoint-every", "3", "--log-every", "100"]
    clean = train.main(flags + ["--ckpt-dir", str(tmp_path / "clean")])
    run = train.main(flags + ["--ckpt-dir", str(tmp_path / "drill"), "--inject-fault", "5"])
    assert clean.report.completed and clean.report.restarts == 0
    assert run.report.completed and run.report.restarts == 1
    assert [s for s, _ in run.losses] == [0, 1, 2, 3, 4, 3, 4, 5, 6, 7]
    want = dict(clean.losses)
    assert all(want[s] == l for s, l in run.losses)
    arr = run.state["params"]["embed"]["tok"]
    assert arr.sharding.mesh.sizes == (2, 2) and arr.sharding.spec == SH.PartitionSpec("model", None)
