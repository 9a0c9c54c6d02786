"""Training driver: data pipeline -> train step -> checkpoints, under the
fault-tolerance supervisor — port of ``repro/launch/train.py``.

Runs on the card unless ``--device cpu`` is given; ``--smoke`` takes the
reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \
        --steps 50 --batch 8 --seq 128 --device cpu

Fault tolerance wiring, as in the reference:
  * every ``--checkpoint-every`` steps the full state (the masters, the
    AdamW moments and count, the pipeline cursor) is saved, async and
    atomic (``CheckpointManager``);
  * the Supervisor catches a step's failure, restores the latest durable
    checkpoint and resumes (``--inject-fault`` raises once at a step);
  * per-step times feed the StragglerDetector; ``--resume`` starts from
    the latest durable step.

The state is ``{"params": <the Transformer>, "opt": {"mu", "nu",
"count"}}``; a restore writes the checkpoint's tensors into it in place.
On a mesh of more than one slot (``--model-axis`` as the reference has it;
``--slots``, the counterpart of its fake-device count, default one per
card) ``main`` places the state by ``param_shardings`` before the first
step — the params tree and the moments as ``SlotArray``s — and the step is
the sharded one; a restore lays the checkpoint onto the mesh through
``CheckpointManager.restore(shardings=...)``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo_1b --smoke \
        --steps 12 --batch 4 --seq 32 --model-axis 2 --slots 4 --device cpu

One departure from the reference's driver: a restart first waits for the
save in flight (the reference restores at once, and finds no durable
step when a fault comes before the first write has landed).
``main`` returns a ``TrainRun``: the supervisor's report, the state, and
every executed step's loss in execution order.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import SHAPES, get_config, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import build_train, init_placed_state, make_train_step
from repro_torch.models import transformer
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime import RunReport, StragglerDetector, Supervisor, SupervisorConfig
from repro_torch.sharding import ShardingCtx, SlotArray
from repro_torch.utils import resolve_device, tree_leaves


@dataclasses.dataclass
class TrainRun:
    report: RunReport
    state: Dict[str, Any]
    losses: List[Tuple[int, float]]     # (step, loss) of every executed step, in order


def state_tree(state) -> Dict[str, Any]:
    """The train state as a tree of tensors or ``SlotArray``s (what a
    checkpoint holds)."""
    params = state["params"]
    return {"params": params.tree() if isinstance(params, transformer.Transformer) else params,
            "opt": state["opt"]}


@torch.no_grad()
def load_state(state, tree) -> None:
    """Write a restored tree's tensors (or placed blocks) into ``state`` in
    place."""
    dst = tree_leaves(state_tree(state))
    src = tree_leaves(tree)
    if len(dst) != len(src):
        raise ValueError(f"checkpoint holds {len(src)} tensors, the state {len(dst)}")
    for d, s in zip(dst, src):
        if isinstance(d, SlotArray):
            for db, sb in zip(d.blocks, s.blocks):
                db.copy_(sb)
        else:
            d.copy_(torch.as_tensor(s))


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo_1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--slots", type=int, default=None,
                    help="logical slots of the (data, model) mesh (default: one per card)")
    ap.add_argument("--inject-fault", type=int, default=-1,
                    help="step at which to raise once (FT demo)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = SHAPES[args.shape]
    mesh = make_host_mesh(model=args.model_axis, device=dev, slots=args.slots)
    shd = ShardingCtx.for_mesh(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)
    opt_cfg = OptConfig(peak_lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 10, 1),
                        moment_dtype=cfg.opt_state_dtype)
    sharded = len(mesh.slot_devices) > 1

    pipe = TokenPipeline(cfg, shape, batch_override=args.batch,
                         seq_override=args.seq)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)

    model = transformer.init_params(0, cfg, device=dev)
    shardings = None
    if sharded:
        step_fn, _, (shardings, _) = build_train(cfg, shape, mesh, opt_cfg)
        state = init_placed_state(model.tree(), opt_cfg, shardings)
        del model
        print(f"[train] {len(mesh.slot_devices)} slots, mesh {dict(mesh.shape)}")
    else:
        state = {"params": model, "opt": init_opt_state(model.tree(), opt_cfg)}
        step_fn = make_train_step(cfg, opt_cfg, shd)
    detector = StragglerDetector(n_hosts=1)
    faults = {"pending": args.inject_fault}
    losses: List[Tuple[int, float]] = []

    def save_fn(step, st):
        ckpt.save(step, state_tree(st), extra=pipe.state_dict())

    def restore_fn():
        # The failure was a step's, not the process's: the save in flight
        # lands before the restore looks for the latest durable step.
        ckpt.wait()
        if sharded:
            tree, extra, step = ckpt.restore(state_tree(state), shardings=shardings)
        else:
            tree, extra, step = ckpt.restore(state_tree(state), device=dev)
        load_state(state, tree)
        pipe.load_state_dict(extra)
        print(f"[train] restored step {step}")
        return state, step

    def one_step(st, step):
        if faults["pending"] == step:
            faults["pending"] = -1
            raise RuntimeError(f"injected fault at step {step}")
        t0 = time.perf_counter()
        batch = pipe.next_batch(dev)
        st, metrics = step_fn(st, batch)
        loss = float(metrics["loss"])
        losses.append((step, loss))
        dt = time.perf_counter() - t0
        stragglers = detector.update(np.array([dt]))
        if stragglers:
            print(f"[train] stragglers flagged: {stragglers}")
        if step % args.log_every == 0:
            print(f"[train] step {step:5d}  loss {loss:8.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  {dt:6.2f}s")
        return st

    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = restore_fn()

    sup = Supervisor(
        SupervisorConfig(checkpoint_every=args.checkpoint_every),
        save_fn=save_fn, restore_fn=restore_fn)
    state, report = sup.run(state, one_step, start, args.steps)
    ckpt.wait()
    print(f"[train] done: step {report.final_step}, restarts "
          f"{report.restarts}, completed={report.completed}")
    if len(losses) >= 10:
        first = np.mean([l for _, l in losses[:5]])
        last = np.mean([l for _, l in losses[-5:]])
        print(f"[train] loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return TrainRun(report, state, losses)


if __name__ == "__main__":
    main()
