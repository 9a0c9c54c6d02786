"""The dry run: trace every (arch × shape × mesh) cell on ``meta`` slots —
port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's step with ``jax.jit`` for a
(16, 16) pod and a (2, 16, 16) multi-pod mesh of fake devices and reads
XLA's memory and cost analysis and the collectives of the HLO text.  The
port has no compiler to lean on: it runs the cell's own step
(``launch.steps.build_cell``) on ``make_production_mesh(device="meta")``,
256 or 512 slots whose tensors have shapes and no storage, with the slot
program recording its collectives (``models/spmd.record_collectives``).
The record keeps the reference's keys where the port has the number:

  * ``memory_analysis``: per-slot argument bytes from the placement of the
    cell's inputs, output bytes from the traced outputs' blocks (no temp
    figure: see ``hlo_analysis``);
  * ``collective_bytes`` / ``collective_bytes_weighted`` /
    ``collective_counts`` from the record (no ``cost_analysis``,
    ``t_compile_s`` or ``hlo_lines``: nothing is compiled);
  * ``analytic``, ``roofline`` (on the H100's peaks), ``model_flops_global``,
    ``model_flops_ratio`` as the reference computes them;
  * ``t_lower_s``: the seconds to build and trace the cell, and ``trace``:
    how it was traced.

A trace on ``meta`` costs host time per tensor op per slot, so a 256-slot
trace of 126 layers, or of the flash loop's chunk pairs at 32,768 tokens,
would take hours.  The trace therefore (1) runs attention densely
(``attn_chunk`` 0: the flash loop holds no collective and, on ``meta``,
allocates nothing either way), and (2) where the model is deeper than
three layer groups, runs the step at two depths one ``block_pattern`` group
apart and extends the record linearly to the full depth — the counterpart
of the reference weighting a scan body by its trip count.  The two depths
keep the layer plan's shape (scanned groups stay scanned, the unscanned
tail stays), so the extension is exact: equal to the full trace
(``tests/test_torch_dryrun.py``).  An encoder-decoder's encoder steps with
the decoder, one layer a group (``encoder_depths``: whisper's 32 encoder
layers are traced at 2 and 3 beside the decoder's 2 and 3), where that
keeps the encoder plan's shape; otherwise it runs at its full depth in
both traces, a constant the extension cancels.  (3) The trace runs data
group 0's slot programs alone, the other groups' outputs taken to be its
(every data group runs the same program on blocks of the same shapes; the
cross-group collectives still run over every slot).  A decode cell traces at ``pos`` =
``seq_len`` − 1 (which slot writes the new K/V changes no byte).  (4) The
recurrent scans (``rglru.linear_scan``, ``rwkv6.wkv``) hold no collective;
on ``meta`` tensors they return outputs and states of the reference's
shapes and dtypes without the loop over the tokens (``prefill_32k`` is
32,768 tokens a slot).  The stand-in is keyed on the tensors' device being
``meta``, never on a missing card: a ``cpu`` or ``cuda`` tensor always runs
the loop (``tests/test_torch_dryrun.py`` holds a smoke cell's record on CPU
slots, real loops, equal to its record on ``meta``).

A cell that fails is recorded as failed, its error kept, as the reference
records a failure.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo_1b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # 64 cells

(``--all``: the four dense presets' 24 cells, the 16 of ``rwkv6_3b`` and
``recurrentgemma_9b`` (their three base shapes and ``long_500k`` on both
meshes), and the three base shapes on both meshes of the MoE presets
``granite_moe_1b_a400m`` and ``qwen3_moe_235b_a22b``, the encoder-decoder
``whisper_large_v3`` and the VLM ``llava_next_mistral_7b``, 24 more.)

Records go to ``results/dryrun_torch/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.launch import analytic, hlo_analysis, steps
from repro_torch.launch.mesh import Mesh, make_production_mesh, mesh_chip_count
from repro_torch.models import spmd, transformer
from repro_torch.sharding import SlotArray
from repro_torch.utils import tree_leaves

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results",
                           "dryrun_torch")


def on_meta(mesh: Mesh) -> Mesh:
    """``mesh``'s axes with every slot on ``meta``."""
    return Mesh(mesh.axis_names, mesh.sizes, ("meta",) * len(mesh.slot_devices))


def trace_depths(cfg):
    """(d1, d2, k): trace at depths d1 and d2 = d1 + one pattern group and
    extend by k groups past d1; or None: trace the full depth."""
    lp = len(cfg.block_pattern)
    g0 = 2 if (cfg.scan_layers and cfg.n_layers >= 2 * lp) else 1
    r = cfg.n_layers - (cfg.n_layers // lp) * lp
    d1, d2 = g0 * lp + r, (g0 + 1) * lp + r
    if cfg.n_layers <= d2:
        return None
    return d1, d2, (cfg.n_layers - d1) // lp


def encoder_depths(cfg, k: int):
    """(e1, e1 + 1): an encoder-decoder's encoder depths for the two traces
    of ``trace_depths``, one layer a decoder group, so that extending by
    ``k`` groups reaches both full depths; or None, the encoder at its full
    depth in both traces (a constant the extension cancels): no encoder, or
    an ``e1`` that would change the encoder plan's shape (scanned or not)."""
    n = cfg.n_encoder_layers
    if not n or n - k < 1:
        return None
    scanned = lambda e: transformer.encoder_plan(
        dataclasses.replace(cfg, n_encoder_layers=e)).n_groups > 0
    e1 = n - k
    return (e1, e1 + 1) if scanned(e1) == scanned(e1 + 1) == scanned(n) else None


def _out_bytes(out, n_slots: int) -> np.ndarray:
    """Bytes of the step's outputs on each slot (a plain tensor on slot 0)."""
    per = np.zeros(n_slots, dtype=np.int64)
    for leaf in tree_leaves(out):
        if isinstance(leaf, SlotArray):
            per += np.array([leaf.slot_nbytes(s) for s in range(n_slots)], dtype=np.int64)
        elif isinstance(leaf, torch.Tensor):
            per[0] += leaf.numel() * leaf.element_size()
    return per


def trace(cfg, shape, mesh, *, one_group: bool = True):
    """(collective record, per-slot output bytes) of one run of the cell's
    step at ``cfg``'s depth, on ``mesh``'s slots as placed.  With
    ``one_group`` only data group 0's program runs (``spmd.one_data_group``:
    every data group runs the same program on blocks of the same shapes)."""
    fn, in_specs, in_shardings = steps.build_cell(cfg, shape, mesh)
    args = [steps.place(x, sh) for x, sh in zip(in_specs, in_shardings)]
    if shape.kind == "decode":
        args[3] = shape.seq_len - 1
    n = len(mesh.slot_devices)
    with spmd.record_collectives(n) as rec, \
            (spmd.one_data_group() if one_group else contextlib.nullcontext()):
        out = fn(*args)
    return rec, _out_bytes(out, n)


def traced(cfg, shape, mesh):
    """(record, per-slot output bytes, how) for the full depth, on ``meta``
    slots, scaled from two depths where ``trace_depths`` says so."""
    tcfg = dataclasses.replace(cfg, attn_chunk=0)
    depths = trace_depths(cfg)
    mesh = on_meta(mesh)
    if depths is None:
        rec, out = trace(tcfg, shape, mesh)
        return rec, out, {"depths": [cfg.n_layers], "groups_added": 0, "attn_chunk": 0}
    d1, d2, k = depths
    enc = encoder_depths(cfg, k)
    at = lambda d, j: dataclasses.replace(
        tcfg, n_layers=d, **({"n_encoder_layers": enc[j]} if enc else {}))
    r1, o1 = trace(at(d1, 0), shape, mesh)
    r2, o2 = trace(at(d2, 1), shape, mesh)
    how = {"depths": [d1, d2], "groups_added": k, "attn_chunk": 0}
    if cfg.n_encoder_layers:
        how["encoder_depths"] = list(enc) if enc else [cfg.n_encoder_layers] * 2
    return r1.combine(r2, k), o1 + k * (o2 - o1), how


def _fill(rec: dict, cfg, shape, mesh, verbose: bool) -> dict:
    t0 = time.perf_counter()
    _, in_specs, in_shardings = steps.build_cell(cfg, shape, mesh)
    record, out, how = traced(cfg, shape, mesh)
    rec["t_lower_s"] = time.perf_counter() - t0
    rec["trace"] = how
    rec["memory_analysis"] = hlo_analysis.memory_analysis_dict(
        hlo_analysis.slot_bytes(in_specs, in_shardings), int(out.max()))
    rec["collective_bytes"] = hlo_analysis.collective_bytes(record)
    rec["collective_bytes_weighted"] = hlo_analysis.collective_bytes_weighted(record)
    rec["collective_counts"] = hlo_analysis.collective_counts(record)

    chips = rec["chips"]
    costs = analytic.cell_costs(cfg, shape, mesh)
    rec["analytic"] = {
        "flops_per_device": costs.flops_per_device,
        "hbm_bytes_per_device": costs.hbm_bytes_per_device,
        "breakdown": costs.breakdown,
    }
    roof = hlo_analysis.Roofline(
        flops_per_device=costs.flops_per_device,
        hbm_bytes_per_device=costs.hbm_bytes_per_device,
        collective_bytes_per_device=rec["collective_bytes_weighted"]["total"],
        chips=chips)
    rec["roofline"] = roof.as_dict()
    mf = hlo_analysis.model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    rec["model_flops_ratio"] = mf / max(costs.flops_per_device * chips, 1.0)
    rec["ok"] = True
    if verbose:
        ma, rl = rec["memory_analysis"], rec["roofline"]
        print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: OK  "
              f"trace {rec['t_lower_s']:.1f}s (depths {how['depths']})  "
              f"argbytes/slot {ma['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"outbytes/slot {ma['output_size_in_bytes'] / 2**30:.2f}GiB  "
              f"coll/slot {rec['collective_bytes_weighted']['total'] / 2**20:.1f}MiB")
        print(f"  roofline: compute {rl['t_compute_s']:.2e}s  memory "
              f"{rl['t_memory_s']:.2e}s  collective "
              f"{rl['t_collective_s']:.2e}s  -> {rl['dominant']}-bound; "
              f"model/analytic flops ratio {rec['model_flops_ratio']:.2f}")
    return rec


def record_cell(arch: str, shape, mesh, *, multi_pod: bool = False, cfg=None,
                verbose: bool = True) -> dict:
    """The record of one cell: ``arch``'s config (or ``cfg``), ``shape`` (a
    ``ShapeConfig``) on ``mesh`` (any slot mesh: the trace runs on its
    shape, on ``meta``).  A failure is recorded, not raised."""
    rec = {
        "arch": arch, "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "multi_pod": multi_pod, "chips": mesh_chip_count(mesh), "ok": False,
    }
    try:
        _fill(rec, get_config(arch) if cfg is None else cfg, shape, mesh, verbose)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = repr(e)
        rec["traceback"] = traceback.format_exc()
        if verbose:
            print(f"[dryrun] {arch} × {shape.name} × {rec['mesh']}: FAILED — {e!r}")
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, verbose: bool = True) -> dict:
    """The reference's cell: ``arch`` × ``SHAPES[shape_name]`` on the (16, 16)
    pod or the (2, 16, 16) multi-pod mesh."""
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    return record_cell(arch, SHAPES[shape_name], mesh, multi_pod=multi_pod, verbose=verbose)


def save(rec: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default all)")
    ap.add_argument("--shape", default=None, help="one shape (default all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_fail = 0
    t0 = time.perf_counter()
    for arch in archs:
        shapes = [args.shape] if args.shape else applicable_shapes(get_config(arch))
        for shape_name in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape_name, multi_pod=mp)
                save(rec, args.out)
                n_ok += rec["ok"]
                n_fail += not rec["ok"]
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed in {time.perf_counter() - t0:.1f}s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
