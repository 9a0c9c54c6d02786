"""The dry run's port (``launch/{dryrun,analytic,hlo_analysis}.py``,
``make_production_mesh``, ``transformer.cache_specs``, the in-specs of
``build_prefill`` / ``build_decode``) held to the JAX package, and the dry run itself in miniature.

Pure parts, no model built: ``cache_specs`` equals the JAX ``cache_specs``
once its scanned leaves' ``"layers"`` axis is dropped, for all ten presets
(the port's ``ModelConfig`` built from each JAX config's fields); the cache
specs resolve alike on (16, 16), (2, 16, 16) and (2, 4) meshes
(namespaces with a ``shape``: ``resolve_spec`` reads nothing else);
``build_prefill`` / ``build_decode`` / ``build_train`` give the in-specs of
the JAX ``build_*`` functions, shape for shape and dtype for dtype (token ids are int64
in the port, int32 in JAX); ``analytic.cell_costs`` and
``hlo_analysis.model_flops`` equal the JAX ones exactly for every preset,
applicable shape and mesh; the roofline's terms are quotients by the H100's
peaks.

The dry run traces on ``meta`` slots: the reference's cell
(``olmo_1b`` × ``decode_32k`` on 512 slots) succeeds with the per-slot
argument and output bytes counted by hand, and the reference's MoE cell
(``granite_moe_1b_a400m`` × ``decode_32k``) too; an unported preset is a
failed cell naming its queue item; the collectives of smoke configs (dense,
recurrent, MoE) equal a hand count; and the trace's two shortcuts — a deep model extended
from two depths, data group 0's programs alone — give the record and the
output bytes of the full trace exactly."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import analytic as janalytic
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro import sharding as JSH
from repro_torch import configs as C
from repro_torch import sharding as SH
from repro_torch.launch import analytic, dryrun, hlo_analysis, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.utils import tree_map

DENSE = ("olmo_1b", "qwen3_14b", "yi_9b", "llama3_405b")
MESHES = {"16x16": dict(data=16, model=16), "2x16x16": dict(pod=2, data=16, model=16),
          "2x4": dict(data=2, model=4)}


def _port_cfg(jcfg):
    """The port's ``ModelConfig`` with every field of a JAX config."""
    fields = {f.name for f in dataclasses.fields(C.ModelConfig)}
    assert fields == {f.name for f in dataclasses.fields(jbase.ModelConfig)}
    kw = {k: getattr(jcfg, k) for k in fields}
    if jcfg.moe is not None:
        kw["moe"] = C.MoEConfig(**dataclasses.asdict(jcfg.moe))
    kw["retrieval"] = C.RetrievalConfig(**dataclasses.asdict(jcfg.retrieval))
    return C.ModelConfig(**kw)


def _unstacked(tree, tcfg, leaf):
    """A JAX per-layer tree (``{"blocks": [...], "rem": [...]}``) in the
    port's layer list, ``leaf(x, drop)`` applied to each leaf (``drop`` 1
    for a scanned leaf's leading axis)."""
    out = []
    for _, src in T._layer_sources(tcfg):
        sub = tree["rem"][src[1]] if src[0] == "rem" else tree["blocks"][src[1]]
        drop = int(src[0] == "blocks")
        out.append(jax.tree.map(lambda x: leaf(x, drop), sub,
                                is_leaf=lambda x: isinstance(x, tuple)))
    return out


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_cache_specs_match_jax(arch):
    jcfg = jbase.get_config(arch)
    tcfg = _port_cfg(jcfg)
    want = _unstacked(JT.cache_specs(jcfg), tcfg, lambda s, drop: tuple(s)[drop:])
    assert T.cache_specs(tcfg) == want


@pytest.mark.parametrize("arch", DENSE)
def test_cache_specs_resolve_as_jax(arch):
    jcfg, tcfg = jbase.get_config(arch), C.get_config(arch)
    b, t = 8, 32768
    j_shapes = jax.eval_shape(lambda: JT.init_cache(jcfg, b, t))
    j_pairs = _unstacked({"blocks": list(zip(j_shapes["blocks"], JT.cache_specs(jcfg)["blocks"])),
                          "rem": list(zip(j_shapes["rem"], JT.cache_specs(jcfg)["rem"]))},
                         tcfg, lambda x, drop: x)
    t_shapes, t_specs = T.cache_shapes(tcfg, b, t), T.cache_specs(tcfg)
    for i, ((j_sh, j_sp), t_sh, t_sp) in enumerate(zip(j_pairs, t_shapes, t_specs)):
        drop = int(T._layer_sources(tcfg)[i][1][0] == "blocks")
        for n in ("k", "v"):
            shape = tuple(j_sh["kv"][n].shape)[drop:]
            assert tuple(t_sh["kv"][n].shape) == shape
            assert t_sh["kv"][n].dtype == _dtype(j_sh["kv"][n]) == torch.bfloat16
            for name, mshape in MESHES.items():
                mesh = types.SimpleNamespace(shape=mshape)
                for fsdp in (False, True):
                    got = SH.resolve_spec(t_sp["kv"][n], shape, SH.logical_rules(mesh, fsdp=fsdp),
                                          mesh)
                    ref = JSH.resolve_spec(tuple(j_sp["kv"][n])[drop:], shape,
                                           JSH.logical_rules(mesh, fsdp=fsdp), mesh)
                    assert got == ref, (name, i, n, got, ref)


def _dtype(x, token: bool = False):
    if token:                                 # the port's token ids are int64
        return {"int32": torch.int64}[str(x.dtype)]
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}[str(x.dtype)]


def _params_pairs(j_tree, tcfg):
    """A JAX parameter-shaped tree in ``Transformer.tree()``'s layout."""
    out = {"embed": j_tree["embed"], "final_norm": j_tree["final_norm"]}
    out["layers"] = _unstacked(j_tree, tcfg, lambda x, drop: (tuple(x.shape)[drop:], x))
    return out


def _same_specs(t_tree, j_tree, tcfg, where):
    assert _shape_dtype(t_tree) == _shape_dtype(_params_pairs(j_tree, tcfg), jax_side=True), where


def _shape_dtype(tree, jax_side=False):
    if jax_side:
        def leaf(x):
            if isinstance(x, tuple):
                return (x[0], str(_dtype(x[1])))
            return (tuple(x.shape), str(_dtype(x)))
        return jax.tree.map(leaf, tree, is_leaf=lambda x: isinstance(x, tuple))
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype)), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("arch", DENSE + ("rwkv6_3b", "recurrentgemma_9b", "granite_moe_1b_a400m",
                                  "qwen3_moe_235b_a22b"))
def test_build_specs_match_jax(arch):
    """The in-specs of the three ``build_*`` functions, shape and dtype, leaf
    for leaf."""
    jcfg, tcfg = jbase.get_config(arch), C.get_config(arch)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    tmesh = make_host_mesh(4, slots=8, device="meta")
    shape = C.SHAPES["decode_32k"]
    _, (jp, jtok, jc, jpos), _ = JS.build_decode(jcfg, jbase.SHAPES["decode_32k"], jmesh)
    _, (tp, ttok, tc, tpos), _ = steps.build_decode(tcfg, shape, tmesh)
    _same_specs(tp, jp, tcfg, "decode params")
    assert (tuple(ttok.shape), ttok.dtype) == (tuple(jtok.shape), _dtype(jtok, token=True))
    assert (tuple(tpos.shape), tpos.dtype) == (tuple(jpos.shape), _dtype(jpos))
    j_cache = _unstacked(jc, tcfg, lambda x, drop: (tuple(x.shape)[drop:], str(_dtype(x))))
    assert _shape_dtype(tc) == j_cache
    _, (jp, jb), _ = JS.build_prefill(jcfg, jbase.SHAPES["prefill_32k"], jmesh)
    _, (tp, tb), _ = steps.build_prefill(tcfg, C.SHAPES["prefill_32k"], tmesh)
    _same_specs(tp, jp, tcfg, "prefill params")
    assert {k: (tuple(v.shape), v.dtype) for k, v in tb.items()} == \
        {k: (tuple(v.shape), _dtype(v, token=True)) for k, v in jb.items()}
    _, (jst, jb), _ = JS.build_train(jcfg, jbase.SHAPES["train_4k"], jmesh)
    _, (tst, tb), _ = steps.build_train(tcfg, C.SHAPES["train_4k"], tmesh)
    for part in (["params"], ["opt", "mu"], ["opt", "nu"]):
        t, j = tst, jst
        for k in part:
            t, j = t[k], j[k]
        _same_specs(t, j, tcfg, part)
    assert (tuple(tst["opt"]["count"].shape), tst["opt"]["count"].dtype) == \
        (tuple(jst["opt"]["count"].shape), _dtype(jst["opt"]["count"]))
    assert {k: (tuple(v.shape), v.dtype) for k, v in tb.items()} == \
        {k: (tuple(v.shape), _dtype(v, token=True)) for k, v in jb.items()}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_analytic_costs_match_jax(arch):
    jcfg = jbase.get_config(arch)
    tcfg = _port_cfg(jcfg)
    for name in jbase.applicable_shapes(jcfg):
        for mshape in MESHES.values():
            mesh = types.SimpleNamespace(shape=mshape)
            got = analytic.cell_costs(tcfg, C.SHAPES[name], mesh)
            want = janalytic.cell_costs(jcfg, jbase.SHAPES[name], mesh)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, mshape)
        assert hlo_analysis.model_flops(tcfg, C.SHAPES[name]) == \
            jhlo.model_flops(jcfg, jbase.SHAPES[name])


def test_roofline_on_the_h100_peaks():
    roof = hlo_analysis.Roofline(flops_per_device=989e12, hbm_bytes_per_device=6.7e12,
                                 collective_bytes_per_device=9e11, chips=8)
    assert (roof.t_compute, roof.t_memory, roof.t_collective) == (1.0, 2.0, 2.0)
    assert roof.links_per_chip == 1.0 and roof.bound_time == 2.0
    assert set(roof.as_dict()) == set(jhlo.Roofline(1, 1, 1, 1).as_dict())
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW, hlo_analysis.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_production_meshes():
    single, multi = make_production_mesh(device="cpu"), make_production_mesh(
        multi_pod=True, device="meta")
    assert dict(single.shape) == {"data": 16, "model": 16} and single.devices.shape == (16, 16)
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16}
    assert set(multi.slot_devices) == {"meta"}
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        steps.transformer.init_cache(C.get_smoke_config("olmo_1b"), 1, 4, device="meta")


def test_dryrun_reference_cell_on_512_meta_slots():
    """``run_cell("olmo_1b", "decode_32k", multi_pod=True)``: every olmo_1b
    weight splits 16 ways over "model" (no norm weights, tied embedding),
    the cache its KV heads 16 ways and its rows 32 ways."""
    rec = dryrun.run_cell("olmo_1b", "decode_32k", multi_pod=True, verbose=False)
    assert rec["ok"], rec.get("traceback")
    cfg, shape = C.get_config("olmo_1b"), C.SHAPES["decode_32k"]
    assert rec["chips"] == 512 and rec["mesh"] == "2x16x16"
    rows = shape.global_batch // 32
    params = cfg.n_params() * 4 // 16
    cache = cfg.n_layers * 2 * rows * shape.seq_len * (cfg.n_kv_heads // 16) * cfg.hd * 2
    assert rec["memory_analysis"]["argument_size_in_bytes"] == params + cache + rows * 8 + 4
    assert rec["memory_analysis"]["output_size_in_bytes"] == \
        cache + rows * (cfg.vocab_size // 16) * 4
    w = rec["collective_bytes_weighted"]
    assert w["total"] > 0 and w["all-reduce"] == (1 + 2 * cfg.n_layers) * rows * cfg.d_model * 2
    assert rec["trace"]["depths"] == [2, 3] and rec["roofline"]["chips"] == 512


def test_dryrun_records_an_unported_preset():
    """whisper's train cell, refused until the slot program carried the
    encoder (ROADMAP queue A item 21c), traces on the (16, 16) pod, the
    encoder stepped with the decoder; its per-slot argument bytes equal a
    hand count: the float32 weights and both AdamW moments (whole but the
    MLPs', d_ff split 16 ways; 20 heads and a vocab of 51,866 do not
    split), the step count, and the slot's 16 rows of tokens and labels
    (int64) and of frames (float32)."""
    rec = dryrun.run_cell("whisper_large_v3", "train_4k", multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["trace"] == {"depths": [2, 3], "groups_added": 30, "attn_chunk": 0,
                            "encoder_depths": [2, 3]}
    cfg = C.get_config("whisper_large_v3")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dec = 3 * 2 * d + 8 * d * d + 2 * d * f // 16        # 3 LayerNorms, attn + xattn, MLP
    enc = 2 * 2 * d + 4 * d * d + 2 * d * f // 16
    weights = 2 * v * d + cfg.n_layers * dec + cfg.n_encoder_layers * enc + 2 * 2 * d
    rows = 256 // 16
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        3 * 4 * weights + 4 + 2 * rows * 4096 * 8 + rows * cfg.encoder_seq * d * 4


def test_dryrun_single_cell_end_to_end():
    """The reference's own miniature of the deliverable
    (``tests/test_distributed.py::test_dryrun_single_cell_end_to_end``): an
    MoE cell on the 512-slot multi-pod mesh."""
    rec = dryrun.run_cell("granite_moe_1b_a400m", "decode_32k", multi_pod=True, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["chips"] == 512
    assert rec["collective_bytes_weighted"]["total"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def _long_500k_arg_bytes(cfg):
    """A hand count of ``long_500k``'s per-slot argument bytes on the (16,
    16) pod: float32 weights, every one split 16 ways over "model" but those
    whose dims do not divide it or take no "model" rule; the decode state of
    the one row, whole over the 16 data groups; the token (int64) and pos."""
    d, m, n = cfg.d_model, 16, cfg.n_layers
    total = sum(t.numel() for t in jax.tree.leaves(
        T.param_shapes(cfg), is_leaf=lambda x: isinstance(x, torch.Tensor)))
    if cfg.name == "rwkv6_3b":
        # whole: the final norm's scale, per layer the bonus u (40 heads on
        # 16) and the decay LoRA's wd_a (d, 64); state: wkv whole (40 heads),
        # the two token shifts split by channel.
        h = d // cfg.rnn_head_dim
        whole = d + n * (h * cfg.rnn_head_dim + d * 64)
        state = n * (h * cfg.rnn_head_dim ** 2 * 4 + 2 * (d // m) * 2)
    else:
        # whole: the final norm's and every layer's two norm scales, and the
        # local layers' one KV head (wk, wv); state: the RG-LRU's h (float32)
        # and conv carry split by channel, the local ring by position.
        n_local = T.layer_plan(cfg).kinds.count("local")
        whole = d + 2 * n * d + n_local * 2 * d * cfg.hd
        state = (n - n_local) * ((cfg.rnn_d // m) * 4 + 3 * (cfg.rnn_d // m) * 2) + \
            n_local * 2 * (cfg.window // m) * cfg.hd * 2
    return 4 * ((total - whole) // m + whole) + state + 8 + 4


@pytest.mark.parametrize("arch", ["rwkv6_3b", "recurrentgemma_9b"])
def test_dryrun_long_500k_on_the_pod(arch):
    """``long_500k``'s one row on the (16, 16) pod: the batch does not split
    over the 16 data groups, so every group holds it whole."""
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _long_500k_arg_bytes(C.get_config(arch))
    assert rec["t_lower_s"] > 0 and rec["collective_bytes_weighted"]["total"] > 0


def _smoke(**over):
    return dataclasses.replace(C.get_smoke_config("olmo_1b"), **over)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_collectives_hand_count(kind):
    """olmo_1b's smoke config on 1 × 2: one all-reduce of the rows' B·S·D
    activations per row-parallel sublayer (``wo``, ``w_down``) and one for
    the vocab-parallel embedding lookup; one broadcast of the residual
    stream before each sublayer and the final norm."""
    cfg = _smoke()
    b, s = 2, 8
    shape = C.ShapeConfig(kind, kind, s, b)
    mesh = make_host_mesh(2, slots=2, device="cpu")
    rec = dryrun.record_cell("olmo_1b", shape, mesh, cfg=cfg, verbose=False)
    assert rec["ok"], rec.get("traceback")
    n = 1 + 2 * cfg.n_layers
    act = b * (s if kind == "prefill" else 1) * cfg.d_model * 4
    want = {"all-gather": 0, "all-reduce": n, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0, "broadcast": n}
    assert rec["collective_counts"] == want
    assert rec["collective_bytes"] == rec["collective_bytes_weighted"] == \
        {**{k: v * act for k, v in want.items()}, "total": 2 * n * act}


@pytest.mark.parametrize("kind", ["prefill", "decode", "loss"])
def test_moe_collectives_hand_count(kind):
    """granite's smoke config (3 layers, 4 experts top-2, 2 KV heads) on 2 ×
    2, four rows: 2 experts a slot (EP), attention and vocab sharded.  Per
    slot, beside the dense layer's collectives (the embedding's and each
    ``wo``'s all-reduce, the residual's broadcast before each sublayer and
    the final norm): per MoE layer the router's column logits gathered over
    the model group (float32, T_d · e/2 · 4 bytes), the count exchange over
    the data groups (an (e,) int64 vector) and the experts' rows joined as
    an all-to-all ((e/2) · min(cap, T_d) rows of d).  The loss (a forward
    without gradients) adds each MoE layer's aux sums, a (2, e) float32
    all-reduce over the data groups, the vocab-parallel cross-entropy's
    three all-reduces of (rows, S) float32 and the loss's 8 bytes."""
    cfg = C.get_smoke_config("granite_moe_1b_a400m")
    b, s = 4, (1 if kind == "decode" else 8)
    mesh = make_host_mesh(2, slots=4, device="cpu")
    n, e, d, L = 4, cfg.moe.n_experts, cfg.d_model, cfg.n_layers
    t_d = b // 2 * s
    rows = min(-(-int(np.ceil(b * s * 2 / e * 1.25)) // 8) * 8, t_d) if kind != "decode" else \
        min(8, t_d)
    if kind == "loss":
        model = T.init_params(0, cfg, device="cpu")
        _, _, (st_sh, _) = steps.build_train(cfg, C.ShapeConfig("t", "train", s, b), mesh)
        params = steps.place(model.tree(), st_sh["params"])
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(0))
        with spmd.record_collectives(n) as r, torch.no_grad():
            spmd.loss_fn(params, cfg, {"tokens": toks, "labels": toks})
        rec = {"collective_counts": hlo_analysis.collective_counts(r),
               "collective_bytes": hlo_analysis.collective_bytes(r)}
    else:
        rec = dryrun.record_cell("granite_moe_1b_a400m", C.ShapeConfig(kind, kind, s, b), mesh,
                                 cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
    act = t_d * d * 4
    want = {"all-gather": 2 * L, "all-reduce": 1 + L, "reduce-scatter": 0, "all-to-all": L,
            "collective-permute": 0, "broadcast": 2 * L + 1}
    nbytes = {"all-gather": L * (t_d * e // 2 * 4 + e * 8), "all-reduce": (1 + L) * act,
              "reduce-scatter": 0, "all-to-all": L * e // 2 * rows * d * 4,
              "collective-permute": 0, "broadcast": (2 * L + 1) * act}
    if kind == "loss":
        want["all-reduce"] += L + 3 + 1
        nbytes["all-reduce"] += L * 2 * e * 4 + 3 * t_d * 4 + 8
    assert rec["collective_counts"] == want
    assert rec["collective_bytes"] == {**nbytes, "total": sum(nbytes.values())}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_recurrent_collectives_hand_count(kind):
    """One ``rwkv`` layer and one ``rglru`` layer on 1 × 2 (float32 smoke
    configs; ``act`` = rows · tokens · d_model · 4 bytes; the vocab-parallel
    embedding's all-reduce and the final norm's broadcast around them).

    ``rwkv`` (2 of the 4 heads a slot): nine ``(d,)`` leaves gathered whole
    (``mu_*``, ``ln1``, ``ln2``, ``cm_mu_*``; a slot's block each), the
    normed heads, the time-mix output and the receptance gathered by
    channel (act / 2 each), decode's two token shifts too; ``cm_v``'s
    row-parallel all-reduce; two broadcasts of the residual.  ``rglru``:
    ``w_out``'s and the MLP's all-reduces and two broadcasts, nothing on its
    state."""
    b, s = 2, 8
    shape = C.ShapeConfig(kind, kind, s, b)
    mesh = make_host_mesh(2, slots=2, device="cpu")
    for arch in ("rwkv6_3b", "recurrentgemma_9b"):
        cfg = dataclasses.replace(C.get_smoke_config(arch), n_layers=1)
        rec = dryrun.record_cell(arch, shape, mesh, cfg=cfg, verbose=False)
        assert rec["ok"], rec.get("traceback")
        act = b * (s if kind == "prefill" else 1) * cfg.d_model * 4
        if arch == "rwkv6_3b":
            shifts = 2 if kind == "decode" else 0
            want = {"all-gather": 12 + shifts, "all-reduce": 2, "broadcast": 3}
            nbytes = {"all-gather": 9 * cfg.d_model // 2 * 4 + (3 + shifts) * act // 2,
                      "all-reduce": 2 * act, "broadcast": 3 * act}
        else:
            want = {"all-gather": 0, "all-reduce": 3, "broadcast": 3}
            nbytes = {"all-gather": 0, "all-reduce": 3 * act, "broadcast": 3 * act}
        zero = {"reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
        assert rec["collective_counts"] == {**want, **zero}, arch
        assert rec["collective_bytes"] == rec["collective_bytes_weighted"] == \
            {**nbytes, **zero, "total": sum(nbytes.values())}, arch


def _trace_on_cpu(cfg, shape, mesh):
    """``dryrun.trace`` (every data group) on CPU slots: the cell's inputs
    as seeded tensors in place of its ``meta`` specs."""
    fn, in_specs, in_shardings = steps.build_cell(cfg, shape, mesh)
    gen = torch.Generator().manual_seed(0)

    def concrete(x):
        if x.dtype == torch.int64:
            return torch.randint(0, cfg.vocab_size, tuple(x.shape), generator=gen)
        return torch.randn(tuple(x.shape), generator=gen).to(x.dtype) / 8

    args = [steps.place(tree_map(concrete, x), sh) for x, sh in zip(in_specs, in_shardings)]
    if shape.kind == "decode":
        args[3] = shape.seq_len - 1
    n = len(mesh.slot_devices)
    with spmd.record_collectives(n) as rec:
        out = fn(*args)
    return rec, dryrun._out_bytes(out, n)


@pytest.mark.parametrize("arch,kind,mshape", [("rwkv6_3b", "train", (2, 2)),
                                             ("rwkv6_3b", "decode", (1, 4)),
                                             ("recurrentgemma_9b", "prefill", (2, 4))])
def test_recurrent_meta_trace_equals_the_loops(arch, kind, mshape):
    """A recurrent smoke cell traced on CPU slots (the scans' real loops)
    and on ``meta`` slots (their stand-ins) records the same collectives on
    every slot and the same per-slot output bytes; the 1 × 4 decode takes
    the straddling route (6 heads of 16 at d_model 96: 1.5 heads a
    slot)."""
    over = dict(d_model=96, n_heads=6, n_kv_heads=6) if mshape == (1, 4) else {}
    cfg = dataclasses.replace(C.get_smoke_config(arch), **over)
    shape = C.ShapeConfig(kind, kind, 20, 4)
    mesh = make_host_mesh(mshape[1], slots=mshape[0] * mshape[1], device="cpu")
    cpu_rec, cpu_out = _trace_on_cpu(cfg, shape, mesh)
    meta_rec, meta_out = dryrun.trace(cfg, shape, dryrun.on_meta(mesh), one_group=False)
    for field in ("bytes", "counts", "bytes_once", "counts_once"):
        a, b = getattr(cpu_rec, field), getattr(meta_rec, field)
        assert all(np.array_equal(a[k], b[k]) for k in a), field
    assert np.array_equal(cpu_out, meta_out)
    assert sum(int(c.max()) for c in cpu_rec.counts.values()) > 0


TRACE_CASES = {
    "decode_2x2": (_smoke(), "decode", (2, 2)),
    "prefill_2x2": (_smoke(), "prefill", (2, 2)),
    "train_scanned_remat_2x2": (_smoke(n_layers=4, scan_layers=True, remat=True), "train", (2, 2)),
    "train_fsdp_2x2": (dataclasses.replace(C.get_smoke_config("llama3_405b"), fsdp=True),
                       "train", (2, 2)),
    "decode_qwen3_2x3": (dataclasses.replace(C.get_smoke_config("qwen3_14b"), n_layers=5),
                         "decode", (2, 3)),
    "train_rwkv_2x2": (dataclasses.replace(C.get_smoke_config("rwkv6_3b"), n_layers=5),
                       "train", (2, 2)),
    "decode_recurrentgemma_2x4": (
        dataclasses.replace(C.get_smoke_config("recurrentgemma_9b"), n_layers=14), "decode",
        (2, 4)),
    # the encoder traced at 4 and 5 layers beside the decoder's 2 and 3
    "train_whisper_2x2": (dataclasses.replace(C.get_smoke_config("whisper_large_v3"), n_layers=5,
                                              n_encoder_layers=7), "train", (2, 2)),
    "prefill_whisper_unscanned_1x4": (
        dataclasses.replace(C.get_smoke_config("whisper_large_v3"), n_layers=5,
                            n_encoder_layers=3, scan_layers=False), "prefill", (1, 4)),
    "train_llava_fsdp_2x2": (dataclasses.replace(C.get_smoke_config("llava_next_mistral_7b"),
                                                 n_layers=5, fsdp=True), "train", (2, 2)),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_trace_shortcuts_are_exact(case):
    """The extension from two depths and the one-data-group trace give the
    full trace's record (every field of the busiest slot) and per-slot
    output bytes."""
    cfg, kind, mshape = TRACE_CASES[case]
    assert dryrun.trace_depths(cfg) is not None
    if case == "train_whisper_2x2":
        assert dryrun.encoder_depths(cfg, dryrun.trace_depths(cfg)[2]) == (4, 5)
    shape = C.ShapeConfig(kind, kind, 12 + cfg.n_patches, 4)
    mesh = dryrun.on_meta(make_host_mesh(mshape[1], slots=mshape[0] * mshape[1], device="cpu"))
    full_rec, full_out = dryrun.trace(dataclasses.replace(cfg, attn_chunk=0), shape, mesh,
                                      one_group=False)
    rec, out, _ = dryrun.traced(cfg, shape, mesh)
    for fn in (hlo_analysis.collective_bytes, hlo_analysis.collective_counts,
               hlo_analysis.collective_bytes_weighted):
        assert fn(rec) == fn(full_rec), fn.__name__
    assert np.array_equal(out, full_out)
    if kind == "train":
        assert full_rec.bytes["all-reduce"].max() > full_rec.bytes_once["all-reduce"].max() \
            or not cfg.scan_layers
    if cfg.fsdp:
        assert hlo_analysis.collective_counts(rec)["all-gather"] > 0 and \
            hlo_analysis.collective_counts(rec)["reduce-scatter"] > 0
