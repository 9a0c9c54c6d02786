"""The port's logical sharding rules (``repro_torch.sharding``) and the
parameters' logical specs (``models.transformer.param_specs``) held to the
JAX package.  Pure: ``resolve_spec`` reads only ``mesh.shape``, so the
meshes are namespaces with a ``shape``, and no model is built.

Every case of ``tests/test_sharding.py`` runs with the port's
``logical_rules`` and ``resolve_spec`` in place of the reference's; the
four dense presets' specs, at their full configs with and without
``fsdp``, resolve on (16, 16), (2, 16, 16) and (2, 4) meshes to the JAX
``resolve_spec`` of the JAX ``init_params`` specs (through
``launch.steps.params_specs``, which allocates nothing), leaf for leaf once
the scanned leaves' ``"layers"`` axis is dropped."""
import dataclasses
import importlib.util
import pathlib
import types

import jax
import pytest

from repro import sharding as JSH
from repro.configs import base as jbase
from repro.launch import steps as JS
from repro_torch import configs as C
from repro_torch import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T

_REF = pathlib.Path(__file__).with_name("test_sharding.py")
_spec = importlib.util.spec_from_file_location("_reference_test_sharding", _REF)
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)
REF_CASES = sorted(n for n in vars(REF) if n.startswith("test_"))

DENSE = ("olmo_1b", "qwen3_14b", "yi_9b", "llama3_405b")
MESHES = {"16x16": dict(data=16, model=16), "2x16x16": dict(pod=2, data=16, model=16),
          "2x4": dict(data=2, model=4)}


@pytest.mark.parametrize("case", REF_CASES)
def test_reference_sharding_cases_on_the_port(case, monkeypatch):
    """The reference's own assertions, with the port's rules resolving."""
    monkeypatch.setattr(REF, "resolve_spec", SH.resolve_spec)
    monkeypatch.setattr(REF, "logical_rules", SH.logical_rules)
    getattr(REF, case)()


def test_partition_spec_compares_as_jax():
    P, JP = SH.PartitionSpec, jax.sharding.PartitionSpec
    assert P(None, "model") == JP(None, "model") and JP(None, "model") == P(None, "model")
    assert P(("pod", "data"), None) == JP(("pod", "data"), None)
    assert P(None, None) != P() and P(None, None) != JP()
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def _jax_layer(tree, src):
    """Layer ``src`` of a JAX spec or shape tree (``_layer_sources``' form):
    a ``rem`` entry, or a pattern position of ``blocks`` (every group
    shares its specs)."""
    return tree["rem"][src[1]] if src[0] == "rem" else tree["blocks"][src[1]]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_resolve_as_jax(arch, fsdp):
    tcfg = dataclasses.replace(C.get_config(arch), fsdp=fsdp)
    j_shapes, j_specs = JS.params_specs(dataclasses.replace(jbase.get_config(arch), fsdp=fsdp))
    t_specs, t_shapes = T.param_specs(tcfg), T.param_shapes(tcfg)
    pairs = [((key,), t_specs[key], t_shapes[key], j_specs[key], j_shapes[key], 0)
             for key in ("embed", "final_norm")]
    for i, (_, src) in enumerate(T._layer_sources(tcfg)):
        drop = int(src[0] == "blocks")            # the scanned leaves' "layers" axis
        for sub in T._SUBLAYERS:
            pairs.append((("layers", i, sub), t_specs["layers"][i][sub],
                          t_shapes["layers"][i][sub], _jax_layer(j_specs, src)[sub],
                          _jax_layer(j_shapes, src)[sub], drop))
    for where, t_sp, t_sh, j_sp, j_sh, drop in pairs:
        assert sorted(t_sp) == sorted(j_sp), where
        for k in t_sp:
            assert t_sp[k] == tuple(j_sp[k])[drop:], (where, k)       # the logical axes
            assert tuple(t_sh[k].shape) == tuple(j_sh[k].shape)[drop:], (where, k)
            for name, shape in MESHES.items():
                mesh = types.SimpleNamespace(shape=shape)
                got = SH.resolve_spec(t_sp[k], t_sh[k].shape, SH.logical_rules(mesh, fsdp=fsdp),
                                      mesh)
                ref = JSH.resolve_spec(j_sp[k], j_sh[k].shape, JSH.logical_rules(mesh, fsdp=fsdp),
                                       mesh)
                assert got == tuple(ref)[drop:], (name, where, k, got, ref)


def test_shardings_place_and_gather():
    """``NamedSharding`` blocks: shapes, slices, replicas as real copies,
    the gather and an FSDP-style local view."""
    import torch
    mesh = make_host_mesh(2, slots=4, device="cpu")
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    sh = SH.NamedSharding(mesh, SH.PartitionSpec("data", "model"))
    arr = sh.place(x)
    assert sh.shard_shape(x.shape) == (4, 3) and sh.shard_factor == 4
    assert [tuple(b.shape) for b in arr.blocks] == [(4, 3)] * 4
    assert torch.equal(arr.blocks[1], x[:4, 3:]) and torch.equal(arr.blocks[2], x[4:, :3])
    assert torch.equal(arr.gather(), x)
    assert torch.equal(sh.local_view(arr.blocks, 3, keep=("model",)), x[:, 3:])
    rep = SH.NamedSharding(mesh, SH.PartitionSpec(None, "model")).place(x)
    assert rep.blocks[0].data_ptr() != rep.blocks[2].data_ptr()
    assert torch.equal(rep.blocks[0], rep.blocks[2])
    assert SH.NamedSharding(mesh, SH.PartitionSpec(None, "model")).replica_groups(2) == \
        [[0, 2], [1, 3]]
    ctx = SH.ShardingCtx.for_mesh(mesh)
    assert ctx.batch_sharding().spec == SH.PartitionSpec(("data",), None)
    assert ctx.named(("vocab", "embed"), (384, 96)).spec == SH.PartitionSpec("model", None)
    assert SH.null_ctx().spec(("embed",), (4,)) == SH.PartitionSpec()
    with pytest.raises(ValueError, match="names axis"):
        SH.NamedSharding(mesh, SH.PartitionSpec("pod"))
