"""Index generations on disk for the PyTorch port: ``KNNIndex.save`` /
``KNNIndex.load`` and ``checkpoint.CheckpointManager``, following
``tests/test_persistence.py`` and ``tests/test_substrate.py``'s checkpoint
plans, plus the on-disk format shared with the JAX package: a generation
(and a bfloat16 tree) saved by either package loads into the other.

Tolerance: a loaded index answers bit-identically to the one that saved;
across packages, distances within 1e-5 and ids equal except where the
float64 distances of the two ids tie within 1e-5 (the same parity the
other port tests hold)."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from repro.checkpoint import CheckpointManager as JaxManager
from repro.runtime import KNNIndex as JaxIndex
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import HybridConfig
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import KNNIndex, ShardedKNNIndex
from repro_torch.sharding import NamedSharding, PartitionSpec
from test_projection_front import _lowrank
from test_torch_mutation import _match
from test_torch_projection import _hold


def _db(seed=0, n=700, dim=6):
    r = np.random.default_rng(seed)
    core = (0.05 * r.normal(size=(n - n // 4, dim))).astype(np.float32)
    bg = r.uniform(-3.0, 3.0, (n // 4, dim)).astype(np.float32)
    return np.concatenate([core, bg]).astype(np.float32)


def _queries(seed=1, n=60, dim=6):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


def _cfg(k, **kw):
    return dict(k=k, m=4, n_batches=1, **kw)


def _same(got, want):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)


def _build(db, k=5, eps=None, **kw):
    return KNNIndex.build(db, HybridConfig(**_cfg(k, **kw)), eps, device="cpu")


def test_clean_roundtrip_bit_identical(tmp_path):
    db, q = _db(), _queries()
    idx = _build(db)
    want = idx.query(q)
    assert idx.save(str(tmp_path)) == 0
    loaded = KNNIndex.load(str(tmp_path), device="cpu")
    assert loaded.n_points == idx.n_points and loaded.is_clean
    assert loaded.eps == idx.eps and loaded.t_select_eps == 0.0   # replayed
    np.testing.assert_array_equal(loaded.points_r.numpy(), idx.points_r.numpy())
    np.testing.assert_array_equal(loaded.dim_perm.numpy(), idx.dim_perm.numpy())
    _same(loaded.query(q), want)
    _same(loaded.query(exclude_self=True), idx.query(exclude_self=True))


def test_dirty_index_restores_dirty(tmp_path):
    """Pending inserts/deletes restore with the index — same answers now,
    the same compaction later."""
    db, q = _db(seed=2), _queries(seed=3)
    idx = _build(db, k=4)
    new_ids = idx.insert(_queries(seed=4, n=16))
    idx.delete(np.arange(8))
    idx.delete(new_ids[:2])
    want = idx.query(q)
    idx.save(str(tmp_path))
    loaded = KNNIndex.load(str(tmp_path), device="cpu")
    assert not loaded.is_clean
    assert (loaded.n_delta, loaded.n_tombstones) == (idx.n_delta, idx.n_tombstones)
    _same(loaded.query(q), want)
    remap = loaded.compact()
    assert loaded.is_clean
    np.testing.assert_array_equal(loaded.query(q).ids, remap[want.ids])
    np.testing.assert_array_equal(remap, idx.compact())


def test_generations_auto_increment_and_step_select(tmp_path):
    db, q = _db(seed=5), _queries(seed=6)
    idx = _build(db, k=3)
    want0 = idx.query(q)
    assert idx.save(str(tmp_path)) == 0
    idx.delete(np.arange(30))
    want1 = idx.query(q)
    assert idx.save(str(tmp_path)) == 1
    _same(KNNIndex.load(str(tmp_path), device="cpu").query(q), want1)
    _same(KNNIndex.load(str(tmp_path), step=0, device="cpu").query(q), want0)


def test_load_rejects_non_index_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"w": np.zeros((3, 3), np.float32)}, extra={"cursor": 1})
    with pytest.raises(ValueError, match="not an index generation"):
        KNNIndex.load(str(tmp_path), device="cpu")


def test_load_empty_directory_is_actionable(tmp_path):
    with pytest.raises(FileNotFoundError, match="no durable"):
        KNNIndex.load(str(tmp_path), device="cpu")


def test_save_is_durable_on_return(tmp_path):
    """save() is synchronous: when it returns, the step directory is
    complete and LATEST points at it."""
    _build(_db(seed=7, n=400), k=3).save(str(tmp_path))
    d = os.path.join(tmp_path, "step-000000000")
    assert os.path.exists(os.path.join(d, "manifest.json"))
    assert os.path.exists(os.path.join(d, "arrays.npz"))
    with open(os.path.join(tmp_path, "LATEST")) as f:
        assert f.read().strip() == "step-000000000"


def test_corrupt_latest_step_falls_back_to_previous_durable(tmp_path):
    """A latest step left partial (its arrays never written) is not
    durable: load warns and restores the previous generation."""
    db, q = _db(seed=8), _queries(seed=9)
    idx = _build(db, k=3)
    want0 = idx.query(q)
    idx.save(str(tmp_path))
    idx.delete(np.arange(20))
    idx.save(str(tmp_path))
    os.remove(os.path.join(tmp_path, "step-000000001", "arrays.npz"))
    with pytest.warns(RuntimeWarning, match="falling back to newest durable"):
        loaded = KNNIndex.load(str(tmp_path), device="cpu")
    assert loaded.is_clean
    _same(loaded.query(q), want0)


def test_load_of_unported_generations_and_mesh_raise(tmp_path):
    """A generation loads onto a CPU mesh as a ``ShardedKNNIndex`` answering
    bit-identically, and a generation saved by the JAX package's sharded
    index loads into the port's, on a mesh and without one; a mesh that is
    not a ``Mesh`` is a ``TypeError``; the manager's ``restore(shardings=)``
    (the trainer's elastic restart onto a mesh) lays a saved array onto a
    slot mesh bit for bit, and refuses ``device=`` beside it.
    Projected generations (l2 over a PCA fit, ip over the MIPS fit) cross
    between the packages in both directions with their fitted map and the
    same answers."""
    db, q = _db(seed=10, n=300), _queries(seed=11)
    idx = _build(db, k=3)
    want = idx.query(q)
    idx.save(str(tmp_path))
    sharded = KNNIndex.load(str(tmp_path), mesh=make_serving_mesh(2, replicas=2, device="cpu"))
    assert isinstance(sharded, ShardedKNNIndex) and sharded.placement_shape == (2, 2)
    got = sharded.query(q)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    with pytest.raises(TypeError, match="got object"):
        KNNIndex.load(str(tmp_path), device="cpu", mesh=object())
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(0, {"points_r": db})
    row = NamedSharding(make_serving_mesh(2, axis="data", device="cpu"), PartitionSpec("data"))
    placed, _, _ = mgr.restore({"points_r": 0}, shardings=row)
    assert [tuple(b.shape) for b in placed["points_r"].blocks] == [(150, db.shape[1])] * 2
    np.testing.assert_array_equal(placed["points_r"].gather().numpy(), db)
    with pytest.raises(ValueError, match="not both"):
        mgr.restore({"points_r": 0}, shardings=row, device="cpu")
    # A JAX ShardedKNNIndex's generation (a one-device mesh on this process),
    # dirty, loads into the port with and without a mesh.
    from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
    jsh = JaxIndex.build(db, jax_hybrid.HybridConfig(**_cfg(3)), idx.eps,
                         mesh=jax_serving_mesh(1))
    jsh.delete([0, 5])
    jwant = jsh.query(q)
    jsh.save(str(tmp_path / "jax_sharded"))
    full = np.asarray(db, np.float64)
    for mesh in (None, make_serving_mesh(2, device="cpu")):
        back = KNNIndex.load(str(tmp_path / "jax_sharded"), device="cpu", mesh=mesh)
        assert back.n_tombstones == 2
        got = back.query(q)
        if mesh is None:
            _match(got, jwant, full, q)
            continue
        # Two shards sum their engines' counts: hold the answers only.
        np.testing.assert_allclose(got.dists, jwant.dists, rtol=1e-5, atol=1e-5)
        r, c = np.nonzero(got.ids != jwant.ids)
        np.testing.assert_allclose(np.linalg.norm(q[r] - full[got.ids[r, c]], axis=-1),
                                   np.linalg.norm(q[r] - full[jwant.ids[r, c]], axis=-1),
                                   rtol=1e-5, atol=1e-5)
    db, q = _lowrank(n=800, seed=4), _lowrank(n=90, seed=5)
    for metric, pdim in (("l2", 5), ("ip", 6)):
        cfg = dict(k=6, m=3, online_rebalance=False, metric=metric, projection_dim=pdim,
                   projection_kind="pca", recall_target=0.9)
        jidx = JaxIndex.build(db, jax_hybrid.HybridConfig(**cfg), 4.0)
        tidx = KNNIndex.build(db, HybridConfig(**cfg), 4.0, device="cpu")
        jidx.save(str(tmp_path / f"jax_{metric}"))
        from_jax = KNNIndex.load(str(tmp_path / f"jax_{metric}"), device="cpu")
        for got, want in ((from_jax.projection, jidx.projection),
                          (tidx.projection, jidx.projection)):
            np.testing.assert_array_equal(got.matrix, want.matrix)
            np.testing.assert_array_equal(got.mean, want.mean)
            assert (got.kind, got.mips_m) == (want.kind, want.mips_m)
        assert (from_jax.projection.mips_m > 0) == (metric == "ip")
        np.testing.assert_array_equal(from_jax.points_r.numpy(), np.asarray(jidx.points_r))
        _hold(from_jax.query(q), jidx.query(q), q, metric)
        tidx.save(str(tmp_path / f"port_{metric}"))
        from_port = JaxIndex.load(str(tmp_path / f"port_{metric}"))
        np.testing.assert_array_equal(from_port.projection.matrix, tidx.projection.matrix)
        assert from_port.projection.mips_m == tidx.projection.mips_m
        _hold(tidx.query(q), from_port.query(q), q, metric)


# ---------------------------------------------------------------------------
# The checkpoint manager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(8, 4)).astype(np.float32),
            "nested": {"b": r.integers(0, 9, (3,)).astype(np.int32),
                       "c": [torch.ones(2), torch.arange(5, dtype=torch.bfloat16) / 3]}}


def _equal_trees(got, want):
    np.testing.assert_array_equal(got["a"], want["a"])
    np.testing.assert_array_equal(got["nested"]["b"], want["nested"]["b"])
    assert torch.equal(torch.as_tensor(got["nested"]["c"][0]), want["nested"]["c"][0])
    bf = got["nested"]["c"][1]
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, want["nested"]["c"][1])


def test_checkpoint_roundtrip_with_bfloat16(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(7, _tree(), extra={"cursor": 42})
    got, extra, step = mgr.restore(_tree())
    assert step == 7 and extra == {"cursor": 42}
    _equal_trees(got, _tree())
    on_dev, _, _ = mgr.restore(_tree(), device="cpu")
    assert isinstance(on_dev["a"], torch.Tensor) and on_dev["nested"]["c"][1].dtype == torch.bfloat16


def test_checkpoint_async_gc_and_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    mgr.wait()
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert len(kept) == 2 and mgr.latest_step() == 4
    _equal_trees(mgr.restore(_tree())[0], _tree(4))
    path = os.path.join(tmp_path, "step-000000004", "arrays.npz")
    data = dict(np.load(path))
    data["a"] = data["a"] + 1.0
    np.savez(path, **data)
    with pytest.raises(ValueError, match="crc"):
        mgr.restore(_tree())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_save_snapshots_cpu_tensors(tmp_path, dtype):
    """An async save holds the values the tree had when ``save`` returned:
    the trainer updates its CPU masters in place while the write runs (the
    write is held here until the tensor has changed)."""
    gate = threading.Event()

    class Held(CheckpointManager):
        def _phase(self, name, step):
            if name == "pre-arrays":
                assert gate.wait(10)

    mgr = Held(str(tmp_path), async_save=True)
    w = torch.arange(4096, dtype=torch.float32).to(dtype)
    want = w.clone()
    mgr.save(1, {"w": w})
    w.add_(1)
    gate.set()
    mgr.wait()
    got = mgr.restore({"w": torch.zeros_like(w)}, device="cpu")[0]["w"]
    assert torch.equal(got, want)


def test_checkpoint_partial_step_and_nothing_durable(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no durable checkpoint"):
        mgr.restore(_tree())
    mgr.save(3, _tree(3))
    os.makedirs(os.path.join(tmp_path, "step-000000007"))
    assert mgr.durable_steps() == [3]
    with pytest.raises(FileNotFoundError, match=r"missing or partial.*durable steps.*\[3\]"):
        mgr.restore(_tree(), step=7)
    with open(os.path.join(tmp_path, "LATEST"), "w") as f:
        f.write("step-000000007")
    with pytest.warns(RuntimeWarning):
        assert mgr.latest_step() == 3


# ---------------------------------------------------------------------------
# One on-disk format for both packages
# ---------------------------------------------------------------------------

def test_bfloat16_tree_crosses_packages(tmp_path):
    """The JAX manager stores bfloat16 as a raw byte view under its dtype
    name; the port restores it as a torch bfloat16 tensor, bit for bit, and
    the reverse.  Manifests name the same shapes, dtypes and crcs."""
    jtree = {"w": jnp.arange(12, dtype=jnp.bfloat16).reshape(3, 4) / 7,
             "i": jnp.arange(3, dtype=jnp.int32)}
    JaxManager(str(tmp_path / "j"), async_save=False).save(1, jtree)
    got, _, _ = CheckpointManager(str(tmp_path / "j")).restore({"w": 0, "i": 0})
    want = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4) / 7
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    np.testing.assert_array_equal(got["i"], np.arange(3))
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        1, {"w": want, "i": np.arange(3, dtype=np.int32)})
    back, _, _ = JaxManager(str(tmp_path / "t")).restore({"w": 0, "i": 0})
    np.testing.assert_array_equal(np.asarray(back["w"], np.float32),
                                  np.asarray(jtree["w"], np.float32))
    manifests = []
    for d in ("j", "t"):
        with open(tmp_path / d / "step-000000001" / "manifest.json") as f:
            manifests.append(json.load(f)["index"])
    assert manifests[0] == manifests[1]


@pytest.mark.parametrize("dirty", [False, True])
def test_generation_crosses_packages(tmp_path, dirty):
    """A generation saved by the JAX package loads into the port with the
    same answers, and one saved by the port loads into the JAX package."""
    db, q = _db(seed=11, n=500), _queries(seed=12, n=50)
    cfg = _cfg(4, gamma=0.3, rho=0.2, online_rebalance=False)
    jidx = JaxIndex.build(db, jax_hybrid.HybridConfig(**cfg))
    tidx = KNNIndex.build(db, HybridConfig(**cfg), device="cpu")
    ins = _queries(seed=13, n=10)
    if dirty:
        for idx in (jidx, tidx):
            idx.insert(ins)
            idx.delete([0, 5, 503])
    full = np.concatenate([db, ins])
    jidx.save(str(tmp_path / "from_jax"))
    from_jax = KNNIndex.load(str(tmp_path / "from_jax"), device="cpu")
    assert from_jax.eps == jidx.eps and from_jax.is_clean == (not dirty)
    _match(from_jax.query(q), jidx.query(q), full, q)
    tidx.save(str(tmp_path / "from_port"))
    from_port = JaxIndex.load(str(tmp_path / "from_port"))
    assert from_port.eps == tidx.eps and from_port.n_points == tidx.n_points
    _match(tidx.query(q), from_port.query(q), full, q)
