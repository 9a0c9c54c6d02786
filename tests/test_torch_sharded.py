"""The port's mesh layer held to the JAX package on the same numpy inputs:
``launch/mesh.py``, ``core/distributed.py`` (the collective top-K merge,
the ring joins, ``hybrid_join_spmd``) and ``runtime/sharded_index.py``.

The JAX references come from ONE module-scoped subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (XLA fixes its
device count at the first jax import, so this process keeps its one CPU
device), written to a temporary ``.npz``.  The port runs the same inputs in
process on ``device="cpu"`` meshes.  It covers every case of
``tests/test_sharded_index.py``, the KNN cases of
``tests/test_distributed.py`` and
``test_mutable_index.py::test_sharded_mutations_match_oracle_and_compact_bitwise``.

Tolerances: integer metadata is bit-identical (``gids``, ``n_pad``,
``placement_shape``, the merge strategy, ``source``, ``coverage``,
``n_unresolved``), and so are the merge's outputs on the same blocks.  Ids
are equal except where two candidates' float64 distances tie within 1e-5;
distances agree within 2e-6 (rtol and atol); and every result also agrees
with ``tests/oracle.py`` within 1e-4.  Both packages build each sharded
index with the same pinned ε (``EPS``), since the port's ε sampling differs
from ``jax.random`` and another ε partitions the cloud differently."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from oracle import mutated_oracle, oracle_knn
from repro_torch.core import HybridConfig
from repro_torch.core import distributed as dist
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import Mesh, make_serving_mesh
from repro_torch.runtime import JoinSession, KNNIndex, ShardedKNNIndex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
TIE = 1e-5

PARAMS = [("ref", 1, 2), ("ref", 5, 4), ("ref", 3, 6), ("interpret", 3, 4), ("fused", 3, 4)]
# The cases the JAX subprocess also runs: one per backend (its engine
# compiles are what that subprocess's time goes to).
JAX_PARAMS = PARAMS[2:]
# The pinned ε of each sharded case: what the JAX package selects for its
# cloud and k, to 4 digits.  Both packages build with it (the port's ε
# sampling differs from jax.random, and another ε partitions differently).
EPS = {"p_ref_1_2": 0.1048, "p_ref_5_4": 0.1626, "p_ref_3_6": 0.1284,
       "p_interpret_3_4": 0.1284, "p_fused_3_4": 0.1284, "uneven": 0.1617,
       "tree": 0.1437, "m22": 0.1623, "mut": 0.3}


def make_db(seed=0, n_core=300, n_bg=140, dim=6):
    r = np.random.default_rng(seed)
    core = (0.05 * r.normal(size=(n_core, dim))).astype(np.float32)
    bg = r.uniform(-3.0, 3.0, (n_bg, dim)).astype(np.float32)
    return np.concatenate([core, bg]).astype(np.float32)


def make_queries(seed=1, n=97, dim=6):
    r = np.random.default_rng(seed)
    near = (0.05 * r.normal(size=(n - n // 3, dim))).astype(np.float32)
    far = r.uniform(3.0, 6.0, (n // 3, dim)).astype(np.float32)
    return np.concatenate([near, far]).astype(np.float32)


def merge_blocks(p, seed):
    """(P, Q, k_in) candidate blocks with distance ties, in-block duplicate
    ids, (inf, −1) padding, and exclusion ids that hit some candidates."""
    r = np.random.default_rng(seed)
    q, k_in = 37, 6
    d = np.sort(np.round(r.uniform(0, 2, (p, q, k_in)), 1).astype(np.float32), -1)
    i = r.integers(0, 60, (p, q, k_in)).astype(np.int32)
    i[:, ::5, 2] = i[:, ::5, 1]                       # duplicates within a block
    pad = r.random((p, q, k_in)) < 0.1
    d[pad] = np.inf
    i[pad] = -1
    d = np.sort(d, -1)
    excl = np.where(r.random(q) < 0.5, i[0, :, 0], -2).astype(np.int32)
    return d, i, excl


def spmd_points():
    r = np.random.default_rng(1)
    return np.concatenate([r.normal(0, 0.05, (384, 8)),
                           r.uniform(-3, 3, (128, 8))]).astype(np.float32)


def ring_points(seed, n, dim):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


# (name, seed, n, dim, shards, k, corpus_chunk, bf16)
RINGS = [("r8", 0, 512, 16, 8, 4, 4096, False),
         ("r8_32", 7, 256, 16, 8, 4, 4096, False),
         ("r8_16", 7, 256, 16, 8, 4, 4096, True),
         ("c8", 8, 128, 8, 4, 3, 8, False),
         ("c4096", 8, 128, 8, 4, 3, 4096, False),
         ("u4", 9, 300, 8, 4, 3, 4096, False),
         ("u8", 10, 520, 8, 8, 4, 16, False),
         ("u8_16", 10, 520, 8, 8, 4, 16, True)]

JAX_BODY = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import numpy as np
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_sharded import (EPS, JAX_PARAMS, RINGS, make_db, make_queries, merge_blocks,
                                ring_points, spmd_points)
from repro.core import HybridConfig, hybrid_join_spmd, ring_self_join
from repro.core.distributed import collective_topk_merge, ring_self_join_bf16
from repro.runtime import KNNIndex
from repro.launch.mesh import make_serving_mesh

out = {}


def mesh_of(p, axis):
    return jax.make_mesh((p,), (axis,), devices=jax.devices()[:p])


for p in (4, 8):
    d, i, excl = merge_blocks(p, seed=p)
    for strategy in ("allgather", "tree"):
        for dedup in (False, True):
            fn = collective_topk_merge(mesh_of(p, "shard"), ("shard",), k=4,
                                       strategy=strategy, dedup=dedup)
            md, mi = fn(d, i, excl)
            out[f"merge_{p}_{strategy}_{int(dedup)}_d"] = np.asarray(md)
            out[f"merge_{p}_{strategy}_{int(dedup)}_i"] = np.asarray(mi)

for name, seed, n, dim, shards, k, chunk, bf16 in RINGS:
    m = mesh_of(shards, "data")
    if bf16:
        fn = ring_self_join_bf16(m, ("data",), k=k, corpus_chunk=chunk)
    else:
        fn = ring_self_join(m, ("data",), k=k, kernel_mode="ref", corpus_chunk=chunk)
    rd, ri = fn(ring_points(seed, n, dim))
    out[f"ring_{name}_d"], out[f"ring_{name}_i"] = np.asarray(rd), np.asarray(ri)

pts = spmd_points()
res = hybrid_join_spmd(mesh_of(8, "data"), ("data",), k=4, rho=0.5, n_levels=3)(pts, 0.8)
spmd = {"s8": res}
db12 = make_db(seed=12, n_core=384, n_bg=128)
for rho in (0.25, 1.0):
    kw = dict(dense_budget=4096) if rho < 1.0 else {}
    spmd[f"s4_{rho}"] = hybrid_join_spmd(mesh_of(4, "data"), ("data",), k=4, m=6, rho=rho,
                                         gamma=0.2, n_levels=3, **kw)(db12, 0.8)
for key, r in spmd.items():
    out[f"spmd_{key}_d"], out[f"spmd_{key}_i"] = np.asarray(r.dists), np.asarray(r.ids)
    out[f"spmd_{key}_s"] = np.asarray(r.source)
    out[f"spmd_{key}_n"] = np.asarray(r.n_unresolved)


def sharded_case(key, db, q, cfg, mesh, self_join=True, **kw):
    idx = KNNIndex.build(db, cfg, EPS[key], mesh=mesh, **kw)
    out[f"{key}_gids"] = np.asarray(idx.gids)
    out[f"{key}_npad"] = np.int64(idx.n_pad)
    out[f"{key}_place"] = np.asarray(idx.placement_shape)
    r = idx.query(q)
    out[f"{key}_q_d"], out[f"{key}_q_i"] = r.dists, r.ids
    if self_join:
        r = idx.query(exclude_self=True)
        out[f"{key}_s_d"], out[f"{key}_s_i"] = r.dists, r.ids
    return idx


for backend, k, m in JAX_PARAMS:
    cfg = HybridConfig(k=k, m=m, gamma=0.3, rho=0.15, n_batches=2, backend=backend,
                       online_rebalance=False)
    sharded_case(f"p_{backend}_{k}_{m}", make_db(seed=10 + k), make_queries(seed=20 + k),
                 cfg, make_serving_mesh(4))

cfg = HybridConfig(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                   online_rebalance=False)
sharded_case("uneven", make_db(seed=3, n_core=300, n_bg=137), make_queries(seed=4), cfg,
             make_serving_mesh(4))
cfg3 = HybridConfig(k=3, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                    online_rebalance=False)
sharded_case("tree", make_db(seed=5), make_queries(seed=6), cfg3, make_serving_mesh(4),
             self_join=False, merge="tree")

# a 2 x 2 build, and a partial serve of shard 1 only
idx22 = sharded_case("m22", make_db(seed=30), make_queries(seed=31), cfg,
                     make_serving_mesh(2, replicas=2), self_join=False)
r = idx22.query(make_queries(seed=31), _serve_shards=(1,))
out["m22_part_d"], out["m22_part_i"], out["m22_part_cov"] = r.dists, r.ids, r.coverage

# the sharded mutation sequence, ε pinned (compact replays the argument)
mdb = make_db(seed=42, n_core=250, n_bg=111)
mq = make_queries(seed=5, n=53)
sh = KNNIndex.build(mdb, cfg3, EPS["mut"], mesh=make_serving_mesh(4))
ins = (0.05 * np.random.default_rng(7).normal(size=(9, 6))).astype(np.float32)
out["mut_gids"] = sh.insert(ins)
sh.delete([2, 50, 200, 361])
r = sh.query(mq)
out["mut_q_d"], out["mut_q_i"] = r.dists, r.ids
r = sh.query(exclude_self=True)
out["mut_s_d"], out["mut_s_i"] = r.dists, r.ids
out["mut_remap"] = sh.compact()
r = sh.query(mq)
out["mut_c_d"], out["mut_c_i"] = r.dists, r.ids
out["mut_c_gids"] = np.asarray(sh.gids)

np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Every JAX reference of this module, from one 8-device subprocess."""
    path = str(tmp_path_factory.mktemp("jax_mesh") / "ref.npz")
    code = f"ROOT = {ROOT!r}\nOUT = {path!r}\n" + textwrap.dedent(JAX_BODY)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with np.load(path) as f:
        return dict(f)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shards, replicas=1, axis="shard"):
    return make_serving_mesh(shards, axis=axis, replicas=replicas, device="cpu")


def near_ties(points, queries, got_i, want_i, exclude_self=False):
    """Ids equal except where the two candidates' float64 distances tie."""
    bad = np.argwhere(got_i != want_i)
    if len(bad) == 0:
        return
    p = np.asarray(points, np.float64)
    q = p if queries is None else np.asarray(queries, np.float64)
    r, c = bad[:, 0], bad[:, 1]
    assert (got_i[r, c] >= 0).all() and (want_i[r, c] >= 0).all(), "an id is missing"
    dg = np.linalg.norm(q[r] - p[got_i[r, c]], axis=1)
    dw = np.linalg.norm(q[r] - p[want_i[r, c]], axis=1)
    assert np.abs(dg - dw).max() <= TIE, f"{len(bad)} id mismatches beyond distance ties"


def hold(got_d, got_i, want_d, want_i, points, queries, k, exclude_self=False):
    """The port's result against the JAX one and the float64 oracle."""
    near_ties(points, queries, got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=TOL, atol=TOL)
    o_d, _ = oracle_knn(points, queries, k=k, exclude_self=exclude_self)
    np.testing.assert_allclose(np.sort(got_d, 1), o_d, atol=1e-4)
    for row in got_i:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real), "duplicate ids"


def assert_parity(sharded_res, single_res, refs, queries, k, mask_diag=False):
    """The JAX test's own check: sharded vs the single-device index (here the
    port's), identical ids, distances within 2e-6, both against float64."""
    np.testing.assert_array_equal(sharded_res.ids, single_res.ids)
    np.testing.assert_allclose(sharded_res.dists, single_res.dists, rtol=TOL, atol=TOL)
    want = oracle_knn(refs, queries, k=k, exclude_self=mask_diag)[0]
    np.testing.assert_allclose(np.sort(sharded_res.dists, 1), want, atol=1e-4)
    assert ((sharded_res.ids >= 0) & (sharded_res.ids < len(refs))).all()


# ---------------------------------------------------------------------------
# launch/mesh.py
# ---------------------------------------------------------------------------

def test_serving_mesh_shapes_and_slots():
    m = make_serving_mesh(4, device="cpu")
    assert m.axis_names == ("shard",) and dict(m.shape) == {"shard": 4}
    assert m.devices.shape == (4,) and all(d == torch.device("cpu") for d in m.devices)
    m22 = make_serving_mesh(2, axis="data", replicas=2, device="cpu")
    assert m22.axis_names == ("replica", "data") and list(m22.shape.values()) == [2, 2]
    assert m22.devices.shape == (2, 2) and mesh_lib.mesh_chip_count(m22) == 4
    assert make_serving_mesh(device="cpu").shape["shard"] == 1     # one per device
    with pytest.raises(ValueError, match="replicas"):
        make_serving_mesh(2, replicas=0, device="cpu")
    with pytest.raises(ValueError):
        make_serving_mesh(replicas=2, device="cpu")                # 1 device, 2 groups
    host = mesh_lib.make_host_mesh(device="cpu")
    assert host.axis_names == ("data", "model") and host.devices.shape == (1, 1)
    pod = mesh_lib.make_production_mesh(device="cpu")
    assert pod.axis_names == ("data", "model") and pod.devices.shape == (16, 16)
    multi = mesh_lib.make_production_mesh(multi_pod=True, device="cpu")
    assert multi.axis_names == ("pod", "data", "model") and multi.devices.shape == (2, 16, 16)
    assert set(multi.slot_devices) == {"cpu"} and mesh_lib.mesh_chip_count(multi) == 512
    assert hash(m) == hash(make_serving_mesh(4, device="cpu")) and isinstance(m, Mesh)
    # shard slots of a replicated mesh: replica 0's row
    assert dist.shard_devices(m22, ("data",)) == [torch.device("cpu")] * 2


def test_slots_wrap_over_the_cards(monkeypatch):
    """Slot (r, s) sits on card (r·n + s) mod the card count: 2 × 2 on one
    card is four slots of cuda:0, on three cards cuda:0,1,2,0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, want in ((1, ["cuda:0"] * 4), (3, ["cuda:0", "cuda:1", "cuda:2", "cuda:0"])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        m = make_serving_mesh(2, replicas=2)
        assert [str(d) for d in m.devices.reshape(-1)] == want


# ---------------------------------------------------------------------------
# core/distributed.py against the JAX functions
# ---------------------------------------------------------------------------

def test_merge_strategy_resolution():
    assert dist.merge_strategy(4, "auto") == "allgather"
    assert dist.merge_strategy(8, "auto") == "tree"
    assert dist.merge_strategy(6, "auto") == "allgather"
    with pytest.raises(ValueError):
        dist.merge_strategy(6, "tree")
    with pytest.raises(ValueError):
        dist.merge_strategy(4, "ring")


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("strategy", ["allgather", "tree"])
@pytest.mark.parametrize("dedup", [False, True])
def test_collective_merge_bit_identical(ref, p, strategy, dedup):
    d, i, excl = merge_blocks(p, seed=p)
    fn = dist.collective_topk_merge(cpu_mesh(p), ("shard",), k=4, strategy=strategy,
                                    dedup=dedup)
    md, mi = fn(torch.as_tensor(d), torch.as_tensor(i), torch.as_tensor(excl))
    key = f"merge_{p}_{strategy}_{int(dedup)}"
    np.testing.assert_array_equal(mi.numpy(), ref[key + "_i"])
    np.testing.assert_array_equal(md.numpy(), ref[key + "_d"])


@pytest.mark.parametrize("case", RINGS, ids=[c[0] for c in RINGS])
def test_ring_self_join_matches_jax(ref, case):
    name, seed, n, dim, shards, k, chunk, bf16 = case
    pts = ring_points(seed, n, dim)
    make = dist.ring_self_join_bf16 if bf16 else dist.ring_self_join
    d, i = make(cpu_mesh(shards, axis="data"), ("data",), k=k, corpus_chunk=chunk)(pts)
    d, i = d.numpy(), i.numpy()
    assert d.shape == (n, k) and i.shape == (n, k)
    assert int(i.min()) >= 0 and not (i == np.arange(n)[:, None]).any()
    want_d, want_i = ref[f"ring_{name}_d"], ref[f"ring_{name}_i"]
    if bf16:
        # The same bf16 wire rounding on both sides: the same answers.
        np.testing.assert_allclose(d, want_d, rtol=TOL, atol=TOL)
        assert (i == want_i).mean() > 0.99
        return
    near_ties(pts, None, i, want_i)
    np.testing.assert_allclose(d, want_d, rtol=TOL, atol=TOL)
    o_d, _ = oracle_knn(pts, k=k, exclude_self=True, squared=True)
    assert np.abs(d - o_d).max() < 1e-4, "ring join inexact"


def test_ring_bf16_wire_near_exact():
    """``test_ring_self_join_bf16_wire_near_exact``: the bf16 wire against
    the f32 ring, within bf16 key precision."""
    pts = ring_points(7, 256, 16)
    m = cpu_mesh(8, axis="model")
    d32, i32 = dist.ring_self_join(m, ("model",), k=4)(pts)
    d16, i16 = dist.ring_self_join_bf16(m, ("model",), k=4)(pts)
    rel = (d16 - d32).abs().numpy() / np.maximum(d32.numpy(), 1e-3)
    assert rel.max() < 0.1, rel.max()
    overlap = np.mean([len(set(a) & set(b)) / 4 for a, b in zip(i16.numpy(), i32.numpy())])
    assert overlap > 0.9, overlap


def test_ring_join_chunk_sizes_agree():
    pts = ring_points(8, 128, 8)
    m = cpu_mesh(4, axis="model")
    d1, i1 = dist.ring_self_join(m, ("model",), k=3, corpus_chunk=8)(pts)
    d2, i2 = dist.ring_self_join(m, ("model",), k=3, corpus_chunk=4096)(pts)
    assert torch.allclose(d1, d2, rtol=1e-5) and torch.equal(i1, i2)


@pytest.mark.parametrize("key", ["s8", "s4_0.25", "s4_1.0"])
def test_hybrid_join_spmd_matches_jax(ref, key):
    """Sources and ``n_unresolved`` bit-identical; the resolved rows exact."""
    if key == "s8":
        pts, slots, kw = spmd_points(), 8, dict(k=4, rho=0.5, n_levels=3)
    else:
        rho = float(key.split("_")[1])
        pts, slots = make_db(seed=12, n_core=384, n_bg=128), 4
        kw = dict(k=4, m=6, rho=rho, gamma=0.2, n_levels=3)
        if rho < 1.0:
            kw["dense_budget"] = 4096
    res = dist.hybrid_join_spmd(cpu_mesh(slots, axis="data"), ("data",), **kw)(pts, 0.8)
    src = res.source.numpy()
    np.testing.assert_array_equal(src, ref[f"spmd_{key}_s"])
    assert res.n_unresolved == int(ref[f"spmd_{key}_n"]) == int((src == 3).sum())
    assert res.n_unresolved == 0
    ok = src != 3
    d, i = res.dists.numpy(), res.ids.numpy()
    near_ties(pts, None, i[ok], ref[f"spmd_{key}_i"][ok])
    np.testing.assert_allclose(d[ok], ref[f"spmd_{key}_d"][ok], rtol=TOL, atol=TOL)
    o_d, _ = oracle_knn(pts, k=4, exclude_self=True, squared=True)
    assert np.abs(np.where(ok[:, None], d - o_d, 0.0)).max() < 1e-4
    if key == "s4_1.0":
        assert not (src == 0).any()                  # ρ = 1 demotes every query


def test_spmd_join_routes_through_splitter():
    """The dense-resolved set equals ``split_from_counts``' prediction on
    each slot's contiguous query range."""
    from repro_torch.core import grid as grid_lib
    from repro_torch.core import splitter as split_lib
    db = make_db(seed=12, n_core=384, n_bg=128)
    k, m, gamma, rho, eps = 4, 6, 0.2, 0.25, 0.8
    res = dist.hybrid_join_spmd(cpu_mesh(4, axis="data"), ("data",), k=k, m=m, rho=rho,
                                gamma=gamma, dense_budget=4096, n_levels=3)(db, eps)
    pts = torch.as_tensor(db)
    index = grid_lib.build_grid(pts, torch.tensor(eps, dtype=torch.float32), m)
    home = index.cell_counts[index.point_cell_pos.long()]
    src = res.source.numpy()
    q_loc = len(db) // 4
    for s in range(4):
        rows = slice(s * q_loc, (s + 1) * q_loc)
        split = split_lib.split_from_counts(home[rows], k, m, gamma, rho)
        np.testing.assert_array_equal(src[rows] == 0, split.to_dense.numpy())
    with pytest.raises(ValueError, match="multiple of the slot count"):
        dist.hybrid_join_spmd(cpu_mesh(3, axis="data"), ("data",), k=k)(db[:511], eps)


# ---------------------------------------------------------------------------
# runtime/sharded_index.py against the JAX index
# ---------------------------------------------------------------------------

def _pinned(ref, key, db, cfg, mesh, **kw):
    idx = KNNIndex.build(db, cfg, EPS[key], mesh=mesh, **kw)
    assert isinstance(idx, ShardedKNNIndex)
    if key + "_gids" not in ref:
        return idx
    np.testing.assert_array_equal(idx.gids, ref[f"{key}_gids"])
    assert idx.n_pad == int(ref[f"{key}_npad"])
    assert idx.placement_shape == tuple(ref[f"{key}_place"])
    return idx


@pytest.mark.parametrize("backend,k,m", PARAMS)
def test_sharded_query_matches_single_device_and_jax(ref, backend, k, m):
    """``test_sharded_query_matches_single_device``: self-join and R≠S on 4
    shards ≡ the single-device pipeline, and (one case per backend) ≡ the
    JAX sharded index."""
    db, q = make_db(seed=10 + k), make_queries(seed=20 + k)
    cfg = HybridConfig(k=k, m=m, gamma=0.3, rho=0.15, n_batches=2, backend=backend,
                       online_rebalance=False)
    key = f"p_{backend}_{k}_{m}"
    sharded = _pinned(ref, key, db, cfg, cpu_mesh(4))
    single = KNNIndex.build(db, cfg, sharded.eps, device="cpu")
    rq, rs = sharded.query(q), sharded.query(exclude_self=True)
    assert_parity(rq, single.query(q), db, q, k)
    assert_parity(rs, single.query(exclude_self=True), db, db, k, mask_diag=True)
    if (backend, k, m) not in JAX_PARAMS:
        return
    hold(rq.dists, rq.ids, ref[key + "_q_d"], ref[key + "_q_i"], db, q, k)
    hold(rs.dists, rs.ids, ref[key + "_s_d"], ref[key + "_s_i"], db, None, k,
         exclude_self=True)


def test_uneven_db_pads_and_dedups(ref):
    """|D| % P ≠ 0: each of the first n_pad shards repeats one resident row
    and the merge suppresses the repeated global id."""
    db, q = make_db(seed=3, n_core=300, n_bg=137), make_queries(seed=4)
    cfg = HybridConfig(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                       online_rebalance=False)
    sharded = _pinned(ref, "uneven", db, cfg, cpu_mesh(4))
    assert sharded.n_pad == 3 and sharded.shard_n == 110
    single = KNNIndex.build(db, cfg, sharded.eps, device="cpu")
    rq, rs = sharded.query(q), sharded.query(exclude_self=True)
    assert_parity(rq, single.query(q), db, q, 4)
    assert_parity(rs, single.query(exclude_self=True), db, db, 4, mask_diag=True)
    hold(rq.dists, rq.ids, ref["uneven_q_d"], ref["uneven_q_i"], db, q, 4)
    with pytest.raises(ValueError, match="shard"):
        KNNIndex.build(db[:3], HybridConfig(k=1, m=4), mesh=cpu_mesh(4))


def test_merge_strategies_agree(ref):
    """The all-gather fold and the tree give identical output, and the tree
    matches the JAX butterfly."""
    db, q = make_db(seed=5), make_queries(seed=6)
    cfg = HybridConfig(k=3, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                       online_rebalance=False)
    tr = _pinned(ref, "tree", db, cfg, cpu_mesh(4), merge="tree")
    ag = KNNIndex.build(db, cfg, tr.eps, mesh=cpu_mesh(4), merge="allgather")
    assert (tr.merge, ag.merge) == ("tree", "allgather")
    ra, rt = ag.query(q), tr.query(q)
    np.testing.assert_array_equal(ra.ids, rt.ids)
    np.testing.assert_array_equal(ra.dists, rt.dists)
    hold(rt.dists, rt.ids, ref["tree_q_d"], ref["tree_q_i"], db, q, 3)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_zero_compile_steady_state_per_mesh_shape(n_shards):
    """Same-bucket repeats add no engine bucket, the merge's included, and P
    equal shards share one merge bucket per (shape bucket, k)."""
    db, q = make_db(seed=7, n_core=280, n_bg=120), make_queries(seed=8, n=120)
    cfg = HybridConfig(k=3, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                       online_rebalance=False)
    from repro_torch.runtime import clear_engine_cache
    clear_engine_cache()
    index = KNNIndex.build(db, cfg, mesh=cpu_mesh(n_shards))
    cold = index.query(q)
    assert cold.stats.n_engine_compiles > 0
    assert index.compile_counts["merge"] == 1, index.compile_counts
    warm = index.query(q.copy())
    assert warm.stats.n_engine_compiles == 0, (n_shards, index.compile_counts)
    np.testing.assert_array_equal(cold.ids, warm.ids)
    index.query(exclude_self=True)
    assert index.query(exclude_self=True).stats.n_engine_compiles == 0


def test_session_mesh_plumbing():
    """JoinSession(mesh=...) owns a sharded index: join() is the sharded
    self-join, index_for() serves R≠S, counters are shared."""
    db, q = make_db(seed=9), make_queries(seed=11, n=64)
    cfg = HybridConfig(k=2, m=4, n_batches=2, backend="ref", online_rebalance=False)
    sess = JoinSession(cfg, mesh=cpu_mesh(4))
    res = sess.join(db)
    single = KNNIndex.build(db, cfg, sess.index_for(db).eps, device="cpu")
    np.testing.assert_array_equal(res.ids, single.query(exclude_self=True).ids)
    index = sess.index_for(db)
    assert isinstance(index, ShardedKNNIndex)
    assert index is sess.index_for(db)
    rq = index.query(q)
    np.testing.assert_allclose(np.sort(rq.dists, 1), oracle_knn(db, q, k=2)[0], atol=1e-4)
    assert sess.total_compiles == index.total_compiles
    assert "merge" in sess.compile_counts


def test_replicated_build_and_partial_serve_match_jax(ref):
    """A 2 × 2 build: the same partition and placement; a partial serve of
    shard 1 has the same coverage and answers."""
    db, q = make_db(seed=30), make_queries(seed=31)
    cfg = HybridConfig(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                       online_rebalance=False)
    idx = _pinned(ref, "m22", db, cfg, cpu_mesh(2, replicas=2))
    r = idx.query(q)
    hold(r.dists, r.ids, ref["m22_q_d"], ref["m22_q_i"], db, q, 4)
    part = idx.query(q, _serve_shards=(1,))
    np.testing.assert_array_equal(part.coverage, ref["m22_part_cov"])
    assert part.stats.shards_skipped == (0,)
    near_ties(db, q, part.ids, ref["m22_part_i"])
    np.testing.assert_allclose(part.dists, ref["m22_part_d"], rtol=TOL, atol=TOL)
    owned1 = idx.gids[1]
    assert np.isin(part.ids, owned1).all()
    o_d, _ = oracle_knn(db[np.unique(owned1)], q, k=4)
    np.testing.assert_allclose(np.sort(part.dists, 1), o_d, atol=1e-4)


def test_sharded_mutations_match_oracle_and_compact_bitwise(ref):
    """The mutation contract on 4 shards over an uneven 361-point cloud:
    inserts, deletes, R≠S and self-join exact over the net corpus and equal
    to the JAX index; compact() equals a fresh sharded build bitwise."""
    db = make_db(seed=42, n_core=250, n_bg=111)
    cfg = HybridConfig(k=3, m=4, gamma=0.3, rho=0.15, n_batches=2, backend="ref",
                       online_rebalance=False)
    mesh = cpu_mesh(4)
    sh = KNNIndex.build(db, cfg, EPS["mut"], mesh=mesh)
    ins = (0.05 * np.random.default_rng(7).normal(size=(9, 6))).astype(np.float32)
    gids = sh.insert(ins)
    np.testing.assert_array_equal(gids, ref["mut_gids"])
    assert list(gids) == list(range(361, 370))
    dels = [2, 50, 200, 361]
    sh.delete(dels)
    assert sh.n_points == 361 + 9 - 4 and not sh.is_clean

    q = make_queries(seed=5, n=53)
    net, live = mutated_oracle(db, ins, dels)
    full = np.concatenate([db, ins])
    res = sh.query(q)
    want_d, _ = oracle_knn(net, q, k=3)
    np.testing.assert_allclose(np.sort(res.dists, 1), want_d, atol=1e-4)
    got_d = np.linalg.norm(q[:, None, :].astype(np.float64) - full[res.ids], axis=-1)
    np.testing.assert_allclose(np.sort(got_d, 1), want_d, atol=1e-4)
    assert np.isin(res.ids, live).all()
    near_ties(full, q, res.ids, ref["mut_q_i"])
    np.testing.assert_allclose(res.dists, ref["mut_q_d"], rtol=TOL, atol=TOL)

    rs = sh.query(exclude_self=True)
    wd, _ = oracle_knn(net, k=3, exclude_self=True)
    np.testing.assert_allclose(np.sort(rs.dists, 1), wd, atol=1e-4)
    assert (rs.ids != live[:, None]).all()
    near_ties(full, net, rs.ids, ref["mut_s_i"])
    np.testing.assert_allclose(rs.dists, ref["mut_s_d"], rtol=TOL, atol=TOL)

    remap = sh.compact()
    np.testing.assert_array_equal(remap, ref["mut_remap"])
    assert sh.is_clean and sh.generation == 1
    assert remap[2] == -1 and remap[0] == 0 and remap[3] == 2
    np.testing.assert_array_equal(sh.gids, ref["mut_c_gids"])
    fresh = KNNIndex.build(sh.points, cfg, EPS["mut"], mesh=mesh)
    got, want = sh.query(q), fresh.query(q)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    hold(got.dists, got.ids, ref["mut_c_d"], ref["mut_c_i"], sh.points, q, 3)


# ---------------------------------------------------------------------------
# entry points: meshes served, and what still refuses
# ---------------------------------------------------------------------------

def test_mesh_guards():
    db = make_db(seed=1)
    with pytest.raises(TypeError, match="object"):
        KNNIndex.build(db, HybridConfig(k=2), device="cpu", mesh=object())
    with pytest.raises(TypeError, match="str"):
        JoinSession(HybridConfig(k=2), device="cpu", mesh="shard")
    with pytest.raises(ValueError, match="projection"):
        KNNIndex.build(db, HybridConfig(k=2, projection_dim=4), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="single mesh axis"):
        dist.collective_topk_merge(cpu_mesh(2, replicas=2), ("replica", "shard"), k=2,
                                   strategy="tree")
