"""The port's engine-bucket memory records — ``cache_info()`` and
``memory_analysis()`` on ``JoinSession``, ``KNNIndex`` and
``ShardedKNNIndex`` — against the JAX package and against hand counts, on
the CPU at smoke sizes, and the ``utils`` byte / timer helpers.

Both packages build with ε pinned: their ε selections draw different
random streams, so an automatic ε would split the queries, and open the
buckets, differently.  ``cache_info()`` must equal the JAX package's after
the same calls, and ``memory_analysis()`` must name the same engine kinds.
The byte counts are held to hand counts from the index's tensors and the
padded shapes, not to XLA's figures (XLA leaves unused operands out of its
argument bytes and adds tuple headers to its output bytes).  On the CPU a
record has no ``temp_size_in_bytes`` and ``generated_code_size_in_bytes``
is 0: no kernel runs."""
import time

import numpy as np
import pytest
import torch

import repro.core.hybrid as jax_hybrid
from conftest import make_mixture
from repro import utils as jax_utils
from repro.launch.mesh import make_serving_mesh as jax_serving_mesh
from repro.runtime import JoinSession as JaxSession
from repro.runtime import KNNIndex as JaxIndex
from repro.runtime import clear_engine_cache as jax_clear_engine_cache
from repro_torch import utils
from repro_torch.core import HybridConfig
from repro_torch.core import grid as grid_lib
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.runtime import JoinSession, KNNIndex, ShardedKNNIndex
from repro_torch.runtime import knn_index
from repro_torch.runtime import session as session_lib

EPS = 0.15
KW = dict(k=4, m=4, gamma=0.3, rho=0.15, n_batches=2, online_rebalance=False)
BASE = make_mixture(300, 140, dim=6, seed=3)            # 440 × 6
_rng = np.random.default_rng(1)
# 20 rows in the dense cluster, 17 in the sparse background: both engines run.
QUERIES = np.concatenate([_rng.normal(0, 0.05, (20, 6)),
                          _rng.uniform(-3, 3, (17, 6))]).astype(np.float32)
INSERTS = (0.05 * np.random.default_rng(7).normal(size=(9, 6))).astype(np.float32)
DELETES = [2, 50, 443]                   # two base ids and one delta id
FIELDS = {"argument_size_in_bytes", "output_size_in_bytes",
          "generated_code_size_in_bytes"}
QB = HybridConfig(k=1).query_block     # every call below pads to one block


def _clear():
    jax_clear_engine_cache()
    knn_index.clear_engine_cache()


def _cfg(**kw):
    return HybridConfig(**{**KW, **kw})


def _grid_bytes(n: int, m: int, d: int = 0) -> int:
    """A ``GridIndex`` over ``n`` points and ``m`` indexed dims, all 4-byte
    fields: ``epsilon`` and ``n_cells``; ``mins``, ``cell_edge``,
    ``cells_per_dim``, ``radices`` (m,); ``unique_cells``, ``cell_starts``,
    ``cell_counts``, ``order``, ``point_cell_pos`` (n,); ``point_coords``
    (n, m); with ``d`` the cell-sorted (n, d) copy of the points."""
    return 4 * (2 + 4 * m + 5 * n + n * m + n * d)


def _topk_bytes(rows: int, k: int) -> int:
    """(rows, k) f32 distances and i32 ids."""
    return rows * k * 8


def test_cache_info_matches_jax():
    """The same calls in both packages — a session's self-join, an R≠S
    query and its repeat, an insert and delete then a query, a sharded
    query on a one-device mesh — leave equal ``cache_info()`` and
    ``memory_analysis()`` kinds; the session's is ``{}`` before a join."""
    _clear()
    js = JaxSession(jax_hybrid.HybridConfig(**KW))
    ts = JoinSession(_cfg(), device="cpu")
    assert js.memory_analysis() == ts.memory_analysis() == {}

    def same(j, t):
        assert t.cache_info() == j.cache_info()
        mem = t.memory_analysis()
        assert set(mem) == set(j.memory_analysis())
        for kind, rec in mem.items():
            assert set(rec) == FIELDS, kind
            assert rec["generated_code_size_in_bytes"] == 0
        return t.cache_info()

    js.join(BASE, EPS)
    ts.join(BASE, EPS)
    same(js, ts)
    ji, ti = js.index_for(BASE, EPS), ts.index_for(BASE, EPS)
    ji.query(QUERIES)
    ti.query(QUERIES)
    info = same(ji, ti)
    same(js, ts)
    ji.query(QUERIES.copy())
    ti.query(QUERIES.copy())
    assert same(ji, ti) == info                   # the repeat opens nothing
    for idx in (ji, ti):
        idx.insert(INSERTS)
        idx.delete(DELETES)
        idx.query(QUERIES)
    same(ji, ti)
    assert {"delta", "merge"} <= set(ti.memory_analysis())
    jsh = JaxIndex.build(BASE, jax_hybrid.HybridConfig(**KW), EPS, mesh=jax_serving_mesh(1))
    tsh = KNNIndex.build(BASE, _cfg(), EPS, mesh=make_serving_mesh(1, device="cpu"))
    assert isinstance(tsh, ShardedKNNIndex)
    jsh.query(QUERIES)
    tsh.query(QUERIES)
    same(jsh, tsh)
    assert "merge" in tsh.memory_analysis()


def _ran(res):
    return {"dense": res.stats.n_dense > 0, "sparse": res.stats.n_sparse > 0}


def _state_bytes(t):
    """(grid, pyramid, points_r) bytes of a clean single-device index,
    counted from its shapes."""
    n, d = t.points_r.shape
    m, levels = t.grid.m, len(t.pyramid.levels)
    return (_grid_bytes(n, m, d), levels * _grid_bytes(n, m) + 4 * levels, n * d * 4)


@pytest.mark.parametrize("case", ["dense", "sparse", "brute-ip", "delta", "merge",
                                  "sharded-merge"])
def test_record_bytes_equal_hand_count(case):
    """Argument bytes are the bucket's signature (the padded ids and the
    padded query rows included); output bytes the engine's result — for
    the brute lane the live rows only."""
    _clear()
    k = KW["k"]
    n_q, d = QUERIES.shape
    rows = QB * d * 4                                    # the padded query rows
    if case in ("dense", "sparse"):
        t = KNNIndex.build(BASE, _cfg(), EPS, device="cpu")
        res = t.query(QUERIES)
        assert _ran(res)[case], res.stats
        grid, pyr, pts = _state_bytes(t)
        want_arg = {"dense": grid + pts + QB * 4 + 4 + rows,   # + ids, ε operand
                    "sparse": pyr + pts + QB * 4 + rows}[case]
        want_out = _topk_bytes(QB, k) + QB * 9   # + found|certified, failed|level, totals
    elif case == "brute-ip":
        t = KNNIndex.build(BASE, _cfg(metric="ip"), EPS, device="cpu")
        t.query(QUERIES)
        case = "brute"
        want_arg = _state_bytes(t)[2] + QB * 4 + rows
        want_out = _topk_bytes(n_q, k)
    elif case in ("delta", "merge"):
        t = KNNIndex.build(BASE, _cfg(), EPS, device="cpu")
        t.insert(INSERTS)
        t.delete(DELETES)
        t.query(QUERIES)
        n_delta = 32                                     # DELTA_BLOCK bucket of 9 rows
        k_main = k + 8                                   # 2 tombstones: a headroom bucket
        want_arg = {"delta": rows + n_delta * d * 4 + QB * 4 + n_delta * 4,
                    "merge": _topk_bytes(QB, k_main) + _topk_bytes(QB, k) + 8 * 4
                    + QB * 4}[case]
        want_out = _topk_bytes(QB, k)
    else:
        t = KNNIndex.build(BASE, _cfg(), EPS, mesh=make_serving_mesh(2, device="cpu"))
        t.query(QUERIES)
        case = "merge"
        want_arg = 2 * _topk_bytes(QB, k) + QB * 4       # (2, QB, k) blocks + exclusions
        want_out = _topk_bytes(QB, k)
    rec = t.memory_analysis()[case]
    assert rec == {"argument_size_in_bytes": want_arg, "output_size_in_bytes": want_out,
                   "generated_code_size_in_bytes": 0}


def test_hit_keeps_record_new_bucket_replaces(monkeypatch):
    """A repeat in seen buckets takes no record (a dict lookup) and leaves
    ``cache_info()``, the records and the record seconds as they were; a
    larger batch opens new buckets, whose records replace the kinds'."""
    _clear()
    t = KNNIndex.build(BASE, _cfg(), EPS, device="cpu")
    t.query(QUERIES)
    info, recs, secs = t.cache_info(), t.memory_analysis(), dict(t.t_record)
    assert all(s >= 0 for s in secs.values()) and set(secs) == set(recs)

    def no_record(*a, **kw):
        raise AssertionError("a hit took a record")

    with monkeypatch.context() as m:
        m.setattr(knn_index, "_recorded_call", no_record)
        res = t.query(QUERIES.copy())
    assert res.stats.n_engine_compiles == 0
    assert t.cache_info() == info and t.memory_analysis() == recs and t.t_record == secs
    assert all(rec in knn_index._ENGINE_CACHE.values() for rec in t.executables.values())

    big = np.concatenate([QUERIES] * 6)                  # 222 rows: a 256-row bucket
    res = t.query(big)
    assert res.stats.n_engine_compiles > 0
    assert t.cache_info()["global_entries"] == info["global_entries"] + res.stats.n_engine_compiles
    after = t.memory_analysis()
    for kind, ran in _ran(res).items():
        if ran:
            assert after[kind]["argument_size_in_bytes"] > recs[kind]["argument_size_in_bytes"]


def test_record_time_stays_out_of_engine_timers(monkeypatch):
    """A record's own seconds go to ``t_record``, not to ``t_dense`` /
    ``t_sparse`` / ``t_brute`` (the JAX package keeps its compile out of
    the same windows); the wall time still holds them.  Each record here
    moves the clock on by ``slow`` seconds instead of taking them."""
    _clear()
    slow = 1000.0
    real_clock, real_record = time.perf_counter, knn_index._recorded_call
    skew = [0.0]

    def slow_record(fn, args, kwargs):
        out, rec, seconds = real_record(fn, args, kwargs)
        skew[0] += slow
        return out, rec, seconds + slow

    monkeypatch.setattr(time, "perf_counter", lambda: real_clock() + skew[0])
    monkeypatch.setattr(knn_index, "_recorded_call", slow_record)
    t = KNNIndex.build(BASE, _cfg(), EPS, device="cpu")
    res = t.query(QUERIES)
    ran = [kind for kind, r in _ran(res).items() if r]
    assert len(ran) == 2 and all(t.t_record[kind] >= slow for kind in ran)
    assert res.stats.t_dense < slow / 2 and res.stats.t_sparse < slow / 2
    assert res.stats.t_wall >= 2 * slow
    ip = KNNIndex.build(BASE, _cfg(metric="ip"), EPS, device="cpu")
    res = ip.query(QUERIES)
    assert ip.t_record["brute"] >= slow and res.stats.t_brute < slow / 2


def test_session_and_sharded_share_records():
    """A session on a 2-slot mesh reports ``{}`` before its first join and
    the collective ``"merge"`` after it, its index and every shard writing
    the session's own dict; the self-join's merge record is its hand
    count (k + 1 candidates a shard for the self-exclusion, 440 rows in a
    512-row bucket)."""
    _clear()
    assert session_lib.KNNIndex is KNNIndex
    assert session_lib._ENGINE_CACHE is knn_index._ENGINE_CACHE
    s = JoinSession(_cfg(), device="cpu", mesh=make_serving_mesh(2, device="cpu"))
    assert s.memory_analysis() == {} and s.cache_info()["merge"] == 0
    s.join(BASE, EPS)
    idx = s.index_for(BASE, EPS)
    assert idx.executables is s.executables
    assert all(sh.executables is s.executables for sh in idx.shards)
    mem = s.memory_analysis()
    assert {"merge", "sparse"} <= set(mem) and mem == idx.memory_analysis()
    k, rows = KW["k"], 512
    assert mem["merge"] == {"argument_size_in_bytes": 2 * _topk_bytes(rows, k + 1) + rows * 4,
                            "output_size_in_bytes": _topk_bytes(rows, k),
                            "generated_code_size_in_bytes": 0}
    assert s.cache_info() == {"global_entries": len(knn_index._ENGINE_CACHE),
                              **s.compile_counts}


@pytest.mark.parametrize("mesh", [None, 2])
def test_executables_through_load_and_compact(tmp_path, mesh):
    """``executables=`` reaches the index ``load`` rebuilds (and each of
    its shards), and ``compact`` builds the next generation into the same
    dict: its records count the compacted corpus."""
    _clear()
    place = {} if mesh is None else {"mesh": make_serving_mesh(mesh, device="cpu")}
    t = KNNIndex.build(BASE, _cfg(), EPS, device="cpu", **place)
    t.save(str(tmp_path))
    execs = {}
    loaded = KNNIndex.load(str(tmp_path), device="cpu", executables=execs, **place)
    assert loaded.executables is execs and not execs
    loaded.query(QUERIES)
    assert {"dense", "sparse"} & set(execs)
    shards = [] if mesh is None else loaded.shards
    assert all(sh.executables is execs for sh in shards)

    loaded.insert(INSERTS)
    loaded.delete(DELETES)
    loaded.compact()
    loaded.query(exclude_self=True)
    assert loaded.executables is execs
    shards = [] if mesh is None else loaded.shards
    assert all(sh.executables is execs for sh in shards)
    n, d = len(BASE) + len(INSERTS) - len(DELETES), BASE.shape[1]
    rows = utils.pow2_bucket(n, QB)
    if mesh is None:
        # The dense self-join's signature: the compacted grid and rows, and
        # the padded ids.
        grid = _grid_bytes(n, KW["m"], d) + n * d * 4 + 4
        pad = execs["dense"]["argument_size_in_bytes"] - grid
        assert pad % 4 == 0 and pad // 4 == utils.pow2_bucket(pad // 4, QB)
    else:
        # The merge of the compacted self-join: k + 1 candidates a shard.
        assert execs["merge"]["argument_size_in_bytes"] == \
            mesh * _topk_bytes(rows, KW["k"] + 1) + rows * 4


def _leaf_tree():
    g = grid_lib.build_grid(torch.as_tensor(BASE[:50]), torch.tensor(0.5), 4)
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(5, dtype=torch.int64), None,
                                          (torch.zeros(7, dtype=torch.bool),)],
            "meta": torch.empty(2, 3, dtype=torch.float16, device="meta"), "grid": g,
            "skip": (np.zeros(9), 3.0, "x")}
    return tree, 3 * 4 * 4 + 5 * 8 + 7 + 2 * 3 * 2 + _grid_bytes(50, 4, 6)


def test_tree_bytes_descends_into_dataclasses():
    """Tensor leaves of dicts, lists, tuples and the port's dataclasses
    (a ``GridIndex``), ``meta`` tensors by shape; anything else counts 0 —
    and the JAX package's count of the same arrays agrees."""
    tree, want = _leaf_tree()
    assert utils.tree_bytes(tree) == want
    assert utils.tree_bytes(None) == utils.tree_bytes({}) == 0
    arrays = {"a": np.zeros((3, 4), np.float32), "b": [np.zeros(5, np.int32)]}
    assert utils.tree_bytes({"a": torch.zeros(3, 4), "b": [torch.zeros(5, dtype=torch.int32)]}) \
        == jax_utils.tree_bytes(arrays)


@pytest.mark.parametrize("n", [0, 1023, 1024, 3 * 2**20 + 5, 7.5 * 2**30, 2**52])
def test_human_bytes_matches_jax(n):
    assert utils.human_bytes(n) == jax_utils.human_bytes(n)


def test_timer_and_timed_on_cpu():
    """``timed`` runs warmup + repeats calls and returns the best time with
    the last result; ``Timer`` measures its block (a CPU device has nothing
    to wait for)."""
    calls = []

    def fn(x, scale=1):
        calls.append(x)
        time.sleep(0.002)
        return {"y": torch.full((2,), float(x * scale))}

    best, out = utils.timed(fn, 3, repeats=2, warmup=1, scale=2)
    assert calls == [3, 3, 3] and best >= 0.002
    assert torch.equal(out["y"], torch.full((2,), 6.0))
    with utils.Timer("cpu") as tm:
        time.sleep(0.01)
    assert tm.elapsed >= 0.01
    with utils.Timer() as tm:
        pass
    assert 0 <= tm.elapsed < 0.01
