"""Crash-mid-checkpoint drills on the port (``tests/test_fault_serving.py``'s
single-device cases, run through ``repro_torch.runtime.faults``):
a crash before the atomic rename (``pre-arrays``, ``pre-manifest``) leaves
the previous generation as the restore target and a retried save lands; a
crash after the rename but before ``LATEST`` moves keeps the acknowledged
generation; a stale ``LATEST`` falls back to the newest durable step.
``CrashingCheckpointManager`` crashes at the port manager's phase hooks
and writes through its own ``_write``, so a generation that survived a
crash loads into the JAX package too (ids equal except where float64
distances tie within 1e-5, distances within 1e-5)."""
import os

import numpy as np
import pytest
import torch

from repro.runtime import KNNIndex as JaxIndex
from repro_torch.core import HybridConfig
from repro_torch.runtime import (
    CheckpointCrash, CrashingCheckpointManager, KNNIndex, ScriptedFaults,
)

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are tiny, and
    under the suite's parallel workers torch's default thread pool only
    contends with them (a 300-row trace ran over 20 times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small_index(seed=50):
    r = np.random.default_rng(seed)
    db = np.concatenate([
        (0.05 * r.normal(size=(300, 6))).astype(np.float32),
        r.uniform(-3.0, 3.0, (100, 6)).astype(np.float32)]).astype(np.float32)
    return KNNIndex.build(db, HybridConfig(k=3, m=4, n_batches=1), device="cpu"), \
        r.normal(size=(24, 6)).astype(np.float32)


def _load(path):
    return KNNIndex.load(str(path), device="cpu")


@pytest.mark.parametrize("phase", ["pre-arrays", "pre-manifest"])
def test_crash_before_durability_restores_previous_gen(tmp_path, phase):
    """A crash before the atomic rename leaves no durable trace of the
    new generation: load() restores the previous one; a retried save
    succeeds and becomes the new latest."""
    idx, q = _small_index()
    want0 = idx.query(q)
    f = ScriptedFaults()
    mgr = CrashingCheckpointManager(str(tmp_path), f)
    idx.save(str(tmp_path), manager=mgr)          # gen 0: durable
    idx.delete(np.arange(20))
    want1 = idx.query(q)
    f.crash_checkpoint(phase)                     # arm: next write crashes
    with pytest.raises(CheckpointCrash):
        idx.save(str(tmp_path), manager=mgr)      # gen 1: crashes
    assert f.count("ckpt-crash") == 1
    assert not os.path.exists(os.path.join(tmp_path, "step-000000001"))
    np.testing.assert_array_equal(_load(tmp_path).query(q).ids, want0.ids)
    # crash-once: the retry lands, and becomes the restore target
    assert idx.save(str(tmp_path), manager=mgr) == 1
    got = _load(tmp_path).query(q)
    np.testing.assert_array_equal(got.ids, want1.ids)
    np.testing.assert_array_equal(got.dists, want1.dists)


def test_crash_before_latest_pointer_keeps_acknowledged_gen(tmp_path):
    """A crash after the rename but before LATEST moves: the new step
    is on disk but was never acknowledged (save() raised), so load()
    honors the pointer and restores the last acknowledged generation."""
    idx, q = _small_index(seed=51)
    want0 = idx.query(q)
    f = ScriptedFaults()
    mgr = CrashingCheckpointManager(str(tmp_path), f)
    idx.save(str(tmp_path), manager=mgr)
    idx.delete(np.arange(20))
    f.crash_checkpoint("pre-latest")
    with pytest.raises(CheckpointCrash):
        idx.save(str(tmp_path), manager=mgr)
    # step-1 dir exists and is complete, but LATEST still names step 0
    assert os.path.isdir(os.path.join(tmp_path, "step-000000001"))
    with open(os.path.join(tmp_path, "LATEST")) as fh:
        assert fh.read().strip() == "step-000000000"
    np.testing.assert_array_equal(_load(tmp_path).query(q).ids, want0.ids)


def test_stale_latest_falls_back_to_durable_gen(tmp_path):
    """LATEST pointing at a step that does not exist: load() warns and
    restores the newest durable generation instead of dying."""
    idx, q = _small_index(seed=52)
    want = idx.query(q)
    idx.save(str(tmp_path))
    with open(os.path.join(tmp_path, "LATEST"), "w") as fh:
        fh.write("step-000000099")
    with pytest.warns(RuntimeWarning, match="falling back"):
        loaded = _load(tmp_path)
    np.testing.assert_array_equal(loaded.query(q).ids, want.ids)


def test_crashed_then_retried_generation_loads_into_jax(tmp_path):
    """A dirty generation written by the retry after a ``pre-manifest``
    crash (the crash left a ``.tmp`` directory behind) loads into the
    JAX package, which answers as the port's index does."""
    idx, q = _small_index(seed=53)
    f = ScriptedFaults()
    mgr = CrashingCheckpointManager(str(tmp_path), f)
    idx.save(str(tmp_path), manager=mgr)
    idx.delete(np.arange(0, 40, 3))
    f.crash_checkpoint("pre-manifest")
    with pytest.raises(CheckpointCrash):
        idx.save(str(tmp_path), manager=mgr)
    assert os.path.isdir(os.path.join(tmp_path, "step-000000001.tmp"))
    assert idx.save(str(tmp_path), manager=mgr) == 1
    want = idx.query(q)
    jax_idx = JaxIndex.load(str(tmp_path))
    assert not jax_idx.is_clean and jax_idx.n_tombstones == idx.n_tombstones
    got = jax_idx.query(q)
    np.testing.assert_allclose(np.asarray(got.dists), want.dists, rtol=TOL, atol=TOL)
    r, c = np.nonzero(np.asarray(got.ids) != want.ids)
    pts = np.asarray(idx._live[0].points_ref, np.float64)
    q64 = q.astype(np.float64)
    np.testing.assert_allclose(
        np.linalg.norm(q64[r] - pts[np.asarray(got.ids)[r, c]], axis=-1),
        np.linalg.norm(q64[r] - pts[want.ids[r, c]], axis=-1), rtol=TOL, atol=TOL)
