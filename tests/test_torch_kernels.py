"""Kernel ops of the PyTorch port against the JAX package's kernels.

On the CPU every port op runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode.  Same numpy inputs through both; the
parity contract: integer outputs equal except ε²/bin-edge flips (checked
in float64), ids equal except where distances tie, distances within
rtol 1e-5 / atol 1e-6 (fp32 with another summation order)."""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bin_hist import ops as jax_hist_ops
from repro.kernels.knn_stream import ops as jax_stream_ops
from repro.kernels.knn_topk import ops as jax_topk_ops
from repro_torch.kernels.bin_hist import ops as hist_ops
from repro_torch.kernels.knn_stream import ops as stream_ops
from repro_torch.kernels.knn_topk import ops as topk_ops
from repro_torch.kernels.knn_topk import ref as topk_ref

RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_ints_mod_boundary(got, want, d2_rows, eps2, tol=1e-4):
    """Per-row counts equal except rows holding a pair within ``tol`` of
    the ε² cutoff (the two distance formulations round differently)."""
    got, want = np.asarray(got), np.asarray(want)
    for r in np.nonzero(got != want)[0]:
        assert np.abs(d2_rows(r) - eps2).min() < tol, f"row {r}: {got[r]} != {want[r]}"


def _assert_ids_mod_ties(got_i, want_i, d2_of):
    """ids equal, except where the float64 distances of the two ids tie."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    for r, c in zip(*np.nonzero(got_i != want_i)):
        np.testing.assert_allclose(d2_of(r, got_i[r, c]), d2_of(r, want_i[r, c]),
                                   rtol=RTOL, atol=1e-7)


def test_port_imports_no_jax_and_nothing_of_repro():
    """The port is standalone: no ``jax`` and no ``repro`` import anywhere
    in ``src/repro_torch``."""
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    bad = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(root)}: {n}")
    assert not bad, bad
    assert len(list(root.rglob("*.py"))) >= 20


def test_prefetch_op_matches_jax_kernel():
    """Block-table streaming top-k: the port's plain version on an
    arbitrary block table (repeats included, 30 % masked rows) against the
    JAX scalar-prefetch kernel in interpret mode."""
    r = np.random.default_rng(11)
    block_q, block_c, n_tiles, nblk, n_cb, k = 64, 128, 3, 4, 6, 5
    corpus = r.normal(size=(n_cb * block_c, 6)).astype(np.float32)
    queries = r.normal(size=(n_tiles * block_q, 6)).astype(np.float32)
    blk = r.integers(0, n_cb, size=(n_tiles, nblk)).astype(np.int32)
    rows = blk[:, :, None] * block_c + np.arange(block_c)
    cand = rows.reshape(n_tiles, -1).astype(np.int32)
    cand[r.random(cand.shape) < 0.3] = -1
    qid = np.arange(n_tiles * block_q, dtype=np.int32)
    eps2 = 4.0
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk_prefetch(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(blk),
        jnp.asarray(qid), jnp.asarray(cand), jnp.float32(eps2),
        k=k, block_q=block_q, block_c=block_c, mode="interpret")
    kd1, ki1, f1 = stream_ops.knn_stream_topk_prefetch(
        _t(queries), _t(corpus), _t(blk), _t(qid), _t(cand),
        torch.tensor(eps2), k=k, block_q=block_q, block_c=block_c)
    c64, q64 = corpus.astype(np.float64), queries.astype(np.float64)

    def d2_rows(row):
        ids = cand[row // block_q]
        return ((c64[ids[ids >= 0]] - q64[row]) ** 2).sum(-1)

    _assert_ints_mod_boundary(f1, f0, d2_rows, eps2)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    _assert_ids_mod_ties(ki1.numpy(), ki0,
                         lambda row, c: ((c64[c] - q64[row]) ** 2).sum())
    assert ki1.dtype == torch.int32 and f1.dtype == torch.int32


@pytest.mark.parametrize("q_n,c_n,k", [(200, 700, 4), (50, 33, 3)])
def test_stream_op_matches_jax_kernel(q_n, c_n, k):
    """Contiguous streaming top-k (the identity-table case) against the
    JAX padded kernel in interpret mode, with an invalid candidate row."""
    r = np.random.default_rng(q_n + c_n + k)
    q = r.normal(size=(q_n, 6)).astype(np.float32)
    c = r.normal(size=(c_n, 6)).astype(np.float32)
    qid = np.arange(q_n, dtype=np.int32)
    cid = np.arange(c_n, dtype=np.int32)
    cid[3] = -1
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid), jnp.asarray(cid),
        jnp.float32(2.0), k=k, block_q=64, block_c=128, mode="interpret")
    kd1, ki1, f1 = stream_ops.knn_stream_topk(
        _t(q), _t(c), _t(qid), _t(cid), torch.tensor(2.0), k=k)
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    _assert_ints_mod_boundary(
        f1, f0, lambda row: ((c64[cid >= 0] - q64[row]) ** 2).sum(-1), 2.0)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    _assert_ids_mod_ties(ki1.numpy(), ki0,
                         lambda row, j: ((c64[j] - q64[row]) ** 2).sum())


def test_stream_op_oversized_k_uses_plain_version_on_cpu():
    """k above MAX_UNROLLED_K: the JAX ops reroute to their oracle; the
    port's CPU path is the plain version either way and counts no
    reroute (the reroute counter is for CUDA tensors only)."""
    r = np.random.default_rng(3)
    q = r.normal(size=(20, 4)).astype(np.float32)
    c = r.normal(size=(64, 4)).astype(np.float32)
    qid, cid = np.arange(20, dtype=np.int32), np.arange(64, dtype=np.int32)
    before = stream_ops.oversized_k_reroutes
    kd0, ki0, f0 = jax_stream_ops.knn_stream_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid), jnp.asarray(cid),
        jnp.float32(1e9), k=40, mode="interpret")
    kd1, ki1, f1 = stream_ops.knn_stream_topk(
        _t(q), _t(c), _t(qid), _t(cid), torch.tensor(1e9), k=40)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(f1.numpy(), np.asarray(f0))
    assert stream_ops.oversized_k_reroutes == before


@pytest.mark.parametrize("q_n,c_n,k", [(130, 600, 5), (64, 40, 8)])
def test_knn_topk_op_matches_jax_kernel(q_n, c_n, k):
    """Exact top-k with self pairs and invalid rows excluded, against the
    JAX tile kernel + partial merge in interpret mode."""
    r = np.random.default_rng(q_n * 7 + c_n)
    q = r.normal(size=(q_n, 5)).astype(np.float32)
    c = np.concatenate([q[:20], r.normal(size=(c_n - 20, 5))]).astype(np.float32)
    qid = np.arange(q_n, dtype=np.int32)
    cid = np.arange(c_n, dtype=np.int32)
    cid[5] = -1
    kd0, ki0 = jax_topk_ops.knn_topk(
        jnp.asarray(q), jnp.asarray(c), jnp.asarray(qid), jnp.asarray(cid),
        k=k, mode="interpret")
    kd1, ki1 = topk_ops.knn_topk(_t(q), _t(c), _t(qid), _t(cid), k=k)
    np.testing.assert_allclose(kd1.numpy(), np.asarray(kd0), rtol=RTOL, atol=ATOL)
    q64, c64 = q.astype(np.float64), c.astype(np.float64)
    _assert_ids_mod_ties(ki1.numpy(), ki0,
                         lambda row, j: ((c64[j] - q64[row]) ** 2).sum())
    assert not (ki1.numpy()[:20] == np.arange(20)[:, None]).any()


def test_merge_helpers_match_jax():
    """``merge_running_topk`` and ``merge_topk_ref`` keep JAX's tie order
    (``lax.top_k``: lowest index first) bit for bit."""
    r = np.random.default_rng(5)
    d = np.round(r.uniform(0, 3, size=(3, 40, 6)), 1).astype(np.float32)  # many ties
    d = np.sort(d, axis=-1)
    i = r.integers(0, 1000, size=d.shape).astype(np.int32)
    from repro.kernels.knn_topk import ref as jax_topk_ref
    jd, ji = jax_topk_ref.merge_topk_ref(jnp.asarray(d), jnp.asarray(i), k=6)
    td, ti = topk_ref.merge_topk_ref(_t(d), _t(i), k=6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jd, ji = jax_topk_ops.merge_running_topk(
        jnp.asarray(d[0]), jnp.asarray(i[0]), jnp.asarray(d[1]), jnp.asarray(i[1]), k=6)
    td, ti = topk_ops.merge_running_topk(_t(d[0]), _t(i[0]), _t(d[1]), _t(i[1]), k=6)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("self_excl", [True, False])
def test_bin_hist_op_matches_jax_kernel(self_excl):
    """Sampled distance histogram against the JAX kernel in interpret
    mode: counts equal except pairs within a few ulp of a bin edge."""
    r = np.random.default_rng(2)
    pts = r.normal(size=(700, 6)).astype(np.float32)
    qidx = r.integers(0, 700, size=40).astype(np.int32)
    bw, n_bins = np.float32(0.05), 64
    c0 = jax_hist_ops.distance_bin_histogram(
        jnp.asarray(pts[qidx]), jnp.asarray(pts), jnp.float32(bw), n_bins,
        self_indices=jnp.asarray(qidx) if self_excl else None, mode="interpret")
    c1 = hist_ops.distance_bin_histogram(
        _t(pts[qidx]), _t(pts), torch.tensor(bw), n_bins,
        self_indices=_t(qidx) if self_excl else None)
    assert c1.dtype == torch.float32
    diff = np.abs(c1.numpy() - np.asarray(c0))
    p64 = pts.astype(np.float64)
    ratio = np.sqrt(((p64[qidx][:, None] - p64[None]) ** 2).sum(-1)) / float(bw)
    near_edge = int((np.abs(ratio - np.round(ratio)) < 1e-4).sum())
    assert diff.sum() <= 2 * near_edge, (diff.sum(), near_edge)
    assert c1.sum() > 0


def test_kernel_wrappers_refuse_cpu_tensors_before_building():
    """The CUDA wrappers validate before they build or launch: a CPU tensor
    is refused (ops, not the wrappers, route CPU tensors to the plain
    versions), and nothing is compiled on a machine without nvcc."""
    from repro_torch.kernels.bin_hist import kernel as hist_kernel
    from repro_torch.kernels.knn_stream import kernel as stream_kernel
    from repro_torch.kernels.knn_topk import kernel as topk_kernel
    q = torch.zeros((128, 6))
    ids = torch.zeros((128,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        stream_kernel.knn_stream_topk_prefetch(
            q, q, torch.zeros((1, 1), dtype=torch.int32), ids,
            torch.zeros((1, 128), dtype=torch.int32), 1.0, k=4)
    with pytest.raises(ValueError, match="CUDA"):
        topk_kernel.knn_tile_topk(q, q, ids, ids, k=4)
    with pytest.raises(ValueError, match="CUDA"):
        hist_kernel.distance_bin_histogram(q, q, ids, 0.1, n_bins=16)
    assert not stream_kernel.launches and not topk_kernel.launches


@pytest.mark.parametrize("n_bins", [7_000, 1 << 20])
def test_bin_hist_refuses_a_plan_past_shared_memory(n_bins):
    """An n_bins whose per-warp sub-histograms exceed one H100 block's
    shared memory is refused with the plan's size, before anything is
    built."""
    from repro_torch.kernels.bin_hist import kernel as hist_kernel
    q = torch.zeros((128, 6))
    ids = torch.zeros((128,), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        hist_kernel.distance_bin_histogram(q, q, ids, 0.1, n_bins=n_bins)
    assert hist_kernel.smem_bytes(6_000) <= 232448 < hist_kernel.smem_bytes(7_000)
    assert hist_kernel.launches == 0


@pytest.mark.parametrize("n_q,n_c", [(4096, 4096), (5, 5_000_000), (5_000_000, 5_000_000),
                                     (300, 100)])
def test_knn_topk_split_plan_covers_every_candidate(n_q, n_c):
    from repro_torch.kernels.knn_topk import kernel as topk_kernel
    n_splits, per_split = topk_kernel.split_plan(n_q, n_c, 128, 256, 132)
    assert per_split % 256 == 0 and n_splits >= 1
    assert (n_splits - 1) * per_split < n_c <= n_splits * per_split
    # at least one block per SM whenever the candidates allow it
    assert n_splits * -(-n_q // 128) >= min(132, -(-n_c // 256) * -(-n_q // 128))
