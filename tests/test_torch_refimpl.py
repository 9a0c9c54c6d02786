"""REFIMPL (the paper's CPU reference, §VI-C) and ``grid.neighborhood_counts``
of the PyTorch port against the JAX package and the float64 oracle on the
same seeded numpy inputs.

Tolerance: distances within 1e-5 of the oracle's (fp32 engines against
float64) and of the JAX package's; ids equal except where the float64
distances of the two ids tie within 1e-5.  The port draws its ε sample
from its own generator, so its pyramid may differ from the JAX one; the
results are exact either way.  Neighborhood counts are integers and must
be equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_mixture
from oracle import oracle_knn
from test_torch_core import _state
from repro.core import grid as jax_grid
from repro.core import refimpl_knn as jax_refimpl_knn
from repro_torch.core import HybridConfig, refimpl_knn
from repro_torch.core import grid as grid_lib

TOL = 1e-5


@pytest.mark.parametrize("n_ranks", [1, 3])
def test_refimpl_matches_jax_and_oracle(n_ranks):
    pts = make_mixture(200, 100, dim=8, seed=7)
    k = 4
    jres, jtimes = jax_refimpl_knn(pts, k=k, n_ranks=n_ranks)
    tres, ttimes = refimpl_knn(pts, k=k, n_ranks=n_ranks, device="cpu")
    od, oi = oracle_knn(pts, k=k, exclude_self=True)
    assert tres.dists.shape == tres.ids.shape == (len(pts), k)
    np.testing.assert_allclose(tres.dists, od, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tres.dists, jres.dists, rtol=TOL, atol=TOL)
    got = np.linalg.norm(pts.astype(np.float64)[:, None, :] - pts[tres.ids], axis=-1)
    np.testing.assert_allclose(got, od, rtol=TOL, atol=TOL)
    differ = tres.ids != jres.ids
    jgot = np.linalg.norm(pts.astype(np.float64)[:, None, :] - pts[jres.ids], axis=-1)
    np.testing.assert_allclose(got[differ], jgot[differ], rtol=TOL, atol=TOL)
    assert not (tres.ids == np.arange(len(pts))[:, None]).any()
    assert len(ttimes) == len(jtimes) == n_ranks and all(t >= 0 for t in ttimes)
    assert tres.stats.t_sparse == max(ttimes)
    assert (tres.source == 1).all() and tres.source.dtype == jres.source.dtype


def test_refimpl_with_config_and_empty_ranks():
    """A caller's config (ρ, m, budgets) is honoured; more ranks than
    points leaves the extra ranks empty at 0 s, as in the reference."""
    pts = make_mixture(40, 20, dim=5, seed=2)
    cfg = HybridConfig(k=3, m=3, sparse_budget=64, n_levels=4)
    tres, times = refimpl_knn(pts, 3, cfg, n_ranks=70, device="cpu")
    jres, jtimes = jax_refimpl_knn(pts, 3, None, n_ranks=70)
    od, _ = oracle_knn(pts, k=3, exclude_self=True)
    np.testing.assert_allclose(tres.dists, od, rtol=TOL, atol=TOL)
    assert times[60:] == [0.0] * 10 and jtimes[60:] == [0.0] * 10


@pytest.mark.parametrize("m,eps", [(4, 0.25), (2, 0.1), (6, 0.6)])
def test_neighborhood_counts_equal_jax(m, eps):
    """Self coords and a foreign cloud's coords on the same grid."""
    _, jg, _, tg = _state(m=m, eps=eps)
    q = np.random.default_rng(m).uniform(-3.5, 3.5, (97, 6)).astype(np.float32)
    jq = jax_grid.compute_cell_coords(jg, jnp.asarray(q[:, :m]))
    tq = grid_lib.compute_cell_coords(tg, torch.as_tensor(q[:, :m]))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    for jc, tc in ((jg.point_coords, tg.point_coords), (jq, tq)):
        want = np.asarray(jax_grid.neighborhood_counts(jg, jc))
        got = grid_lib.neighborhood_counts(tg, tc).numpy()
        np.testing.assert_array_equal(got, want)
    assert got.sum() > 0
