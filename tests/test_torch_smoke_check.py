"""``chip_smoke.check_exact``, the float64 exactness check of every card
path, run here on CPU tensors.

Rows wider than 32 dims (``fp32_bound=True``) are held to their own fp32
expansion-form bound 2·(D+4)·u·(|q|+|c|)², the bound the JAX kernels'
expansion |q|² + |c|² − 2q·c is held to in ``test_torch_wide.py``; every
other path keeps the fixed 1e-5 · max(1, largest d²) set tolerance.  A
returned set whose k-th neighbour is swapped for a near-tie passes at 518
dims when the tie gap is within that bound, fails when it is beyond it,
and the same within-bound swap still fails at 18 dims."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

K = 4


def _planted(dim, gap, seed=0):
    """One query (|q| = 1) and candidates at squared distances 1.0, 1.1,
    1.2, 1.3 (the k-th), 1.3 + ``gap`` (the (k+1)-th) and four far ones,
    each offset orthogonal to the query.  Returns (points, query, the
    swapped ids, their distances, the expansion bound of the row)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=dim)
    q /= np.linalg.norm(q)
    d2 = np.array([1.0, 1.1, 1.2, 1.3, 1.3 + gap, 3.0, 3.5, 4.0, 4.5])
    pts = []
    for r2 in d2:
        u = rng.normal(size=dim)
        u -= (u @ q) * q
        pts.append(q + np.sqrt(r2) * u / np.linalg.norm(u))
    pts = torch.as_tensor(np.array(pts, np.float32))
    qt = torch.as_tensor(q.astype(np.float32))[None]
    ids = np.array([[0, 1, 2, 4]])
    dist = torch.linalg.norm(pts[ids[0]].double() - qt.double(), dim=1).numpy()[None]
    bound = chip_smoke.expansion_bound(qt.double().norm(dim=1),
                                       pts[:5].double().norm(dim=1).max(), dim).item()
    return pts, qt, ids, dist, bound


def _check(pts, qt, ids, dist, fp32_bound):
    chip_smoke.check_exact(pts, qt, None, dist, ids, "planted swap", fp32_bound=fp32_bound)


@pytest.mark.parametrize("frac", [0.25, 0.9])
def test_wide_rows_pass_a_swap_within_their_bound(frac):
    _, _, _, _, bound = _planted(518, 0.0)
    pts, qt, ids, dist, _ = _planted(518, frac * bound)
    assert frac * bound > 1e-5 * 1.3           # past the fixed tolerance
    _check(pts, qt, ids, dist, fp32_bound=True)
    with pytest.raises(AssertionError, match="not the exact k best"):
        _check(pts, qt, ids, dist, fp32_bound=False)


@pytest.mark.parametrize("mult", [1.5, 10.0])
def test_wide_rows_fail_a_swap_beyond_their_bound(mult):
    _, _, _, _, bound = _planted(518, 0.0)
    pts, qt, ids, dist, _ = _planted(518, mult * bound)
    with pytest.raises(AssertionError, match="not the exact k best"):
        _check(pts, qt, ids, dist, fp32_bound=True)


def test_narrow_rows_keep_the_fixed_tolerance():
    """The 518-dim within-bound gap fails at 18 dims, where no path sets
    ``fp32_bound``; the exact set passes."""
    _, _, _, _, bound = _planted(518, 0.0)
    pts, qt, ids, dist, _ = _planted(18, 0.25 * bound)
    with pytest.raises(AssertionError, match="not the exact k best"):
        _check(pts, qt, ids, dist, fp32_bound=False)
    exact = np.array([[0, 1, 2, 3]])
    d = torch.linalg.norm(pts[exact[0]].double() - qt.double(), dim=1).numpy()[None]
    _check(pts, qt, exact, d, fp32_bound=False)


def test_wide_rows_hold_reported_distances_to_the_carried_bound():
    """The reported distance may err by the bound carried to d,
    min(e / d, √e); past that the check fails."""
    pts, qt, ids, dist, bound = _planted(518, 0.0)
    exact = np.array([[0, 1, 2, 3]])
    d = torch.linalg.norm(pts[exact[0]].double() - qt.double(), dim=1).numpy()[None]
    carried = min(bound / d[0, 3], np.sqrt(bound))
    _check(pts, qt, exact, d + np.array([[0, 0, 0, 0.5 * carried]]), fp32_bound=True)
    with pytest.raises(AssertionError, match="reported distances"):
        _check(pts, qt, exact, d + np.array([[0, 0, 0, 3 * carried]]), fp32_bound=True)


# --------------------------------------------------------------------------
# ``chip_smoke.hold_hist``: the histogram check's measured window
# --------------------------------------------------------------------------

HIST_BINS = 64


def _hist_sample(dim=256, n_pts=2048, n_q=32, seed=1):
    """A sample as the ε selection takes it: query rows drawn from the
    points, the bins spanning [0, 1.1 × the median distance).  Returns
    (queries, points, qidx, bin width, the plain version's counts, the
    counts in the kernels' fp32 arithmetic)."""
    from repro_torch.kernels.bin_hist import ref as hist_ref
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.normal(size=(n_pts, dim)).astype(np.float32))
    qidx = torch.as_tensor(rng.choice(n_pts, n_q, replace=False))
    q = pts[qidx]
    d = torch.cdist(q.double(), pts.double())
    bw = torch.tensor(float(d.median()) * 1.1 / HIST_BINS, dtype=torch.float32)
    pid = torch.arange(n_pts, dtype=torch.int32)
    rc = hist_ref.distance_bin_histogram_ref(q, pts, qidx.to(torch.int32), pid, bw,
                                             n_bins=HIST_BINS)
    d2k = chip_smoke.expansion_sq_fp32(q, pts.T.contiguous())
    b = torch.floor(torch.sqrt(torch.clamp(d2k, min=0.0)) / bw)
    keep = (pid[None, :] != qidx[:, None]) & (b < HIST_BINS)
    kc = torch.bincount(b[keep].long(), minlength=HIST_BINS).to(torch.float32)
    return q, pts, qidx, bw, rc, kc


def test_hist_check_passes_the_kernels_arithmetic():
    """The kernels' fp32 expansion binned against the plain difference
    form: within the measured window, which is narrower than the bound
    window at 256 dims; the check's own self-tests (one bin up, 1% moved)
    fail inside it."""
    q, pts, qidx, bw, rc, kc = _hist_sample()
    assert kc.sum() > 0.3 * q.shape[0] * pts.shape[0]
    chip_smoke.hold_hist("fp32 expansion vs plain", kc, rc, q, pts, qidx, bw, HIST_BINS)
    near_b, near_m, st = chip_smoke.hist_windows(q, pts, qidx, bw, HIST_BINS)
    assert 0 < st["e2"] < st["e2_bound"] and 0 < st["rel_plain"] < 1e-5
    assert near_m.sum() < near_b.sum() / 4 and (near_m <= near_b).all()


@pytest.mark.parametrize("wrong", ["shifted", "moved_1pct"])
def test_hist_check_fails_a_wrong_histogram(wrong):
    """A histogram one bin up, or with 1% of its pairs moved from its
    fullest bin to the next, fails the check."""
    q, pts, qidx, bw, rc, kc = _hist_sample()
    if wrong == "shifted":
        bad = torch.cat([kc.new_zeros(1), kc[:-1]])
    else:
        bad = kc.clone()
        b = int(kc.argmax())
        m = float(np.ceil(0.01 * kc.sum().item()))
        assert m <= kc[b]
        bad[b] -= m
        bad[b + 1] += m
    with pytest.raises(AssertionError, match="differ beyond their edge pairs"):
        chip_smoke.hold_hist("wrong histogram", bad, rc, q, pts, qidx, bw, HIST_BINS)
