"""The port's optimizer substrate (``repro_torch.optim``) held to the JAX
package's on the same numpy trees.

Tolerances.  AdamW in float32: 1e-5 relative (atol 1e-6) on the moments
and the parameters after each step, the sums taken in another order; the
schedule to 1e-6 relative (one float32 rounding of a few operations).
bfloat16 moments: 2^-7 relative and absolute (one bf16 ulp), as the
moments are rounded to bf16 on store.  ``quantize`` / ``ef_quantize``: bit
for bit.  ``compressed_grad_mean`` over 8 slots: within one quantum of
the largest slot's gradient of the float64 mean, the bound of
``tests/test_distributed.py:127-148``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T
from repro_torch.utils import tree_leaves, tree_map

RTOL, ATOL = 1e-5, 1e-6
TOL_BF16 = 2.0 ** -7
N_STEPS = 4


def _tree(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {"embed": {"tok": (scale * r.normal(size=(11, 6))).astype(np.float32)},
            "layers": [{"w": (scale * r.normal(size=(6, 5))).astype(np.float32),
                        "b": (scale * r.normal(size=(5,))).astype(np.float32)},
                       {"w": (scale * r.normal(size=(5, 3, 2))).astype(np.float32)}],
            "final_norm": {}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _jx(tree):
    return tree_map(jnp.asarray, tree)


def _tt(tree):
    return tree_map(lambda a: torch.tensor(a), tree)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(moments, clip):
    """N_STEPS updates from the same parameters and per-step gradients:
    large gradients, so the clip at 1.0 acts; the learning rate through
    warmup into the decay."""
    cfg_kw = dict(warmup_steps=2, total_steps=6, grad_clip=clip, moment_dtype=moments)
    jcfg, tcfg = J.OptConfig(**cfg_kw), T.OptConfig(**cfg_kw)
    params = _tree(0)
    jp, tp = _jx(params), _tt(params)
    jst, tst = J.init_opt_state(jp, jcfg), T.init_opt_state(tp, tcfg)
    assert all(m.dtype == T.adamw.torch_dtype(moments) for m in tree_leaves(tst["mu"]))
    assert tst["count"].dtype == torch.int32 and int(tst["count"]) == 0
    tol = (RTOL, ATOL) if moments == "float32" else (TOL_BF16, TOL_BF16)
    for step in range(N_STEPS):
        grads = _tree(100 + step, scale=3.0)
        jp, jst, jm = J.adamw_update(_jx(grads), jst, jp, jcfg)
        out_p, tst, tm = T.adamw_update(_tt(grads), tst, tp, tcfg)
        assert out_p is tp                                    # written in place
        assert int(tst["count"]) == int(jst["count"]) == step + 1
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=RTOL)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
        for name in ("mu", "nu"):
            for got, want in zip(tree_leaves(tst[name]), jax.tree.leaves(jst[name])):
                assert str(got.dtype).endswith(moments)
                np.testing.assert_allclose(_np(got), _np(want), rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 2500, 5050, 9999, 10000, 12000])
def test_warmup_cosine_matches_jax(step):
    """Warmup, the switch, mid-decay, the end and past it."""
    jcfg, tcfg = J.OptConfig(), T.OptConfig()
    want = float(J.warmup_cosine(jcfg, jnp.int32(step)))
    got = T.warmup_cosine(tcfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_clip_and_global_norm_match_jax():
    g = _tree(5, scale=2.0)
    jc, jn = J.clip_by_global_norm(_jx(g), 0.5)
    tc, tn = T.clip_by_global_norm(_tt(g), 0.5)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=RTOL)
    np.testing.assert_allclose(T.global_norm(tc).item(), 0.5, rtol=RTOL)
    for got, want in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)
    same, n = T.clip_by_global_norm(_tt(g), 1e6)          # below the cap: unscaled
    for got, want in zip(tree_leaves(same), tree_leaves(g)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bit_identical(seed):
    r = np.random.default_rng(seed)
    g = (r.standard_t(3, size=(7, 33)) * 10.0 ** (seed - 1)).astype(np.float32)
    g[0, :5] = [0.0, 0.5, -0.5, 1.5, -2.5]                  # exact halves of a quantum
    res = (0.01 * r.normal(size=g.shape)).astype(np.float32)
    jq, js = J.quantize(jnp.asarray(g))
    tq, ts = T.quantize(torch.tensor(g))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(T.dequantize(tq, ts).numpy(),
                                  np.asarray(J.dequantize(jq, js)))
    jq, js, jr = J.ef_quantize(jnp.asarray(g), jnp.asarray(res))
    tq, ts, tr = T.ef_quantize(torch.tensor(g), torch.tensor(res))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_zero_gradient_quantizes_to_zero():
    q, s = T.quantize(torch.zeros(4, 3))
    assert s.item() == np.float32(1e-12) and not q.any()


def test_compressed_grad_mean_over_eight_slots():
    """8 slots' gradient trees; the mean within one quantum of the largest
    slot's gradient of the numpy mean, the residuals each slot's
    quantization error, and the error fed back on a second call."""
    r = np.random.default_rng(2)
    g_all = r.normal(size=(8, 64)).astype(np.float32)
    b_all = r.normal(size=(8, 3, 5)).astype(np.float32)
    grads = [{"w": torch.tensor(g_all[p]), "blk": [{"b": torch.tensor(b_all[p])}]}
             for p in range(8)]
    res0 = [T.init_residuals(g) for g in grads]
    mean, res = T.compressed_grad_mean(grads, res0)
    for got, full in ((mean["w"], g_all), (mean["blk"][0]["b"], b_all)):
        scale = np.abs(full).max() / 127.0
        assert np.abs(got.numpy() - full.mean(axis=0)).max() <= scale + 1e-6
    for p in range(8):
        q, s = T.quantize(grads[p]["w"])
        np.testing.assert_array_equal(res[p]["w"].numpy(),
                                      (grads[p]["w"] - T.dequantize(q, s)).numpy())
    # error feedback: the residuals ride on the next call's gradients
    mean2, _ = T.compressed_grad_mean(grads, res)
    per_slot = [T.dequantize(*T.quantize(grads[p]["w"] + res[p]["w"])) for p in range(8)]
    np.testing.assert_allclose(mean2["w"].numpy(), torch.stack(per_slot).mean(0).numpy(),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        T.compressed_grad_mean(grads, res0[:3])


def test_compression_ratio_and_exports():
    assert T.compression_ratio() == J.compression_ratio() == 4.0
    assert T.compression_ratio(torch.bfloat16) == J.compression_ratio(jnp.bfloat16) == 2.0
    assert sorted(T.__all__) == sorted(J.__all__)
