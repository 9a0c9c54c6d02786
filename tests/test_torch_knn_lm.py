"""The port's kNN-LM head (``repro_torch.models.knn_lm``) and serving
driver (``repro_torch.launch.serve``) held to the JAX package.

Every assertion of ``tests/test_knn_lm.py`` runs on the port, on weights
carried across from the JAX ``init_params`` (``params_from_jax``), in
float32 at ``olmo_1b``'s ``smoke_config()``.  Then the port is held to the
JAX functions on the same inputs: ``build_datastore`` (the REORDER
permutation equal, keys within 1e-5), ``lookup``, ``knn_probs``,
``interpolate_retrieval``, ``decode_step_retrieval``, and greedy
``generate`` token for token (bare, with a ``Datastore``, with an
unsharded ``IndexRetriever``).  ``sharded_lookup`` runs on a 4-slot CPU
mesh against the float64 oracle as ``tests/test_distributed.py`` asserts
it, and ``examples/knn_lm_serve.py``'s assertion — retrieval beats the
bare LM with nothing shed — on a 4-slot mesh behind ``KNNServer``.

Tolerances: 1e-5 (rtol and atol) on keys and squared distances; 1e-4 on
log-probabilities and retrieval scores; ids and values are compared where
the float64 distances do not tie within 1e-5.  The JAX references are
computed once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RetrievalConfig as JRetrieval
from repro.configs.base import get_smoke_config as jsmoke
from repro.core.hybrid import HybridConfig as JHybrid
from repro.launch import serve as jserve
from repro.models import IndexRetriever as JRetriever
from repro.models import build_datastore as jbuild
from repro.models import decode_step_retrieval as jdecode_ret
from repro.models import init_params as jinit
from repro.models import interpolate_retrieval as jinterp
from repro.models import knn_probs as jprobs
from repro.models import lookup as jlookup
from repro.models import prefill as jprefill
from repro_torch.configs import RetrievalConfig, get_smoke_config
from repro_torch.core import HybridConfig
from repro_torch.launch import make_serving_mesh
from repro_torch.launch.serve import generate
from repro_torch.models import (
    IndexRetriever, build_datastore, cache_from_jax, decode_step_retrieval, init_cache,
    interpolate_retrieval, knn_probs, lookup, params_from_jax, prefill, sharded_lookup,
)
from repro_torch.runtime import ServerConfig

TOL = 1e-5
TOL_LOGP = 1e-4
TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(lam=0.5, k=4):
    j = dataclasses.replace(jsmoke("olmo_1b"),
                            retrieval=JRetrieval(enabled=True, k=k, lam=lam))
    t = dataclasses.replace(get_smoke_config("olmo_1b"),
                            retrieval=RetrievalConfig(enabled=True, k=k, lam=lam))
    return j, t


def _lam(cfg, lam):
    return dataclasses.replace(cfg, retrieval=dataclasses.replace(cfg.retrieval, lam=lam))


@pytest.fixture(scope="module")
def setup():
    """The reference test's ``_setup``: smoke olmo, k = 4, a (4, 48) corpus
    — once on each side, the port's model holding the JAX weights."""
    jcfg, tcfg = _cfgs()
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    corpus = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 48)).astype(np.int32)
    jds = jbuild(params, jcfg, [jnp.asarray(corpus)])
    ds = build_datastore(model, tcfg, [corpus])
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, corpus=corpus, jds=jds,
                ds=ds)


def _assert_topk(d_got, v_got, d_want, v_want, d64, tol=TOL):
    """Sorted distances within ``tol``; values equal wherever the rank's
    float64 distance does not tie with a neighbour's."""
    np.testing.assert_allclose(np.asarray(d_got), np.asarray(d_want), rtol=tol, atol=tol)
    d64 = np.sort(d64, axis=1)
    gap = np.minimum(np.abs(np.diff(d64, axis=1, prepend=-np.inf)),
                     np.abs(np.diff(d64, axis=1, append=np.inf)))[:, :d_got.shape[1]]
    clear = gap > TIE
    np.testing.assert_array_equal(np.asarray(v_got)[clear], np.asarray(v_want)[clear])


# --------------------------------------------------------------------------
# tests/test_knn_lm.py on the port
# --------------------------------------------------------------------------

def test_datastore_build_shapes(setup):
    ds, tcfg = setup["ds"], setup["tcfg"]
    assert ds.size == 4 * 47              # (hidden_t, token_{t+1}) pairs
    assert ds.keys.shape[1] == tcfg.d_model
    assert ((ds.values >= 0) & (ds.values < tcfg.vocab_size)).all()


def test_lookup_exact_vs_oracle(setup):
    ds, tcfg = setup["ds"], setup["tcfg"]
    q = torch.as_tensor(np.random.default_rng(1).normal(size=(8, tcfg.d_model)),
                        dtype=torch.float32)
    d2, vals = lookup(ds, q, k=4)
    qp = q.numpy()[:, ds.order.numpy()][:, :ds.keys.shape[1]]
    o = ((qp[:, None] - ds.keys.numpy()[None]) ** 2).sum(-1)
    idx = np.argsort(o, axis=1)[:, :4]
    np.testing.assert_allclose(np.sort(d2.numpy(), axis=1), np.take_along_axis(o, idx, axis=1),
                               rtol=1e-3, atol=1e-3)
    assert (np.diff(d2.numpy(), axis=1) >= -1e-6).all()


def test_knn_probs_is_distribution():
    d2 = torch.tensor([[0.1, 0.2, 0.5, 1.0]])
    vals = torch.tensor([[3, 3, 7, -1]], dtype=torch.int32)   # one invalid neighbor
    p = knn_probs(d2, vals, vocab=10, temperature=1.0)
    assert p.shape == (1, 10)
    np.testing.assert_allclose(float(p.sum()), 1.0, rtol=1e-5)
    assert float(p[0, 3]) > float(p[0, 7])           # closer -> heavier
    assert float(p[0, 1]) == 0.0


def test_retrieval_recalls_memorized_continuation(setup):
    """λ = 1 serving argmaxes to the memorized continuation when the query
    hidden state is a stored key."""
    model, ds, corpus = setup["model"], setup["ds"], setup["corpus"]
    tcfg = _lam(setup["tcfg"], 1.0)
    t = 20
    _, cache = prefill(model, tcfg, corpus[:, :t], corpus.shape[1] + 4)
    logp, _ = decode_step_retrieval(model, tcfg, corpus[:, t], cache, t, ds)
    pred = logp.argmax(-1).numpy()
    want = corpus[:, t + 1]
    assert (pred == want).mean() >= 0.75, (pred, want)


def test_retrieval_interpolation_changes_distribution(setup):
    model, ds, corpus, tcfg = setup["model"], setup["ds"], setup["corpus"], setup["tcfg"]
    assert len(init_cache(tcfg, 4, 40, device="cpu")) == tcfg.n_layers
    _, cache0 = prefill(model, tcfg, corpus[:, :20], 40)
    lam0, _ = decode_step_retrieval(model, tcfg, corpus[:, 20], cache0, 20, ds)
    lam_off, _ = decode_step_retrieval(model, _lam(tcfg, 0.0), corpus[:, 20], cache0, 20, ds)
    assert not np.allclose(lam0.numpy(), lam_off.numpy())


# --------------------------------------------------------------------------
# against the JAX functions
# --------------------------------------------------------------------------

def test_build_datastore_matches_jax(setup):
    ds, jds = setup["ds"], setup["jds"]
    np.testing.assert_array_equal(ds.order.numpy(), np.asarray(jds.order))
    np.testing.assert_array_equal(ds.values.numpy(), np.asarray(jds.values))
    np.testing.assert_allclose(ds.keys.numpy(), np.asarray(jds.keys), rtol=TOL, atol=TOL)
    assert ds.keys.dtype == torch.float32 and ds.values.dtype == torch.int32
    trunc = build_datastore(setup["model"], setup["tcfg"], [setup["corpus"]], m_dims=24)
    np.testing.assert_array_equal(trunc.keys.numpy(), ds.keys[:, :24].numpy())


@pytest.mark.parametrize("m_dims", [None, 24])
def test_lookup_matches_jax(setup, m_dims):
    """Foreign queries and the datastore's own (unprojected) hidden
    states, on the full and the truncated key space."""
    ds, jds, tcfg = setup["ds"], setup["jds"], setup["tcfg"]
    if m_dims is not None:
        ds = dataclasses.replace(ds, keys=ds.keys[:, :m_dims].contiguous())
        jds = dataclasses.replace(jds, keys=jds.keys[:, :m_dims])
    r = np.random.default_rng(2)
    inv = np.argsort(ds.order.numpy())
    q = np.concatenate([r.normal(size=(6, tcfg.d_model)),
                        ds.keys.numpy()[:4][:, inv] if m_dims is None
                        else r.normal(size=(4, tcfg.d_model))]).astype(np.float32)
    d2, vals = lookup(ds, torch.as_tensor(q), k=4)
    jd2, jvals = jlookup(jds, jnp.asarray(q), k=4)
    qp = q[:, ds.order.numpy()][:, :ds.keys.shape[1]].astype(np.float64)
    d64 = ((qp[:, None] - ds.keys.numpy().astype(np.float64)[None]) ** 2).sum(-1)
    _assert_topk(d2.numpy(), vals.numpy(), np.asarray(jd2), np.asarray(jvals), d64)


def test_knn_probs_matches_jax():
    r = np.random.default_rng(3)
    d2 = r.uniform(0, 3, (5, 6)).astype(np.float32)
    vals = r.integers(0, 4, (5, 6)).astype(np.int32)          # repeated values add
    vals[1, 2:] = -1
    vals[3] = -1                                               # no valid neighbour
    for temp in (1.0, 0.5):
        got = knn_probs(torch.as_tensor(d2), torch.as_tensor(vals), 9, temp)
        want = np.asarray(jprobs(jnp.asarray(d2), jnp.asarray(vals), 9, temp))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        assert float(got[3].abs().sum()) == 0.0 and torch.isfinite(got).all()


def test_interpolate_retrieval_matches_jax(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    r = np.random.default_rng(4)
    logits = r.normal(size=(3, jcfg.vocab_size)).astype(np.float32)
    d = r.uniform(-2, 2, (3, 4)).astype(np.float32)
    vals = r.integers(-1, jcfg.vocab_size, (3, 4)).astype(np.int32)
    want = np.asarray(jinterp(jcfg, jnp.asarray(logits), d, vals))
    for dd, vv in ((d, vals), (torch.as_tensor(d), torch.as_tensor(vals))):
        got = interpolate_retrieval(tcfg, torch.as_tensor(logits), dd, vv)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL_LOGP, atol=TOL_LOGP)


def test_decode_step_retrieval_matches_jax(setup):
    """From the JAX prefill cache carried across: three retrieval decode
    steps, each the same log-probabilities."""
    jcfg, tcfg, params, model = setup["jcfg"], setup["tcfg"], setup["params"], setup["model"]
    corpus, jds, ds = setup["corpus"], setup["jds"], setup["ds"]
    _, jcache = jprefill(params, jcfg, jnp.asarray(corpus[:, :20]), 30)
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg, device="cpu")
    step = jax.jit(lambda p, t, c, pos: jdecode_ret(p, jcfg, t, c, pos, jds))
    for t in range(20, 23):
        want, jcache = step(params, jnp.asarray(corpus[:, t]), jcache, jnp.int32(t))
        got, cache = decode_step_retrieval(model, tcfg, corpus[:, t], cache, t, ds)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_LOGP,
                                   atol=TOL_LOGP)


def test_sharded_lookup_matches_oracle_and_lookup(setup):
    """``tests/test_distributed.py::test_sharded_knn_lm_lookup`` on a
    4-slot CPU mesh, then the ring against the unsharded ``lookup`` on the
    kNN-LM datastore's first 184 keys (four equal shards)."""
    mesh = make_serving_mesh(4, device="cpu")
    r = np.random.default_rng(3)
    keys = r.normal(size=(256, 16)).astype(np.float32)
    vals = r.integers(0, 100, (256,)).astype(np.int32)
    q = r.normal(size=(32, 16)).astype(np.float32)
    d, v = sharded_lookup(mesh, "shard", k=4)(q, keys, vals)
    d2 = ((q[:, None] - keys[None]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :4]
    np.testing.assert_allclose(np.sort(d.numpy(), axis=1),
                               np.sort(np.take_along_axis(d2, idx, axis=1), axis=1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(v.numpy(), vals[idx])
    ds = setup["ds"]
    n = ds.size - ds.size % 4
    sub = dataclasses.replace(ds, keys=ds.keys[:n], values=ds.values[:n])
    qk = ds.keys[::7][:, np.argsort(ds.order.numpy())]
    want_d, want_v = lookup(sub, qk, k=4)
    got_d, got_v = sharded_lookup(mesh, "shard", k=4)(ds.keys[::7], sub.keys, sub.values)
    d64 = ((ds.keys[::7].double()[:, None] - sub.keys.double()[None]) ** 2).sum(-1).numpy()
    _assert_topk(got_d.numpy(), got_v.numpy(), want_d.numpy(), want_v.numpy(), d64)
    with pytest.raises(ValueError, match="equal shards"):
        sharded_lookup(mesh, "shard", k=4)(q, keys[:255], vals[:255])


# --------------------------------------------------------------------------
# generate
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def example():
    """``examples/knn_lm_serve.py``'s setup: k = 8, λ = 0.9, a (6, 64)
    corpus, prompts ``corpus[:4, :24]`` and their memorized continuations."""
    jcfg, tcfg = _cfgs(lam=0.9, k=8)
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    corpus = np.random.default_rng(0).integers(0, jcfg.vocab_size, (6, 64)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, corpus=corpus,
                prompts=corpus[:4, :24], want=corpus[:4, 24:32])


@pytest.mark.parametrize("head", ["none", "datastore", "retriever"])
def test_greedy_generate_matches_jax(example, head):
    jcfg, tcfg, params, model = (example[k] for k in ("jcfg", "tcfg", "params", "model"))
    corpus, prompts = example["corpus"], example["prompts"]
    jds = ds = None
    if head == "datastore":
        jds = jbuild(params, jcfg, [jnp.asarray(corpus)])
        ds = build_datastore(model, tcfg, [corpus])
    elif head == "retriever":
        jds = JRetriever.build(params, jcfg, [jnp.asarray(corpus)],
                               hybrid_config=JHybrid(k=8, metric="ip"))
        ds = IndexRetriever.build(model, tcfg, [corpus],
                                  hybrid_config=HybridConfig(k=8, metric="ip"))
        assert ds.size == jds.size == 6 * 63
    want = np.asarray(jserve.generate(params, jcfg, jnp.asarray(prompts), 8, ds=jds))
    got = generate(model, tcfg, prompts, 8, ds=ds)
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    if head != "none":
        assert (got.numpy() == example["want"]).mean() > 0.5


def test_example_assertion_on_a_4_slot_mesh(example):
    """The example on the port: a ``ShardedKNNIndex`` over 4 CPU slots,
    ``metric="ip"``, behind ``KNNServer``; retrieval beats the bare LM on
    memorized prompts and nothing is shed."""
    tcfg, model, corpus = example["tcfg"], example["model"], example["corpus"]
    ds = IndexRetriever.build(model, tcfg, [corpus], mesh=make_serving_mesh(4, device="cpu"),
                              hybrid_config=HybridConfig(k=8, metric="ip"),
                              server_config=ServerConfig(deadline=5.0))
    assert ds.index.n_shards == 4
    out_ret = generate(model, tcfg, example["prompts"], 8, ds=ds).numpy()
    out_base = generate(model, tcfg, example["prompts"], 8, ds=None).numpy()
    acc_ret = float((out_ret == example["want"]).mean())
    acc_base = float((out_base == example["want"]).mean())
    assert acc_ret > acc_base, (acc_ret, acc_base)
    m = ds.server.metrics()
    assert m["n_shed_total"] == 0 and m["n_served"] == 4 * (1 + 8)   # prefill + 8 steps
    # Through the server or straight to the index: the same answers.
    direct = IndexRetriever(ds.index, ds.values)
    q = np.random.default_rng(5).normal(size=(5, tcfg.d_model)).astype(np.float32)
    (d1, v1), (d2, v2) = ds.lookup(q, k=8), direct.lookup(q, k=8)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(v1, v2)


def test_index_retriever_insert_and_metric_check(example):
    tcfg, model, corpus = example["tcfg"], example["model"], example["corpus"]
    with pytest.raises(ValueError, match="metric='ip'"):
        IndexRetriever.build(model, tcfg, [corpus], hybrid_config=HybridConfig(k=8))
    ds = IndexRetriever.build(model, tcfg, [corpus[:3]],
                              hybrid_config=HybridConfig(k=8, metric="ip"))
    ds.insert(model, tcfg, [corpus[3:]])
    assert ds.size == len(ds.values) == 6 * 63
    want = example["want"]
    out = generate(model, tcfg, example["prompts"], 8, ds=ds).numpy()
    assert (out[3] == want[3]).mean() > 0.5          # row 3 lives in the inserted text


def test_sampled_generate_is_seeded(example):
    tcfg, model, prompts = example["tcfg"], example["model"], example["prompts"]
    a = generate(model, tcfg, prompts, 6, temperature=1.0, seed=3)
    b = generate(model, tcfg, prompts, 6, temperature=1.0, seed=3)
    c = generate(model, tcfg, prompts, 6, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((a >= 0) & (a < tcfg.vocab_size)).all()
