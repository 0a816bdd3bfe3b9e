"""The port's IVF slice against the JAX package's, on the CPU: the IVF
candidate top-k's plain version against ``repro.kernels.ref.ivf_topk_ref``
(the position tie rule included), ``dedup_candidates``, ``absorb`` and
``candidates`` bitwise from a carried-over JAX ``IVFState``, the k-means of
``refit`` from shared init rows, the port's own init and refit (drawn from
``repro_torch.prng`` keys, the reference's streams) against JAX's, the IVF
``SemanticCache`` (fused, separate, tenants) over scripted traffic and the
IVF engine through its refits, each with no state carried across, and
engine snapshots in both directions. The JAX side runs through its jnp
paths (``ref.ivf_topk_ref``, ``IVFIndex(backend="jnp")``); the CUDA kernel
runs on the card in ``test_torch_cuda.py``."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import SemanticCache as JCache
from repro.core.index import IVFIndex as JIVFIndex
from repro.core.index import IVFState as JIVFState
from repro.core.index import _absorb_serial as j_absorb_serial
from repro.core.index import dedup_candidates as jdedup
from repro.core.similarity import l2_normalize as jnormalize
from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus, build_test_queries
from repro.kernels import ref as jref
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro.tenancy import TenantRegistry as JRegistry
from repro.tenancy import TenantSpec as JSpec
from repro_torch import prng
from repro_torch.core.cache import SemanticCache
from repro_torch.core.index import (ExactIndex, IVFIndex, IVFState,
                                    _absorb_serial, dedup_candidates)
from repro_torch.core.types import CacheConfig
from repro_torch.kernels import cosine_topk as kcos
from repro_torch.kernels import ivf_topk as kivf
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.serving import CachedEngine, Request, SimulatedLLMBackend
from repro_torch.tenancy import TenantRegistry, TenantSpec
from test_torch_cuda import IVF_CASES, keys_to_torch, make_ivf_inputs
from test_torch_engine import _same_responses
from test_torch_store_cache import (STATS_LEAVES, _assert_same,
                                    _assert_same_state, _configs,
                                    _result_fields, _traffic)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SCORE_TOL = {"f32": 1e-5, "int8": 1e-5, "bf16": 1e-2}
IVF_LEAVES = ("centroids", "buckets", "bucket_valid")


@pytest.fixture(autouse=True, params=[True, False],
                ids=["partitionable", "original"])
def threefry_mode(request):
    """Both threefry modes, set alike in jax and in ``repro_torch.prng``:
    partitionable (jax >= 0.5's default) and original (jax 0.4's)."""
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    with prng.partitionable(request.param):
        yield request.param
    jax.config.update("jax_threefry_partitionable", was)


def _jax_keys(keys, key_dtype):
    return jnp.asarray(keys, dtype=jnp.bfloat16 if key_dtype == "bf16"
                       else None)


def _to_torch_state(js) -> IVFState:
    return IVFState(*(torch.from_numpy(np.array(getattr(js, n)))
                      for n in IVF_LEAVES))


def _same_state(js, ts, centroid_tol=0.0):
    np.testing.assert_allclose(ts.centroids.numpy(), np.asarray(js.centroids),
                               rtol=0, atol=centroid_tol)
    _assert_same(js.buckets, ts.buckets, "buckets")
    _assert_same(js.bucket_valid, ts.bucket_valid, "bucket_valid")


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# --------------------------------------------------------------------- #
@pytest.mark.parametrize("key_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,n,m,d,k", IVF_CASES)
def test_ivf_topk_plain_version_matches_jax_ref(b, n, m, d, k, key_dtype):
    q, keys, cand, ties = make_ivf_inputs(b, n, m, d, k, key_dtype,
                                          seed=b + n + m)
    jk = _jax_keys(keys, key_dtype)
    js, ji = jref.ivf_topk_ref(jnp.asarray(q), jk, jnp.asarray(cand), k)
    js, ji = np.asarray(js), np.asarray(ji)
    ts, ti = tref.ivf_topk_ref(torch.from_numpy(q),
                               keys_to_torch(keys, key_dtype),
                               torch.from_numpy(cand), k)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert ts.shape == ti.shape == (b, k)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0,
                               atol=SCORE_TOL[key_dtype])
    np.testing.assert_array_equal(ti.numpy(), ji)
    # all-invisible rows and the tail past the visible ids: (-inf, -1)
    n_vis = ((cand >= 0) & (cand < n)).sum(1)
    for r in range(b):
        assert bool(torch.all(ti[r, n_vis[r]:] == -1))
        assert bool(torch.all(torch.isneginf(ts[r, n_vis[r]:])))
    # planted ties break by candidate position, not slot id
    for r, want in ties.items():
        assert ti[r, :len(want)].tolist() == want
    # the ops dispatch takes the same plain version for CPU tensors
    before = dict(kivf.launches)
    os_, oi = ops.ivf_topk(torch.from_numpy(q), keys_to_torch(keys, key_dtype),
                           torch.from_numpy(cand), k=k)
    assert kivf.launches == before
    assert torch.equal(os_, ts) and torch.equal(oi, ti)


def test_ivf_topk_ids_past_the_slab_are_invisible():
    """An id >= N is treated as invisible by the plain version, as by the
    kernel (the JAX oracle would clamp it onto slot N-1)."""
    q, keys, cand, _ = make_ivf_inputs(5, 50, 40, 16, 4, "f32", seed=3)
    bad = cand.copy()
    bad[:, ::3] = 50 + np.arange(bad[:, ::3].shape[1])
    cleaned = np.where(bad >= 50, -1, bad).astype(np.int32)
    got = tref.ivf_topk_ref(torch.from_numpy(q), torch.from_numpy(keys),
                            torch.from_numpy(bad), 4)
    want = tref.ivf_topk_ref(torch.from_numpy(q), torch.from_numpy(keys),
                             torch.from_numpy(cleaned), 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not bool(torch.any(got[1] >= 50))


@pytest.mark.parametrize("bad", ["cand_i64", "cand_rows", "queries_f64",
                                 "k0", "k_over_max", "k_over_m", "noncontig",
                                 "backend"])
def test_ivf_topk_refuses_what_the_kernel_does_not_take(bad):
    q, keys = torch.zeros((2, 8)), torch.zeros((16, 8))
    cand = torch.zeros((2, 5), dtype=torch.int32)
    k, backend = 4, "auto"
    if bad == "cand_i64":
        cand = cand.long()
    elif bad == "cand_rows":
        cand = cand[:1]
    elif bad == "queries_f64":
        q = q.double()
    elif bad == "k0":
        k = 0
    elif bad == "k_over_max":
        cand = torch.zeros((2, kivf.MAX_K + 1), dtype=torch.int32)
        k = kivf.MAX_K + 1
    elif bad == "k_over_m":
        k = 6
    elif bad == "noncontig":
        cand = torch.zeros((5, 2), dtype=torch.int32).T
    else:
        backend = "pallas"
    with pytest.raises(ValueError):
        ops.ivf_topk(q, keys, cand, k=k, backend=backend)
    if bad != "backend":
        with pytest.raises(ValueError):
            kivf.ivf_topk_cuda(q, keys, cand, k)


def test_ivf_wrapper_takes_cuda_tensors_only():
    q, keys = torch.zeros((2, 8)), torch.zeros((16, 8))
    cand = torch.zeros((2, 5), dtype=torch.int32)
    before = dict(kivf.launches)
    with pytest.raises(RuntimeError, match="CUDA"):
        kivf.ivf_topk_cuda(q, keys, cand, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ivf_topk(q, keys, cand, k=4, backend="kernel")
    assert kivf.launches == before
    kivf.launches["ivf_topk"] += 2
    kivf.reset_launches()
    assert kivf.launches == {"ivf_topk": 0}


def test_cosine_topk_takes_the_probe_k():
    """The repair of the cosine kernel's limit: k=16 (the serve probe) on
    the CPU equals the JAX oracle, and k up to MAX_K passes the checks."""
    rng = np.random.default_rng(8)
    q, keys = _unit(rng, (9, 32)), _unit(rng, (128, 32))
    valid = np.ones(128, dtype=bool)
    ts, ti = ops.cosine_topk(torch.from_numpy(q), torch.from_numpy(keys),
                             torch.from_numpy(valid), k=16)
    js, ji = jref.cosine_topk_ref(jnp.asarray(q), jnp.asarray(keys),
                                  jnp.asarray(valid), 16)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert kcos.MAX_K >= 16
    kcos.check_args(torch.from_numpy(q), torch.from_numpy(keys),
                    torch.from_numpy(valid), kcos.MAX_K)


# --------------------------------------------------------------------- #
def test_dedup_candidates_matches_jax():
    rng = np.random.default_rng(4)
    cand = rng.integers(-1, 12, (7, 40)).astype(np.int32)
    visible = (rng.random((7, 40)) < 0.6) & (cand >= 0)
    visible[0] = False                  # an all-invisible row
    got = dedup_candidates(torch.from_numpy(cand), torch.from_numpy(visible))
    want = jdedup(jnp.asarray(cand), jnp.asarray(visible))
    _assert_same(want, got, "dedup")
    # a duplicate is dropped only after a visible first occurrence
    assert int(got.sum()) < int(visible.sum())


def _fitted(c=4, cap=8, n=40, d=16, seed=0, key_dtype="f32"):
    """A JAX IVFIndex fitted on n of 64 random unit keys, its port twin and
    the slab, as numpy."""
    rng = np.random.default_rng(seed)
    keys = np.zeros((64, d), np.float32)
    keys[:n] = _unit(rng, (n, d))
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    alive = np.zeros(64, dtype=bool)
    alive[:n] = True
    jidx = JIVFIndex(ncentroids=c, nprobe=2, bucket_cap=cap, topk=3,
                     backend="jnp")
    jst = jidx.fit(jnp.asarray(keys), jnp.asarray(alive),
                   jax.random.PRNGKey(seed))
    tidx = IVFIndex(ncentroids=c, nprobe=2, bucket_cap=cap, topk=3)
    return jidx, tidx, jst, keys, alive


def test_absorb_matches_jax_and_the_serial_oracle():
    """Three batches into small buckets: buckets overflow (the last writer
    wins on the tail slot), masked rows write nothing."""
    jidx, tidx, jst, _, _ = _fitted(cap=8)
    tst = _to_torch_state(jst)
    rng = np.random.default_rng(9)
    overflowed = False
    for step in range(3):
        emb = rng.standard_normal((20, 16)).astype(np.float32)
        slots = rng.permutation(64)[:20].astype(np.int32)
        mask = rng.random(20) < 0.8
        mask[step] = False
        jst = jidx.absorb(jst, jnp.asarray(slots), jnp.asarray(emb),
                          jnp.asarray(mask))
        assign = torch.argmax(
            torch.from_numpy(np.array(jnormalize(jnp.asarray(emb))))
            @ tst.centroids.T, dim=-1)
        sb, sv = _absorb_serial(tst.buckets, tst.bucket_valid, assign,
                                torch.from_numpy(slots),
                                torch.from_numpy(mask), 8)
        jb, jv = j_absorb_serial(
            jnp.asarray(tst.buckets.numpy()),
            jnp.asarray(tst.bucket_valid.numpy()), jnp.asarray(assign.numpy()),
            jnp.asarray(slots), jnp.asarray(mask), 8)
        tst = tidx.absorb(tst, torch.from_numpy(slots), torch.from_numpy(emb),
                          torch.from_numpy(mask))
        _same_state(jst, tst)
        assert torch.equal(tst.buckets, sb) and torch.equal(
            tst.bucket_valid, sv)
        _assert_same(jb, sb, "serial buckets")
        _assert_same(jv, sv, "serial bucket_valid")
        overflowed |= bool(tst.bucket_valid.all(1).any())
    assert overflowed


@pytest.mark.parametrize("visibility", ["shared", "per_row", "interval",
                                        "dead_buckets"])
def test_candidates_match_jax(visibility):
    jidx, tidx, jst, keys, alive = _fitted(c=6, cap=16, n=60, seed=2)
    rng = np.random.default_rng(5)
    # recycle some slots into other buckets, as absorb leaves them
    emb = keys[rng.integers(0, 60, 12)] + 0.3 * rng.standard_normal(
        (12, 16)).astype(np.float32)
    slots = rng.integers(0, 60, 12).astype(np.int32)
    jst = jidx.absorb(jst, jnp.asarray(slots), jnp.asarray(emb),
                      jnp.ones(12, bool))
    if visibility == "dead_buckets":
        jst = JIVFState(jst.centroids, jst.buckets,
                        jst.bucket_valid.at[1].set(False).at[4, 3:].set(False))
    tst = _to_torch_state(jst)
    q = _unit(rng, (9, 16))
    valid, interval = alive & (rng.random(64) < 0.8), None
    if visibility == "per_row":
        valid = alive[None, :] & (rng.random((9, 64)) < 0.7)
    elif visibility == "interval":
        starts = np.array([0, 20, 40] * 3, np.int32)
        sizes = np.array([20, 20, 24, 0, 20, 24, 20, 0, 24], np.int32)
        interval = (starts, sizes)
    jc = jidx.candidates(jst, jnp.asarray(q), jnp.asarray(valid),
                         interval=None if interval is None
                         else tuple(jnp.asarray(x) for x in interval))
    tc = tidx.candidates(tst, torch.from_numpy(q), torch.from_numpy(valid),
                         interval=None if interval is None
                         else tuple(torch.from_numpy(x) for x in interval))
    _assert_same(jc, tc, "candidates")
    assert bool((tc >= 0).any()) and bool((tc == -1).any())
    # search is the candidate top-k of the same ids
    js, ji = jidx.search(jst, jnp.asarray(q), jnp.asarray(keys),
                         jnp.asarray(valid), interval=None if interval is None
                         else tuple(jnp.asarray(x) for x in interval))
    ts, ti = tidx.search(tst, torch.from_numpy(q), torch.from_numpy(keys),
                         torch.from_numpy(valid),
                         interval=None if interval is None
                         else tuple(torch.from_numpy(x) for x in interval))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    _assert_same(ji, ti, "search ids")


# --------------------------------------------------------------------- #
def _jax_init_rows(idx, alive, rng):
    """The k-means init rows of ``repro.core.index.IVFIndex.refit``."""
    p = jnp.asarray(alive).astype(jnp.float32) + 1e-6
    return np.array(jax.random.choice(rng, alive.shape[0],
                                        shape=(idx.ncentroids,),
                                        replace=True, p=p / p.sum()))


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_kmeans_from_shared_init_rows_matches_jax(key_dtype):
    """Fed the rows JAX's refit draws, the port's k-means reaches the same
    bucket tables, and centroids within 1e-5."""
    rng = np.random.default_rng(6)
    keys = _unit(rng, (300, 24))
    if key_dtype == "int8":
        keys = np.clip(np.round(keys * 127.0), -127, 127).astype(np.int8)
    alive = rng.random(300) < 0.9
    jidx = JIVFIndex(ncentroids=12, nprobe=3, bucket_cap=24, backend="jnp")
    tidx = IVFIndex(ncentroids=12, nprobe=3, bucket_cap=24)
    key = jax.random.PRNGKey(4)
    jst = jidx.refit(None, jnp.asarray(keys), jnp.asarray(alive), key)
    tst = tidx.kmeans(torch.from_numpy(keys), torch.from_numpy(alive),
                      torch.from_numpy(_jax_init_rows(jidx, alive, key)))
    _same_state(jst, tst, centroid_tol=1e-5)
    assert bool(tst.bucket_valid.all(1).any())        # some buckets are full
    assert not bool(tst.bucket_valid.all())


def test_own_refit_recall_is_that_of_jax_refit():
    """The port's refit draws its init rows from the key JAX's takes
    (``prng.choice``), so its tables are JAX's: the same buckets, centroids
    within 1e-5, the same search ids and so the same recall@1 against the
    exact index on the same slab and queries, under refit keys 1, 2 and 3.
    Recall stays above 0.5 and some key's falls below 1: the probe misses
    rows there, so the equal ids are those of an approximate search (key
    1 alone finds every row in the original mode)."""
    rng = np.random.default_rng(7)
    keys = _unit(rng, (1500, 32))
    alive = np.ones(1500, dtype=bool)
    base = keys[rng.integers(0, 1500, 256)]
    q = base + 0.08 * rng.standard_normal(base.shape).astype(np.float32)
    kw = dict(ncentroids=24, nprobe=4, bucket_cap=128, topk=1)
    jidx, tidx = JIVFIndex(backend="jnp", **kw), IVFIndex(**kw)
    _, exact = ExactIndex(topk=1).search(None, torch.from_numpy(q),
                                         torch.from_numpy(keys),
                                         torch.from_numpy(alive))
    recalls = []
    for seed in (1, 2, 3):
        jst = jidx.fit(jnp.asarray(keys), jnp.asarray(alive),
                       jax.random.PRNGKey(seed))
        _, ji = jidx.search(jst, jnp.asarray(q), jnp.asarray(keys),
                            jnp.asarray(alive))
        tst = tidx.fit(torch.from_numpy(keys), torch.from_numpy(alive),
                       prng.key(seed))
        _same_state(jst, tst, centroid_tol=1e-5)
        _, ti = tidx.search(tst, torch.from_numpy(q),
                            torch.from_numpy(keys), torch.from_numpy(alive))
        _assert_same(ji, ti, "search ids")
        jrec = float(np.mean(np.asarray(ji)[:, 0] == exact[:, 0].numpy()))
        trec = float(torch.mean((ti[:, 0] == exact[:, 0]).float()))
        assert 0.5 < jrec <= 1.0
        assert trec == jrec, (seed, trec, jrec)
        recalls.append(jrec)
    assert min(recalls) < 1.0, recalls


def test_init_and_refit_draw_from_the_reference_keys():
    """``init`` holds the reference's ``normal(PRNGKey(0), (C, d))``
    centroids, normalized; ``refit`` under a key draws JAX's rows, among
    them dead ones where few are alive, and is the same on every call."""
    idx = IVFIndex(ncentroids=5, bucket_cap=4)
    jidx = JIVFIndex(ncentroids=5, bucket_cap=4, backend="jnp")
    cfg = CacheConfig(dim=8, capacity=32)
    a, b = idx.init(cfg, CPU), idx.init(cfg, CPU)
    assert torch.equal(a.centroids, b.centroids)
    np.testing.assert_allclose(
        a.centroids.numpy(),
        np.asarray(jidx.init(JConfig(dim=8, capacity=32)).centroids),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.centroids.norm(dim=1).numpy(), 1.0,
                               atol=1e-6)
    assert bool(torch.all(a.buckets == -1)) and not bool(a.bucket_valid.any())
    rng = np.random.default_rng(3)
    keys = _unit(rng, (32, 8))
    for alive in (np.ones(32, dtype=bool), np.arange(32) < 2):
        p = torch.from_numpy(alive).float() + 1e-6
        rows = prng.choice(prng.key(3), 32, (5,), p / prng.xla_sum(p))
        np.testing.assert_array_equal(
            rows.numpy(), _jax_init_rows(jidx, alive, jax.random.PRNGKey(3)))
        s1 = idx.refit(a, torch.from_numpy(keys), torch.from_numpy(alive),
                       prng.key(3))
        s2 = idx.refit(a, torch.from_numpy(keys), torch.from_numpy(alive),
                       prng.key(3))
        assert torch.equal(s1.buckets, s2.buckets)
        _same_state(jidx.refit(None, jnp.asarray(keys), jnp.asarray(alive),
                               jax.random.PRNGKey(3)), s1, centroid_tol=1e-5)


# --------------------------------------------------------------------- #
def _ivf_caches(key_dtype, tenants):
    jcfg, tcfg = _configs(key_dtype, dim=16, capacity=64, value_len=4,
                          ttl=None, threshold=0.8)
    kw = dict(ncentroids=4, nprobe=2, bucket_cap=8)
    jpart = tpart = None
    if tenants:
        specs = [dict(name=f"t{i}", share=1.0 + i % 2) for i in range(4)]
        jpart = JRegistry(tuple(JSpec(**s) for s in specs)).partition(64)
        tpart = TenantRegistry(tuple(TenantSpec(**s) for s in specs)
                               ).partition(64)
    return (JCache(jcfg, index=JIVFIndex(backend="jnp", **kw),
                   partition=jpart),
            SemanticCache(tcfg, index=IVFIndex(**kw), partition=tpart))


@pytest.mark.parametrize("tenants", [False, True])
@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("path", ["fused", "separate"])
def test_ivf_cache_matches_jax(path, key_dtype, tenants):
    """Scripted traffic of repeats, paraphrases and fresh rows through an
    IVF cache, each package from its own initial index state; after the
    third batch both refit under the same key. Every lookup result, slab
    leaf, counter and index table equals the JAX package's."""
    jcache, tcache = _ivf_caches(key_dtype, tenants)
    jrt = jcache.init()
    trt = tcache.init(CPU)
    _same_state(jrt.index_state, trt.index_state, centroid_tol=1e-6)
    rng = np.random.default_rng(21)
    for t, (emb, vals, lens, sid, valid, _) in enumerate(
            _traffic(rng, 7, 8, 16)):
        now = float(t)
        tid = rng.integers(0, 4, 8).astype(np.int32) if tenants else None
        jt = None if tid is None else jnp.asarray(tid)
        tt = None if tid is None else torch.from_numpy(tid)
        jq, tq = jnp.asarray(emb), torch.from_numpy(emb)
        if t == 3:
            jrt = jcache.refit(jrt, now, jax.random.PRNGKey(t))
            trt = tcache.refit(trt, now, prng.key(t))
            _same_state(jrt.index_state, trt.index_state, centroid_tol=1e-5)
        if path == "fused":
            jpeek, _ = jcache.lookup(jrt, jq, now, update_counters=False,
                                     tenant_id=jt)
            tpeek, _ = tcache.lookup(trt, tq, now, update_counters=False,
                                     tenant_id=tt)
            _result_fields(jpeek, tpeek)
            jres, jrt = jcache.step(
                jrt, jq, jnp.asarray(vals), jnp.asarray(lens), now,
                source_id=jnp.asarray(sid), peeked=jpeek,
                valid=jnp.asarray(valid), tenant_id=jt)
            tres, trt = tcache.step(
                trt, tq, torch.from_numpy(vals), torch.from_numpy(lens), now,
                source_id=torch.from_numpy(sid), peeked=tpeek,
                valid=torch.from_numpy(valid), tenant_id=tt)
        else:
            jres, jrt = jcache.lookup(jrt, jq, now, tenant_id=jt)
            tres, trt = tcache.lookup(trt, tq, now, tenant_id=tt)
            miss = ~np.asarray(jres.hit)
            if miss.any():
                m = torch.from_numpy(miss)
                jrt = jcache.insert(
                    jrt, jq[miss], jnp.asarray(vals[miss]),
                    jnp.asarray(lens[miss]), now,
                    source_id=jnp.asarray(sid[miss]),
                    tenant_id=None if jt is None else jt[miss])
                trt = tcache.insert(
                    trt, tq[m], torch.from_numpy(vals[miss]),
                    torch.from_numpy(lens[miss]), now,
                    source_id=torch.from_numpy(sid[miss]),
                    tenant_id=None if tt is None else tt[m])
        _result_fields(jres, tres)
        score = np.asarray(jres.score)
        assert np.all(np.abs(score[np.isfinite(score)] - 0.8) > 1e-5)
        _assert_same_state(jrt.state, trt.state)
        for name in STATS_LEAVES:
            _assert_same(getattr(jrt.stats, name), getattr(trt.stats, name),
                         f"stats.{name}")
        _same_state(jrt.index_state, trt.index_state, centroid_tol=1e-5)
    assert int(trt.stats.hits) > 0 and int(trt.stats.misses) > 0
    assert bool(trt.index_state.bucket_valid.all(1).any())


# --------------------------------------------------------------------- #
def _ivf_engines(rebuild_every=10 ** 6):
    pairs = build_corpus(30, seed=0)
    tests = build_test_queries(pairs, n_per_category=15, seed=1)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    kw = dict(dim=384, capacity=512, value_len=48, ttl=None, threshold=0.8)
    ikw = dict(ncentroids=8, nprobe=4, bucket_cap=32)
    ekw = dict(judge=judge, batch_size=16, rebuild_every=rebuild_every)
    jeng = JEngine(JConfig(**kw), JBackend(pairs),
                   index=JIVFIndex(backend="jnp", **ikw), **ekw)
    teng = CachedEngine(CacheConfig(**kw), SimulatedLLMBackend(pairs),
                        index=IVFIndex(**ikw), device="cpu", **ekw)
    jreq = [JRequest(query=q.query, category=q.category, source_id=q.source_id,
                     semantic_key=q.semantic_key) for q in tests]
    treq = [Request(query=q.query, category=q.category, source_id=q.source_id,
                    semantic_key=q.semantic_key) for q in tests]
    return pairs, jeng, teng, jreq, treq


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_engine_snapshots_carry_ivf_state_across_packages(tmp_path, first):
    """One package warms (absorbing into its init centroids), serves one
    batch (which refits) and saves; a fresh engine of the other package
    loads the snapshot and serves the rest with the decisions, slab and
    bucket tables of the first engine serving the rest."""
    pairs, jeng, teng, jreq, treq = _ivf_engines()
    src, reqs = (jeng, jreq) if first == "jax" else (teng, treq)
    src.warm(pairs)
    head = src.process(reqs[:16])
    assert any(r.cached for r in head)
    src.save_cache(str(tmp_path / "snap"))
    _, jeng2, teng2, _, _ = _ivf_engines()
    dst, dreqs = (teng2, treq) if first == "jax" else (jeng2, jreq)
    dst.load_cache(str(tmp_path / "snap"))
    dst.tokenizer.encode_batch([p.answer for p in pairs], 48)
    assert not dst._needs_refit
    for leaf in IVF_LEAVES:
        a = np.asarray(getattr(src.runtime.index_state, leaf))
        b = np.asarray(getattr(dst.runtime.index_state, leaf))
        np.testing.assert_array_equal(a, b)
    a, b = src.process(reqs[16:]), dst.process(dreqs[16:])
    j, t = (src, dst) if first == "jax" else (dst, src)
    _same_responses(*((a, b) if first == "jax" else (b, a)))
    _assert_same_state(j.runtime.state, t.runtime.state)
    _same_state(j.runtime.index_state, t.runtime.index_state)
    assert any(r.cached for r in a) and not all(r.cached for r in a)


@pytest.mark.parametrize("fused", [True, False])
def test_ivf_engine_matches_jax_through_refits(fused):
    """Each engine draws its own index: init centroids from key 0, the
    k-means rows of each refit under a fresh split of key 17. No state is
    carried across. With a refit every 6 inserts (three or more while
    serving), every answer, decision and score, the slab slot by slot, the
    counters, the bucket tables and the centroids (1e-5) equal the JAX
    engine's after warming and after every batch."""
    pairs, jeng, teng, jreq, treq = _ivf_engines(rebuild_every=6)
    jeng.use_fused_step = teng.use_fused_step = fused
    _same_state(jeng.runtime.index_state, teng.runtime.index_state,
                centroid_tol=1e-6)
    jeng.warm(pairs)
    teng.warm(pairs)
    for i in range(0, len(jreq), 16):
        _same_responses(jeng.process(jreq[i:i + 16]),
                        teng.process(treq[i:i + 16]))
        _assert_same_state(jeng.runtime.state, teng.runtime.state)
        for name in STATS_LEAVES:
            _assert_same(getattr(jeng.stats, name),
                         getattr(teng.stats, name), f"stats.{name}")
        _same_state(jeng.runtime.index_state, teng.runtime.index_state,
                    centroid_tol=1e-5)
    assert teng.refits >= 3, teng.refits
    assert 0 < int(teng.stats.hits) < int(teng.stats.lookups)


def test_snapshot_of_another_index_is_refused(tmp_path):
    pairs, _, teng, _, _ = _ivf_engines()
    teng.warm(pairs[:20])
    teng.save_cache(str(tmp_path / "ivf"))
    exact = CachedEngine(CacheConfig(dim=384, capacity=512, value_len=48,
                                     ttl=None), SimulatedLLMBackend(pairs),
                         batch_size=16, device="cpu")
    with pytest.raises(ValueError, match="index"):
        exact.load_cache(str(tmp_path / "ivf"))
    exact.save_cache(str(tmp_path / "exact"))
    with pytest.raises(ValueError, match="index"):
        teng.load_cache(str(tmp_path / "exact"))


def test_serve_driver_ivf_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_THREEFRY_PARTITIONABLE=str(int(prng.is_partitionable())))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--index", "ivf", "--corpus", "50", "--queries", "10"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"categories"' in out.stdout and '"cache_hits"' in out.stdout
