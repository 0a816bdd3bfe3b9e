"""The port's slab store and SemanticCache against the JAX package's, on
the same numpy-seeded inputs: scripted insert / expire / touch sequences
over every eviction policy and slab dtype, and multi-batch peek + fused
step traffic with padded batches under fixed and adaptive policies."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import similarity as jsim
from repro.core import store as jstore
from repro.core.cache import SemanticCache as JCache
from repro.core.policy import AdaptiveThreshold as JAdaptive
from repro.core.types import CacheConfig as JConfig
from repro.core.types import CacheState as JState
from repro.core.types import init_cache_state
from repro_torch.core import similarity as tsim
from repro_torch.core import store as tstore
from repro_torch.core.cache import SemanticCache
from repro_torch.core.policy import AdaptiveThreshold
from repro_torch.core.types import CacheConfig
from repro_torch.core.types import init_cache_state as tinit

CPU = torch.device("cpu")
FLOAT_TOL = 1e-7
DTYPES = {"f32": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}
STATE_LEAVES = [f.name for f in dataclasses.fields(JState)]
STATS_LEAVES = ["lookups", "hits", "misses", "expired_evictions", "inserts"]


def _configs(key_dtype, eviction="ring", **kw):
    jd, td = DTYPES[key_dtype]
    return (JConfig(key_dtype=jd, eviction=eviction, **kw),
            CacheConfig(key_dtype=td, eviction=eviction, **kw))


def _assert_same(jx, tx, name):
    j = np.asarray(jx)
    t = tx.cpu().numpy()
    assert j.shape == t.shape, name
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=0, atol=FLOAT_TOL, err_msg=name)
    else:
        assert t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)


def _assert_same_state(js, ts):
    for name in STATE_LEAVES:
        _assert_same(getattr(js, name), getattr(ts, name), f"state.{name}")


def _batch(rng, b, d, value_len):
    emb = rng.standard_normal((b, d)).astype(np.float32)
    vals = rng.integers(0, 1000, (b, value_len)).astype(np.int32)
    lens = rng.integers(1, value_len + 1, (b,)).astype(np.int32)
    sid = rng.integers(0, 100, (b,)).astype(np.int32)
    return emb, vals, lens, sid


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("eviction", ["ring", "lru", "lfu"])
def test_store_script_matches_jax(eviction, key_dtype):
    jcfg, tcfg = _configs(key_dtype, eviction, dim=8, capacity=16,
                          value_len=4, ttl=5.0)
    js, ts = init_cache_state(jcfg), tinit(tcfg, CPU)
    rng = np.random.default_rng(7)
    script = [
        ("insert", 0.0, 6, None),
        ("touch", 1.0, [0, 2, 2, 5], [True, True, True, False]),
        ("insert", 2.0, 6, [True, False, True, True, False, True]),
        ("touch", 3.0, [6, 6, 1], [True, True, True]),
        ("expire", 5.5, None, None),
        ("insert", 6.0, 8, None),
        ("touch", 7.0, [1, 3, 3, 9], [True, True, False, True]),
        ("insert", 8.0, 6, [False, True, True, False, True, True]),
        ("insert", 8.5, 7, None),
    ]
    for op, now, arg, mask in script:
        if op == "insert":
            emb, vals, lens, sid = _batch(rng, arg, 8, 4)
            m = None if mask is None else np.asarray(mask)
            js, jslots = jstore.insert(
                jcfg, js, jnp.asarray(emb), jnp.asarray(vals),
                jnp.asarray(lens), now, source_id=jnp.asarray(sid),
                mask=None if m is None else jnp.asarray(m))
            ts, tslots = tstore.insert(
                tcfg, ts, torch.from_numpy(emb), torch.from_numpy(vals),
                torch.from_numpy(lens), now, source_id=torch.from_numpy(sid),
                mask=None if m is None else torch.from_numpy(m))
            _assert_same(jslots, tslots, "slots")
        elif op == "touch":
            slot, hit = np.asarray(arg, np.int32), np.asarray(mask)
            js = jstore.touch(js, jnp.asarray(slot), now, jnp.asarray(hit))
            ts = tstore.touch(ts, torch.from_numpy(slot), now,
                              torch.from_numpy(hit))
        else:
            js, jn = jstore.expire(js, now)
            ts, tn = tstore.expire(ts, now)
            assert int(jn) == int(tn) > 0
        _assert_same_state(js, ts)
        _assert_same(jstore.alive_mask(js, now), tstore.alive_mask(ts, now),
                     "alive")
        assert tstore.occupancy(ts, now) == pytest.approx(
            float(jstore.occupancy(js, now)))


def _traffic(rng, n_batches, b, d):
    """Batches mixing exact repeats of earlier rows (cosine 1), close
    paraphrases (cosine ~0.95) and fresh random rows (cosine ~0)."""
    seen = []
    out = []
    for t in range(n_batches):
        rows = []
        for i in range(b):
            kind = rng.integers(0, 3) if seen else 2
            if kind == 0:
                rows.append(seen[rng.integers(len(seen))])
            elif kind == 1:
                base = seen[rng.integers(len(seen))]
                rows.append(base + 0.15 * rng.standard_normal(d)
                            / np.sqrt(d) * np.linalg.norm(base))
            else:
                rows.append(rng.standard_normal(d))
        emb = np.stack(rows).astype(np.float32)
        seen.extend(emb)
        vals = rng.integers(0, 1000, (b, 4)).astype(np.int32)
        lens = rng.integers(1, 5, (b,)).astype(np.int32)
        sid = np.arange(t * b, (t + 1) * b, dtype=np.int32)
        valid = np.ones(b, dtype=bool)
        if t % 2 == 1:
            valid[-3:] = False          # a padded batch
        positive = rng.random(b) < 0.8
        out.append((emb, vals, lens, sid, valid, positive))
    return out


def _result_fields(jres, tres):
    for name in ("hit", "index", "topk_index", "source_id", "values",
                 "value_lens", "near"):
        _assert_same(getattr(jres, name), getattr(tres, name), f"res.{name}")
    for name in ("score", "topk_score"):
        j = np.asarray(getattr(jres, name))
        t = getattr(tres, name).numpy()
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
def test_cache_peek_step_matches_jax(policy, key_dtype):
    jcfg, tcfg = _configs(key_dtype, dim=16, capacity=16, value_len=4,
                          ttl=None, threshold=0.8)
    jcache = JCache(jcfg, policy=JAdaptive() if policy == "adaptive" else None)
    tcache = SemanticCache(tcfg, policy=AdaptiveThreshold()
                           if policy == "adaptive" else None)
    jrt, trt = jcache.init(), tcache.init(CPU)
    rng = np.random.default_rng(11)
    for t, (emb, vals, lens, sid, valid, pos) in enumerate(
            _traffic(rng, 7, 8, 16)):
        now = float(t)
        jpeek, _ = jcache.lookup(jrt, jnp.asarray(emb), now,
                                 update_counters=False)
        tpeek, _ = tcache.lookup(trt, torch.from_numpy(emb), now,
                                 update_counters=False)
        _result_fields(jpeek, tpeek)
        thr = float(np.asarray(jrt.policy_state).reshape(-1)[0])
        score = np.asarray(jpeek.score)
        assert np.all(np.abs(score[np.isfinite(score)] - thr) > 1e-5)
        jres, jrt = jcache.step(
            jrt, jnp.asarray(emb), jnp.asarray(vals), jnp.asarray(lens), now,
            source_id=jnp.asarray(sid), peeked=jpeek,
            valid=jnp.asarray(valid))
        tres, trt = tcache.step(
            trt, torch.from_numpy(emb), torch.from_numpy(vals),
            torch.from_numpy(lens), now, source_id=torch.from_numpy(sid),
            peeked=tpeek, valid=torch.from_numpy(valid))
        _result_fields(jres, tres)
        hit = np.array(jres.hit)
        jrt = jcache.update_policy(jrt, was_positive=jnp.asarray(pos & hit),
                                   was_hit=jnp.asarray(hit))
        trt = tcache.update_policy(
            trt, was_positive=torch.from_numpy(pos & hit),
            was_hit=torch.from_numpy(hit))
        _assert_same_state(jrt.state, trt.state)
        for name in STATS_LEAVES:
            _assert_same(getattr(jrt.stats, name), getattr(trt.stats, name),
                         f"stats.{name}")
        np.testing.assert_allclose(trt.policy_state.numpy(),
                                   np.asarray(jrt.policy_state), rtol=0,
                                   atol=FLOAT_TOL)
    assert int(trt.stats.hits) > 0 and int(trt.stats.misses) > 0
    assert int(trt.state.n_inserts) > tcfg.capacity     # the ring wrapped


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
def test_fused_step_equals_lookup_then_insert(key_dtype):
    _, cfg = _configs(key_dtype, dim=16, capacity=40, value_len=4, ttl=30.0)
    cache = SemanticCache(cfg)
    fused, sep = cache.init(CPU), cache.init(CPU)
    rng = np.random.default_rng(5)
    for t, (emb, vals, lens, sid, _, _) in enumerate(_traffic(rng, 6, 8, 16)):
        q, v, vl, s = (torch.from_numpy(x) for x in (emb, vals, lens, sid))
        peek, _ = cache.lookup(fused, q, float(t), update_counters=False)
        fres, fused = cache.step(fused, q, v, vl, float(t), source_id=s,
                                 peeked=peek)
        sres, sep = cache.lookup(sep, q, float(t))
        miss = ~sres.hit
        sep = cache.insert(sep, q[miss], v[miss], vl[miss], float(t),
                           source_id=s[miss])
        for name in ("hit", "index", "topk_index", "score"):
            assert torch.equal(getattr(fres, name), getattr(sres, name))
        for name in STATE_LEAVES:
            a, b = getattr(fused.state, name), getattr(sep.state, name)
            if name == "inserted_at":
                # row offsets of 1e-6 count the whole batch on the fused
                # path and only the inserted rows on the separate one, as
                # in the JAX package
                torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
            else:
                assert torch.equal(a, b), name
        for name in STATS_LEAVES:
            assert int(getattr(fused.stats, name)) == \
                int(getattr(sep.stats, name)), name


def test_expire_counts_and_gather_topk():
    _, cfg = _configs("f32", dim=8, capacity=16, value_len=4, ttl=2.0)
    cache = SemanticCache(cfg)
    rt = cache.init(CPU)
    emb, vals, lens, sid = _batch(np.random.default_rng(3), 5, 8, 4)
    rt = cache.insert(rt, torch.from_numpy(emb), torch.from_numpy(vals),
                      torch.from_numpy(lens), 0.0,
                      source_id=torch.from_numpy(sid))
    res, _ = cache.lookup(rt, torch.from_numpy(emb[:2]), 1.0,
                          update_counters=False)
    payload = cache.gather_topk(rt, res)
    assert payload["source_id"][:, 0].tolist() == sid[:2].tolist()
    assert bool(torch.all(payload["value_lens"][:, 0] > 0))
    rt = cache.expire(rt, 2.0)
    assert int(rt.stats.expired_evictions) == 5
    res, _ = cache.lookup(rt, torch.from_numpy(emb[:2]), 2.0)
    assert res.index.tolist() == [0, 0] and not bool(res.hit.any())
    assert bool(torch.all(res.topk_index == -1))
    payload = cache.gather_topk(rt, res)
    assert bool(torch.all(payload["source_id"] == -1))
    assert bool(torch.all(torch.isneginf(payload["score"])))


def test_similarity_helpers_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    x[3] = 0.0                                   # zero rows stay zero
    keys = rng.standard_normal((20, 16)).astype(np.float32)
    alive = rng.random(20) < 0.6
    starts = np.array([0, 4, 10, 19, 7], np.int32)
    sizes = np.array([5, 0, 10, 1, 20], np.int32)
    _assert_same(jsim.l2_normalize(jnp.asarray(x)),
                 tsim.l2_normalize(torch.from_numpy(x)), "l2_normalize")
    _assert_same(jsim.interval_visibility(jnp.asarray(alive),
                                          jnp.asarray(starts),
                                          jnp.asarray(sizes)),
                 tsim.interval_visibility(torch.from_numpy(alive),
                                          torch.from_numpy(starts),
                                          torch.from_numpy(sizes)),
                 "interval_visibility")
    js = np.asarray(jsim.cosine_scores(jnp.asarray(x), jnp.asarray(keys),
                                       jnp.asarray(alive)))
    ts = tsim.cosine_scores(torch.from_numpy(x), torch.from_numpy(keys),
                            torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(np.isneginf(ts), np.isneginf(js))
    np.testing.assert_allclose(ts[np.isfinite(js)], js[np.isfinite(js)],
                               rtol=0, atol=1e-6)
