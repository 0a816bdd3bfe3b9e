"""The port's tenancy slice against the JAX package's, on the CPU: the
registry's partition math, per-tenant ring slot selection, a partitioned
SemanticCache over scripted multi-batch traffic (fused and separate paths,
f32 and int8 slabs), isolation at cosine 1.0, the multi-tenant workload,
the engine at ``benchmarks/paper_tables.py::tenant_table``'s quick
configuration, and tenant snapshots loaded across the two packages. The
interval and dense-mask kernels' plain versions are held against the JAX
package in ``test_torch_kernels.py``; the CUDA kernels run on the card in
``test_torch_cuda.py``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import store as jstore
from repro.core.cache import SemanticCache as JCache
from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro.serving import build_multi_tenant_workload as jbuild_workload
from repro.serving import tenant_rng as jtenant_rng
from repro.serving import zipf_weights as jzipf_weights
from repro.tenancy import TenantRegistry as JRegistry
from repro.tenancy import TenantSpec as JSpec
from repro_torch.core import store as tstore
from repro_torch.core.cache import SemanticCache
from repro_torch.core.types import CacheConfig
from repro_torch.data.qa_dataset import build_corpus as tbuild_corpus
from repro_torch.launch import serve
from repro_torch.serving import CachedEngine, Request, SimulatedLLMBackend
from repro_torch.serving.loadgen import (build_multi_tenant_workload,
                                         tenant_rng, zipf_weights)
from repro_torch.tenancy import (NO_OVERRIDE, PartitionMap, TenancyState,
                                 TenantRegistry, TenantSpec)
from test_torch_store_cache import (DTYPES, STATS_LEAVES, _assert_same,
                                    _assert_same_state, _configs,
                                    _result_fields, _traffic)

CPU = torch.device("cpu")
TENANCY_LEAVES = [f.name for f in dataclasses.fields(TenancyState)]
SCORE_TOL = 1e-5

SPEC_SETS = {
    "share": [dict(name="a", share=2.0), dict(name="b", share=1.0),
              dict(name="c", share=3.0)],
    "quota": [dict(name="a", share=1.0), dict(name="b", quota=100),
              dict(name="c", share=2.0, quota=7)],
    "threshold": [dict(name="lax"), dict(name="strict", threshold=0.99),
                  dict(name="mid", threshold=0.85, weight=3.0)],
    "band_lo": [dict(name="a", band_lo=0.6),
                dict(name="b", threshold=0.9, band_lo=0.7),
                dict(name="c")],
    "tiny": [dict(name=f"t{i}", share=1.0 + i) for i in range(7)],
}


def _registries(specs):
    return (JRegistry(tuple(JSpec(**s) for s in specs)),
            TenantRegistry(tuple(TenantSpec(**s) for s in specs)))


def _tenancy_same(jt, tt):
    for name in TENANCY_LEAVES:
        _assert_same(getattr(jt, name), getattr(tt, name), f"tenancy.{name}")


@pytest.mark.parametrize("capacity", [9, 1000, 65536])
@pytest.mark.parametrize("kind", sorted(SPEC_SETS))
def test_partition_matches_jax(kind, capacity):
    jreg, treg = _registries(SPEC_SETS[kind])
    if capacity < len(treg):
        with pytest.raises(ValueError):
            jreg.partition(capacity)
        with pytest.raises(ValueError):
            treg.partition(capacity)
        return
    jp, tp = jreg.partition(capacity), treg.partition(capacity)
    for field in ("names", "starts", "sizes", "thresholds", "band_lo",
                  "capacity"):
        assert getattr(tp, field) == getattr(jp, field), field
    assert tp.manifest() == jp.manifest()
    np.testing.assert_array_equal(tp.slot_owner(), jp.slot_owner())
    assert treg.weights() == jreg.weights()
    for name in tp.names:
        assert tp.region(name) == jp.region(name)
    _assert_same(jp.starts_array(), tp.starts_array(CPU), "starts")
    _assert_same(jp.thresholds_array(), tp.thresholds_array(CPU), "thr")


def test_registry_and_partition_validation():
    with pytest.raises(ValueError):
        TenantRegistry((TenantSpec("a"), TenantSpec("a")))
    for bad in (dict(share=0.0), dict(quota=0), dict(threshold=1.5),
                dict(band_lo=0.9, threshold=0.8), dict(name="")):
        with pytest.raises(ValueError):
            TenantSpec(**{"name": "x", **bad})
    with pytest.raises(ValueError):
        PartitionMap(names=("a",), starts=(1,), sizes=(3,),
                     thresholds=(NO_OVERRIDE,), capacity=4)
    with pytest.raises(KeyError, match="unknown tenant"):
        TenantRegistry.uniform(["a"]).index("b")
    part = TenantRegistry.uniform(["a", "b"]).partition(64)
    cfg = CacheConfig(dim=8, capacity=64)
    with pytest.raises(ValueError, match="ring"):
        SemanticCache(dataclasses.replace(cfg, eviction="lru"),
                      partition=part)
    with pytest.raises(ValueError, match="capacity"):
        SemanticCache(dataclasses.replace(cfg, capacity=65), partition=part)
    state = TenancyState.zeros(2, CPU)
    assert state.num_tenants == 2 and state.reduced() is state
    stacked = TenancyState(*(torch.ones((3, 2), dtype=torch.int32)
                             for _ in TENANCY_LEAVES))
    assert stacked.reduced().hits.tolist() == [3, 3]


def test_select_slots_tenant_matches_jax():
    jreg, treg = _registries(SPEC_SETS["quota"])
    jp, tp = jreg.partition(160), treg.partition(160)
    rng = np.random.default_rng(4)
    jptr = jnp.zeros((3,), jnp.int32)
    tptr = torch.zeros(3, dtype=torch.int32)
    for _ in range(12):
        b = int(rng.integers(1, 8))
        tid = rng.integers(0, 3, b).astype(np.int32)
        mask = rng.random(b) < 0.6
        jslots, jptr = jstore.select_slots_tenant(
            jp, jptr, jnp.asarray(tid), jnp.asarray(mask))
        tslots, tptr = tstore.select_slots_tenant(
            tp, tptr, torch.from_numpy(tid), torch.from_numpy(mask))
        _assert_same(jslots, tslots, "slots")
        _assert_same(jptr, tptr, "ptr")
        owner = tp.slot_owner()
        assert (owner[tslots.numpy()] == tid).all()
        assert len(set(tslots.tolist())) == b
    assert int(tptr.sum()) > 0


def _tenant_caches(key_dtype, capacity=64):
    jcfg, tcfg = _configs(key_dtype, dim=16, capacity=capacity, value_len=4,
                          ttl=None, threshold=0.8)
    jreg, treg = _registries([dict(name="a"), dict(name="b", share=2.0),
                              dict(name="c", threshold=0.995)])
    return (JCache(jcfg, partition=jreg.partition(capacity)),
            SemanticCache(tcfg, partition=treg.partition(capacity)))


def _same_runtime(jrt, trt):
    _assert_same_state(jrt.state, trt.state)
    for name in STATS_LEAVES:
        _assert_same(getattr(jrt.stats, name), getattr(trt.stats, name),
                     f"stats.{name}")
    _tenancy_same(jrt.tenancy, trt.tenancy)


@pytest.mark.parametrize("key_dtype", ["f32", "int8"])
@pytest.mark.parametrize("path", ["fused", "separate"])
def test_partitioned_cache_matches_jax(path, key_dtype):
    """Scripted traffic of exact repeats (cosine 1 across tenants too),
    paraphrases and fresh rows over three tenants, one with a 0.995
    threshold override; the rings wrap. Every result field, slab leaf,
    counter and TenancyState leaf equals the JAX package's."""
    jcache, tcache = _tenant_caches(key_dtype)
    jrt, trt = jcache.init(), tcache.init(CPU)
    assert trt.tenancy.num_tenants == 3
    rng = np.random.default_rng(13)
    for t, (emb, vals, lens, sid, valid, _) in enumerate(
            _traffic(rng, 9, 8, 16)):
        now = float(t)
        tid = rng.integers(0, 3, 8).astype(np.int32)
        jq, tq = jnp.asarray(emb), torch.from_numpy(emb)
        jt, tt = jnp.asarray(tid), torch.from_numpy(tid)
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
                jrt = jcache.insert(
                    jrt, jq[miss], jnp.asarray(vals[miss]),
                    jnp.asarray(lens[miss]), now,
                    source_id=jnp.asarray(sid[miss]), tenant_id=jt[miss])
                m = torch.from_numpy(miss)
                trt = tcache.insert(
                    trt, tq[m], torch.from_numpy(vals[miss]),
                    torch.from_numpy(lens[miss]), now,
                    source_id=torch.from_numpy(sid[miss]), tenant_id=tt[m])
        _result_fields(jres, tres)
        score = np.asarray(jres.score)
        finite = score[np.isfinite(score)]
        for thr in (0.8, 0.995):
            assert np.all(np.abs(finite - thr) > SCORE_TOL)
        _same_runtime(jrt, trt)
    tn = trt.tenancy
    assert int(tn.hits.sum()) > 0 and int(tn.evictions.sum()) > 0
    assert int(tn.lookups.sum()) == int(trt.stats.lookups)


def test_identical_query_of_another_tenant_misses_at_cosine_one():
    """Isolation: a cosine-1.0 duplicate in another tenant's region is
    invisible (score -inf, slot -1), not merely sub-threshold."""
    jcache, tcache = _tenant_caches("f32")
    jrt, trt = jcache.init(), tcache.init(CPU)
    emb = np.random.default_rng(0).standard_normal((8, 16)).astype(
        np.float32)
    vals, lens = np.ones((8, 4), np.int32), np.full(8, 4, np.int32)
    ta, tb = np.zeros(8, np.int32), np.ones(8, np.int32)
    jrt = jcache.insert(jrt, jnp.asarray(emb), jnp.asarray(vals),
                        jnp.asarray(lens), 0.0, tenant_id=jnp.asarray(ta))
    trt = tcache.insert(trt, torch.from_numpy(emb), torch.from_numpy(vals),
                        torch.from_numpy(lens), 0.0,
                        tenant_id=torch.from_numpy(ta))
    for tid, hits in ((ta, True), (tb, False)):
        jres, jrt = jcache.lookup(jrt, jnp.asarray(emb), 1.0,
                                  tenant_id=jnp.asarray(tid))
        tres, trt = tcache.lookup(trt, torch.from_numpy(emb), 1.0,
                                  tenant_id=torch.from_numpy(tid))
        _result_fields(jres, tres)
        assert bool(tres.hit.all()) is hits
        if hits:
            np.testing.assert_allclose(tres.score.numpy(), 1.0, atol=1e-5)
        else:
            assert bool(torch.all(torch.isneginf(tres.score)))
            assert bool(torch.all(tres.topk_index == -1))
    _same_runtime(jrt, trt)
    assert trt.tenancy.lookups.tolist() == [8, 8, 0]
    assert trt.tenancy.hits.tolist() == [8, 0, 0]
    with pytest.raises(ValueError, match="tenant_id"):
        tcache.lookup(trt, torch.from_numpy(emb), 1.0)
    with pytest.raises(ValueError, match="tenant_id"):
        tcache.insert(trt, torch.from_numpy(emb), torch.from_numpy(vals),
                      torch.from_numpy(lens), 1.0)


def test_multi_tenant_workload_matches_jax():
    pairs = build_corpus(40, seed=0)
    tpairs = tbuild_corpus(40, seed=0)
    assert jtenant_rng(3, "a").random() == tenant_rng(3, "a").random()
    assert jzipf_weights(4, 1.2) == zipf_weights(4, 1.2)
    kw = dict(tenants=["x", "y", "z"], skew=1.2, burst_prob=0.2, seed=5)
    jw = jbuild_workload(pairs, 90, **kw)
    tw = build_multi_tenant_workload(tpairs, 90, **kw)
    fields = ("query", "category", "source_id", "semantic_key", "tenant")
    assert [tuple(getattr(r, f) for f in fields) for r in tw] == \
        [tuple(getattr(r, f) for f in fields) for r in jw]
    assert {r.tenant for r in tw} == {"x", "y", "z"}
    # a tenant's own sequence ignores which other tenants exist
    only_x = build_multi_tenant_workload(tpairs, 90, tenants=["x"], seed=5,
                                         skew=1.2, burst_prob=0.2)
    xs = [r.query for r in tw if r.tenant == "x"]
    assert xs == [r.query for r in only_x][:len(xs)]


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
TENANT_TABLE_SPECS = [dict(name="free", share=1.0, weight=1.0),
                      dict(name="pro", share=2.0, weight=2.0),
                      dict(name="enterprise", share=2.0, weight=4.0,
                           threshold=0.85)]


def _judge(pairs):
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    return judge


def _tenant_engines(n, specs, *, batch, capacity, fused=True,
                    key_dtype="f32"):
    pairs = build_corpus(n, seed=0)
    jreg, treg = _registries(specs)
    kw = dict(dim=384, capacity=capacity, value_len=48, ttl=None,
              threshold=0.8)
    jd, td = DTYPES[key_dtype]
    jeng = JEngine(JConfig(key_dtype=jd, **kw), JBackend(pairs),
                   judge=_judge(pairs), batch_size=batch, registry=jreg,
                   use_fused_step=fused)
    teng = CachedEngine(CacheConfig(key_dtype=td, **kw),
                        SimulatedLLMBackend(pairs), judge=_judge(pairs),
                        batch_size=batch, registry=treg,
                        use_fused_step=fused, device="cpu")
    return pairs, jeng, teng


def _to_torch_requests(jreqs):
    return [Request(query=r.query, category=r.category,
                    source_id=r.source_id, semantic_key=r.semantic_key,
                    tenant=r.tenant) for r in jreqs]


def _untimed(summary):
    """A metrics summary without its wall-clock fields (the sample counts
    stay)."""
    out = {k: v for k, v in summary.items()
           if k not in ("avg_latency_with_cache_s", "latency_percentiles",
                        "tenants")}
    out["tenants"] = {
        name: {**{k: v for k, v in t.items() if k != "latency_percentiles"},
               "latency_counts": {p: r["count"] for p, r in
                                  t["latency_percentiles"].items()}}
        for name, t in summary["tenants"].items()}
    return out


def _same_responses(jresp, tresp):
    assert len(jresp) == len(tresp)
    for i, (j, t) in enumerate(zip(jresp, tresp)):
        assert (t.answer, t.cached) == (j.answer, j.cached), i
        assert t.score == j.score or abs(t.score - j.score) <= SCORE_TOL, \
            (i, t.score, j.score)


def test_tenant_table_quick_config_matches_jax():
    """``paper_tables.tenant_table(full=False)``: free / pro / enterprise
    (threshold 0.85), 250 pairs per category, 240 Zipf-skewed requests,
    batch 64. Request by request, per tenant and on the device counters
    the port equals the JAX engine."""
    n, nq = 250, 240
    pairs, jeng, teng = _tenant_engines(n, TENANT_TABLE_SPECS, batch=64,
                                        capacity=8 * n * 3)
    for eng in (jeng, teng):
        for name in eng.registry.names:
            eng.warm(pairs, tenant=name)
    jreq = jbuild_workload(pairs, nq, tenants=list(jeng.registry.names),
                           skew=1.2, seed=2)
    treq = _to_torch_requests(jreq)
    _same_responses(jeng.process(jreq), teng.process(treq))
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    assert _untimed(ts) == _untimed(js)
    assert teng.tenant_stats() == jeng.tenant_stats()
    _tenancy_same(jeng.runtime.tenancy, teng.runtime.tenancy)
    rates = {t: round(r["hit_rate"], 3) for t, r in ts["tenants"].items()}
    assert rates == {"free": 0.507, "pro": 0.552, "enterprise": 0.474}
    dev = teng.tenant_stats()
    for name, row in ts["tenants"].items():
        assert (row["lookups"], row["cache_hits"]) == \
            (dev[name]["lookups"], dev[name]["hits"])


@pytest.mark.parametrize("key_dtype,fused", [("f32", False), ("int8", True),
                                             ("int8", False)])
def test_engine_paths_match_jax_with_tenants(key_dtype, fused):
    """Fused and separate paths, f32 and int8 slabs, regions small enough
    that the rings wrap while warming and serving, padded last batch."""
    pairs, jeng, teng = _tenant_engines(
        40, [dict(name="a"), dict(name="b", threshold=0.85)], batch=16,
        capacity=96, fused=fused, key_dtype=key_dtype)
    for eng in (jeng, teng):
        eng.warm(pairs[:60], tenant="a")
        eng.warm(pairs[60:90], tenant="b")
    jreq = jbuild_workload(pairs, 75, tenants=["a", "b"], skew=0.5, seed=3)
    _same_responses(jeng.process(jreq), teng.process(_to_torch_requests(jreq)))
    assert _untimed(teng.metrics.summary()) == _untimed(jeng.metrics.summary())
    assert teng.tenant_stats() == jeng.tenant_stats()
    _same_runtime(jeng.runtime, teng.runtime)
    assert sum(r["evictions"] for r in teng.tenant_stats().values()) > 0


def test_fused_and_separate_paths_agree_with_tenants():
    pairs = build_corpus(80, seed=0)
    reqs = _to_torch_requests(jbuild_workload(pairs, 48, tenants=["a", "b"],
                                              skew=0.5, seed=3))
    results = {}
    for fused in (True, False):
        _, _, eng = _tenant_engines(80, [dict(name="a"), dict(name="b")],
                                    batch=16, capacity=4096, fused=fused)
        for t in ("a", "b"):
            eng.warm(pairs[:40], tenant=t)
        resp = eng.process(reqs)
        results[fused] = ([(r.answer, r.cached, round(r.score, 5))
                           for r in resp], eng.tenant_stats())
    assert results[True] == results[False]


def test_engine_tenancy_guards():
    pairs = build_corpus(20, seed=0)
    small = TenantRegistry((TenantSpec("tiny", quota=4), TenantSpec("rest")))
    cfg = CacheConfig(dim=384, capacity=4096, value_len=48, ttl=None)
    with pytest.raises(ValueError, match="region"):
        CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=16,
                     registry=small, device="cpu")
    eng = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                       registry=TenantRegistry.uniform(["a", "b"]),
                       device="cpu")
    with pytest.raises(ValueError, match="max_batch"):
        eng.serve_batch([Request(query=f"q{i}", tenant="a")
                         for i in range(9)])
    with pytest.raises(KeyError, match="unknown tenant"):
        eng.process([Request(query="who", tenant="nobody")])
    with pytest.raises(KeyError, match="unknown tenant"):
        eng.warm(pairs, tenant="nobody")
    single = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                          device="cpu")
    assert single.tenant_stats() == {} and single.runtime.tenancy is None
    with pytest.raises(ValueError, match="registry"):
        single.warm(pairs, tenant="a")
    # single-tenant engines keep taking oversized batches
    assert len(single.serve_batch([Request(query=f"q{i}")
                                   for i in range(9)])) == 9


def test_padded_mixed_batch_counts_only_real_rows():
    pairs = build_corpus(20, seed=0)
    cfg = CacheConfig(dim=384, capacity=4096, value_len=48, ttl=None)
    eng = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                       registry=TenantRegistry.uniform(["a", "b"]),
                       device="cpu")
    texts = ["why is the sky blue at noon",
             "best sourdough starter feeding schedule",
             "how tall is mount kilimanjaro",
             "difference between alligators and crocodiles",
             "what causes aurora borealis displays",
             "recommend a jazz album from 1959",
             "do tides depend on the moon",
             "boiling point of ethanol at altitude",
             "who invented the mechanical clock",
             "explain photosynthesis light reactions",
             "how many strings does a cello have"]
    reqs = [Request(query=q, category="python_basics", tenant="ab"[i % 2])
            for i, q in enumerate(texts)]
    assert len(eng.process(reqs)) == 11
    s, dev = eng.metrics.summary(), eng.tenant_stats()
    assert s["queries"] == 11 and "__pad__" not in s["categories"]
    assert (dev["a"]["lookups"], dev["b"]["lookups"]) == (6, 5)
    assert (dev["a"]["inserts"], dev["b"]["inserts"]) == (6, 5)
    assert int(eng.state.valid.sum()) == 11
    assert all(r.cached for r in eng.process(reqs))
    dev = eng.tenant_stats()
    assert (dev["a"]["hits"], dev["b"]["hits"]) == (6, 5)


# --------------------------------------------------------------------- #
# snapshots across the two packages
# --------------------------------------------------------------------- #
def test_tenant_snapshots_load_across_packages(tmp_path):
    specs = [dict(name="a", share=2.0), dict(name="b", threshold=0.9)]
    pairs, jeng, teng = _tenant_engines(40, specs, batch=8, capacity=512)
    jreq = jbuild_workload(pairs, 40, tenants=["a", "b"], skew=0.3, seed=9)
    treq = _to_torch_requests(jreq)
    for eng in (jeng, teng):
        eng.warm(pairs[:30], tenant="a")
    half = len(jreq) // 2
    _same_responses(jeng.process(jreq[:half]), teng.process(treq[:half]))
    jeng.save_cache(str(tmp_path / "jax.npz"))
    teng.save_cache(str(tmp_path / "torch.npz"))
    _, jeng2, teng2 = _tenant_engines(40, specs, batch=8, capacity=512)
    teng2.load_cache(str(tmp_path / "jax.npz"))
    jeng2.load_cache(str(tmp_path / "torch.npz"))
    for eng in (jeng2, teng2):
        eng.tokenizer.encode_batch([p.answer for p in pairs], 48)
    assert teng2.tenant_stats() == jeng.tenant_stats()
    assert jeng2.tenant_stats() == teng.tenant_stats()
    rest = [eng.process(reqs[half:]) for eng, reqs in
            ((jeng, jreq), (teng, treq), (jeng2, jreq), (teng2, treq))]
    for other in rest[1:]:
        _same_responses(rest[0], other)
    _tenancy_same(jeng.runtime.tenancy, teng2.runtime.tenancy)
    _tenancy_same(jeng2.runtime.tenancy, teng.runtime.tenancy)
    # a snapshot taken under another tenant layout is refused, both ways
    other = [dict(name="a", share=3.0), dict(name="b", threshold=0.9)]
    _, jeng3, teng3 = _tenant_engines(40, other, batch=8, capacity=512)
    for eng, path in ((teng3, "jax.npz"), (teng3, "torch.npz"),
                      (jeng3, "torch.npz")):
        with pytest.raises(ValueError, match="partition"):
            eng.load_cache(str(tmp_path / path))
    single = CachedEngine(CacheConfig(dim=384, capacity=512, value_len=48,
                                      ttl=None), SimulatedLLMBackend(pairs),
                          batch_size=8, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        single.load_cache(str(tmp_path / "jax.npz"))


def test_serve_driver_tenants_on_cpu():
    eng, reqs, resp = serve.run(device="cpu", corpus=20, queries=5, batch=8,
                                tenants=3, log=lambda *a: None)
    assert len(resp) == len(reqs) == 20
    assert eng.cache.config.capacity == 16384 * 3
    stats = eng.tenant_stats()
    assert sorted(stats) == ["tenant-0", "tenant-1", "tenant-2"]
    assert sum(r["lookups"] for r in stats.values()) == 20
    assert all(r["region_slots"] == 16384 for r in stats.values())
