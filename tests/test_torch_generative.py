"""Near-hit bands in the port against the JAX package, on the CPU:
``BandPolicy`` (edges exactly at τ_lo and τ_hi, ``update_band`` over 20
seeded batches), the synthesizers, the per-tenant ``band_lo`` and τ_hi
overrides in ``SemanticCache``, and the engine at
``paper_tables.near_hit_table``'s quick configuration request by request,
band on and off, fused and separate."""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cache import SemanticCache as JCache
from repro.core.types import CacheConfig as JConfig
from repro.core.types import LookupResult as JLookupResult
from repro.data.qa_dataset import build_corpus, build_test_queries
from repro.generative import BandPolicy as JBand
from repro.generative import Neighbour as JNeighbour
from repro.generative import SmallModelRewrite as JSmallModelRewrite
from repro.generative import TemplateSplice as JSplice
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro.tenancy import TenantRegistry as JRegistry
from repro.tenancy import TenantSpec as JSpec
from repro_torch.core.cache import SemanticCache
from repro_torch.core.types import CacheConfig, LookupResult
from repro_torch.generative import (BandPolicy, Neighbour, SmallModelRewrite,
                                    SmallRewriteBackend, Synthesis,
                                    TemplateSplice, rewrite_prompt)
from repro_torch.serving import CachedEngine, Request, SimulatedLLMBackend
from repro_torch.tenancy import TenantRegistry, TenantSpec

SCORE_TOL = 1e-5
TIMING_KEYS = ("avg_latency_with_cache_s", "latency_percentiles")
STATS = ("lookups", "hits", "misses", "expired_evictions", "inserts")
EDGE_SCORES = [np.float32(0.7), np.float32(0.8), 0.6999, 0.7999, 0.85,
               np.nextafter(np.float32(0.7), np.float32(0)),
               np.nextafter(np.float32(0.8), np.float32(0)), -np.inf]


def _peeked(scores, k=4):
    """Hand-built lookup results (port, JAX) with exact score bits."""
    s = np.asarray(scores, dtype=np.float32)
    b = len(s)
    port = LookupResult(
        index=torch.zeros(b, dtype=torch.int32), score=torch.from_numpy(s),
        hit=torch.zeros(b, dtype=torch.bool),
        values=torch.zeros((b, 8), dtype=torch.int32),
        value_lens=torch.zeros(b, dtype=torch.int32),
        source_id=torch.full((b,), -1, dtype=torch.int32),
        topk_index=torch.full((b, k), -1, dtype=torch.int32),
        topk_score=torch.full((b, k), float("-inf")),
        near=torch.zeros(b, dtype=torch.bool))
    ref = JLookupResult(
        index=jnp.zeros((b,), jnp.int32), score=jnp.asarray(s),
        hit=jnp.zeros((b,), bool), values=jnp.zeros((b, 8), jnp.int32),
        value_lens=jnp.zeros((b,), jnp.int32),
        source_id=jnp.full((b,), -1, jnp.int32),
        topk_index=jnp.full((b, k), -1, jnp.int32),
        topk_score=jnp.full((b, k), -jnp.inf, jnp.float32),
        near=jnp.zeros((b,), bool))
    return port, ref


# --------------------------------------------------------------------- #
# BandPolicy

@pytest.mark.parametrize("lo,hi", [(0.7, 0.8), (0.75, 0.8), (0.8, 0.8),
                                   (0.6, 0.9)])
def test_band_edges_match_jax(lo, hi):
    """τ_lo inclusive, τ_hi exclusive; ``decide`` is FixedThreshold(τ_hi)."""
    pol, jpol = BandPolicy(tau_lo=lo, tau_hi=hi), JBand(tau_lo=lo, tau_hi=hi)
    st, jst = pol.init_state(torch.device("cpu")), jpol.init_state()
    assert st.tolist() == np.asarray(jst).tolist()
    s = np.asarray(EDGE_SCORES + [lo, hi], dtype=np.float32)
    hit, _ = pol.decide(torch.from_numpy(s), st)
    jhit, _ = jpol.decide(jnp.asarray(s), jst)
    assert hit.tolist() == np.asarray(jhit).tolist()
    near = pol.near(torch.from_numpy(s), st)
    assert near.tolist() == np.asarray(jpol.near(jnp.asarray(s),
                                                 jst)).tolist()
    assert bool(near[-2]) == (lo < hi) and not bool(near[-1])
    assert bool(hit[-1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_band_matches_jax_over_20_batches(seed):
    pol = BandPolicy(tau_lo=0.72, tau_hi=0.8, lr=0.05)
    jpol = JBand(tau_lo=0.72, tau_hi=0.8, lr=0.05)
    st, jst = pol.init_state(torch.device("cpu")), jpol.init_state()
    rng = np.random.default_rng(seed)
    for step in range(20):
        near = rng.random(32) < [0.0, 0.3, 0.8][step % 3]
        pos = rng.random(32) < rng.choice([0.2, 0.9, 1.0])
        st = pol.update_band(st, was_positive=torch.from_numpy(pos),
                             was_near=torch.from_numpy(near))
        jst = jpol.update_band(jst, was_positive=jnp.asarray(pos),
                               was_near=jnp.asarray(near))
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=0,
                                   atol=1e-7)
    lo = float(st[0])
    assert jpol.lo_min <= lo <= 0.8 - jpol.min_width + 1e-7
    assert pol.update(st, was_positive=None, was_hit=None) is st


@pytest.mark.parametrize("kw", [
    dict(tau_lo=0.9, tau_hi=0.8), dict(tau_lo=-0.1), dict(tau_hi=1.1),
    dict(tau_lo=0.5), dict(degraded_lo=0.75), dict(degraded_lo=1.5)])
def test_band_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JBand(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        BandPolicy(**kw)


# --------------------------------------------------------------------- #
# the cache's band edges and tenant overrides

def _caches(partition_specs=None, **cfg_kw):
    kw = dict(dim=16, capacity=64, value_len=8, threshold=0.8) | cfg_kw
    port_part = jax_part = None
    if partition_specs is not None:
        port_part = TenantRegistry(tuple(TenantSpec(**s) for s in
                                         partition_specs)).partition(64)
        jax_part = JRegistry(tuple(JSpec(**s) for s in
                                   partition_specs)).partition(64)
    return (SemanticCache(CacheConfig(**kw),
                          policy=BandPolicy(tau_lo=0.7, tau_hi=0.8),
                          partition=port_part),
            JCache(JConfig(**kw), policy=JBand(tau_lo=0.7, tau_hi=0.8),
                   partition=jax_part))


@pytest.mark.parametrize("specs,scores", [
    (None, EDGE_SCORES),
    # a tenant lowers τ_lo: 0.65 and exactly 0.6 are in its band only
    ([dict(name="strict"), dict(name="loose", band_lo=0.6)],
     [0.65, 0.65, 0.6, 0.6, 0.59, 0.59]),
    # a stricter τ_hi: 0.85 hits for one tenant, is out of band for the
    # other (the global band stays [0.7, 0.8))
    ([dict(name="default"), dict(name="strict", threshold=0.9)],
     [0.85, 0.85, 0.75, 0.75, 0.9, 0.9]),
    # ... unless it also lowers band_lo below its own τ_hi
    ([dict(name="default"), dict(name="strict", threshold=0.9,
                                 band_lo=0.7)],
     [0.85, 0.85, 0.7, 0.7, 0.9, 0.9, 0.6999, 0.6999]),
])
def test_commit_band_masks_match_jax(specs, scores):
    cache, jcache = _caches(specs)
    peek, jpeek = _peeked(scores)
    tid = jtid = None
    if specs is not None:
        ids = np.arange(len(scores), dtype=np.int32) % 2
        tid, jtid = torch.from_numpy(ids), jnp.asarray(ids)
    res, _ = cache.commit(cache.init("cpu"), peek, 0.0, tenant_id=tid)
    jres, _ = jcache.commit(jcache.init(), jpeek, 0.0, tenant_id=jtid)
    assert res.near.tolist() == np.asarray(jres.near).tolist()
    assert res.hit.tolist() == np.asarray(jres.hit).tolist()
    assert not bool((res.near & res.hit).any())


def test_bandless_policy_near_all_false():
    cache = SemanticCache(CacheConfig(dim=16, capacity=32, value_len=8))
    peek, _ = _peeked([0.75, 0.9, 0.1])
    res, rt = cache.commit(cache.init("cpu"), peek, 0.0)
    assert not bool(res.near.any())
    assert cache.update_band(rt, was_positive=res.hit,
                             was_near=res.near) is rt


def test_partition_band_lo_array_matches_jax():
    specs = [dict(name="a"), dict(name="b", band_lo=0.6),
             dict(name="c", threshold=0.9, band_lo=0.7)]
    part = TenantRegistry(tuple(TenantSpec(**s) for s in specs)).partition(96)
    jpart = JRegistry(tuple(JSpec(**s) for s in specs)).partition(96)
    assert part.band_lo_array("cpu").tolist() == \
        np.asarray(jpart.band_lo_array()).tolist()
    assert part.band_lo_array("cpu").dtype == torch.float32
    assert part.manifest() == jpart.manifest()


# --------------------------------------------------------------------- #
# synthesizers

def _nbs(rows):
    return ([Neighbour(*r) for r in rows], [JNeighbour(*r) for r in rows])


@pytest.mark.parametrize("rows", [
    [],
    [(3, 0.78, 7, "a")],                                  # lone neighbour
    [(3, 0.78, 7, "a"), (4, 0.70, 9, "b")],               # rival trails
    [(3, 0.78, 7, "a"), (4, 0.74, 9, "b")],               # rival too close
    [(3, 0.78, 7, "a"), (4, 0.77, 7, "a2")],              # same provenance
    [(3, 0.78, -1, "a"), (4, 0.77, -1, "b")],             # unknown: rivals
    [(4, 0.71, 9, "b"), (3, 0.79, 7, "a"), (5, 0.60, 2, "c")],
])
@pytest.mark.parametrize("margin", [0.12, 0.02])
def test_template_splice_matches_jax(rows, margin):
    nbs, jnbs = _nbs(rows)
    got = TemplateSplice(rival_margin=margin).synthesize("q", nbs)
    want = JSplice(rival_margin=margin).synthesize("q", jnbs)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_small_model_rewrite_matches_jax():
    nbs, jnbs = _nbs([(3, 0.78, 7, "the cached answer"),
                      (4, 0.60, 9, "other")])
    syn = SmallModelRewrite().synthesize("new phrasing", nbs)
    jsyn = JSmallModelRewrite().synthesize("new phrasing", jnbs)
    assert dataclasses.astuple(syn) == dataclasses.astuple(jsyn)
    assert syn.answer == "the cached answer" and syn.cost_usd > 0
    backend = SmallRewriteBackend(latency_per_call_s=0.5,
                                  cost_per_call_usd=0.01)
    res = backend.generate([rewrite_prompt("q", "ans"), "no sentinel"])
    assert res.answers == ["ans", "no sentinel"] and backend.calls == 2
    assert (res.latency_s, res.cost_usd) == (1.0, 0.02)
    assert SmallModelRewrite().synthesize("q", []) is None
    assert isinstance(syn, Synthesis)


# --------------------------------------------------------------------- #
# the engine

def _near_config(fused=True, band=True, n=100):
    """``paper_tables.near_hit_table``'s quick configuration for both
    packages: n pairs a category, 60 paraphrase-heavy queries a category,
    batch 32, 8n slots; band on = BandPolicy(0.75, 0.8) with
    TemplateSplice(0.12)."""
    pairs = build_corpus(n, seed=0)
    queries = build_test_queries(pairs, n_per_category=60,
                                 paraphrase_ratio=0.8, seed=1)
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key

    kw = dict(dim=384, capacity=8 * n, value_len=48, ttl=None,
              threshold=0.8)
    syn = pol = jsyn = jpol = None
    if band:
        syn, pol = TemplateSplice(rival_margin=0.12), \
            BandPolicy(tau_lo=0.75, tau_hi=0.8)
        jsyn, jpol = JSplice(rival_margin=0.12), \
            JBand(tau_lo=0.75, tau_hi=0.8)
    eng = CachedEngine(CacheConfig(**kw), SimulatedLLMBackend(pairs),
                       judge=judge, batch_size=32, synthesizer=syn,
                       policy=pol, use_fused_step=fused, device="cpu")
    jeng = JEngine(JConfig(**kw), JBackend(pairs), judge=judge,
                   batch_size=32, synthesizer=jsyn, policy=jpol,
                   use_fused_step=fused)
    eng.warm(pairs)
    jeng.warm(pairs)
    fields = ("query", "category", "source_id", "semantic_key")
    reqs = [Request(**{f: getattr(q, f) for f in fields}) for q in queries]
    jreqs = [JRequest(**{f: getattr(q, f) for f in fields})
             for q in queries]
    return eng, jeng, reqs, jreqs


def _same(resp, jresp):
    assert len(resp) == len(jresp)
    for i, (t, j) in enumerate(zip(resp, jresp)):
        assert (t.answer, t.cached, t.near_hit, t.context, t.degraded,
                t.error) == (j.answer, j.cached, j.near_hit, j.context,
                             j.degraded, j.error), i
        assert abs(t.score - j.score) <= SCORE_TOL, (i, t.score, j.score)


@pytest.mark.parametrize("fused,band", [(True, True), (True, False),
                                        (False, True)])
def test_near_hit_table_quick_config_matches_jax(fused, band):
    """The ``near/*`` rows, request by request: BENCH_10.json gives band
    22, served 10 at precision 1.0, backend calls 86 -> 76."""
    eng, jeng, reqs, jreqs = _near_config(fused=fused, band=band)
    resp, jresp = eng.process(reqs), jeng.process(jreqs)
    _same(resp, jresp)
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in js:
        if key not in TIMING_KEYS:
            assert s[key] == js[key], key
    for name in STATS:
        assert int(getattr(eng.stats, name)) == \
            int(getattr(jeng.stats, name)), name
    assert eng.backend.calls == jeng.backend.calls
    np.testing.assert_allclose(eng.policy_state.numpy(),
                               np.asarray(jeng.policy_state), rtol=0,
                               atol=1e-7)
    if band:
        m = s["near"]
        assert (m["band_lookups"], m["near_hits_served"],
                m["near_precision"]) == (22, 10, 1.0)
        assert eng.backend.calls == 76
        assert sum(r.near_hit for r in resp) == 10
    else:
        assert eng.backend.calls == 86 and s["near"] == {}


def test_exact_rows_identical_with_the_band_on_and_off():
    on, _, reqs, _ = _near_config(band=True)
    off, _, _, _ = _near_config(band=False)
    a, b = on.process(reqs), off.process(reqs)
    exact = [(x, y) for x, y in zip(a, b) if y.cached]
    assert len(exact) > 100
    assert all(x.answer == y.answer and x.score == y.score and x.cached
               for x, y in exact)
    assert off.backend.calls - on.backend.calls == 10


def test_synthesized_answer_admitted_under_its_own_key():
    eng, _, reqs, _ = _near_config(band=True)
    resp = eng.process(reqs)
    i = next(i for i, r in enumerate(resp) if r.near_hit)
    again = eng.process([reqs[i]])[0]
    assert again.cached and again.answer == resp[i].answer
    assert again.score == pytest.approx(1.0, abs=1e-6)


def test_default_policy_band_rides_the_config_threshold():
    pairs = build_corpus(10, seed=0)
    eng = CachedEngine(CacheConfig(dim=384, capacity=64, value_len=48,
                                   threshold=0.85),
                       SimulatedLLMBackend(pairs), batch_size=8,
                       synthesizer=TemplateSplice(), device="cpu")
    assert isinstance(eng.cache.policy, BandPolicy)
    assert eng.cache.policy.tau_hi == 0.85
    assert eng.policy_state.tolist() == pytest.approx([0.7, 0.85, 0.92])


def test_empty_slab_band_rows_fall_back_to_the_backend():
    pairs = build_corpus(10, seed=0)
    eng = CachedEngine(CacheConfig(dim=384, capacity=64, value_len=48),
                       SimulatedLLMBackend(pairs), batch_size=8,
                       synthesizer=TemplateSplice(),
                       policy=BandPolicy(tau_lo=0.0, tau_hi=0.8, lo_min=0.0),
                       device="cpu")
    (r,) = eng.process([Request(query=pairs[0].question)])
    assert not r.cached and not r.near_hit and r.score == float("-inf")
    assert eng.backend.calls == 1


def test_explain_shows_the_band():
    eng, _, reqs, _ = _near_config(band=True)
    eng.explain_all = True
    resp = eng.process(reqs[:64])
    near = [r for r in resp if r.near_hit]
    assert near and all(r.why["decision"] == "near_hit" and
                        r.why["synthesis"]["verdict"] == "served" and
                        r.why["band"]["lo"] == 0.75 for r in near)
    why = eng.explain(reqs[0].query)
    assert why["dry_run"] and why["band"]["hi"] == 0.8
