"""Sessions in the port against the JAX package, on the CPU: the fusion
ops (both strategies, empty rows bit-identical), ``SessionStore`` step by
step, ``SemanticCache`` lookups and steps with turn windows, the engine at
``paper_tables.context_table``'s quick configuration request by request
(fusion on and off, fused and separate paths), the multi-turn workload
builders, and the three snapshot rules across the two packages."""
import asyncio
import dataclasses
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.context import AttentionFusion as JAttention
from repro.context import DecayMeanFusion as JDecay
from repro.context import FusionState as JFusionState
from repro.context import SessionStore as JSessionStore
from repro.context import fuse_op as jfuse_op
from repro.core.cache import SemanticCache as JCache
from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro.serving import build_multi_turn_workload as jbuild_multi_turn
from repro.serving import turn_levels as jturn_levels
from repro.training.checkpoint import _flatten as jflatten
from repro_torch.context import (AttentionFusion, DecayMeanFusion,
                                 FusionState, SessionStore, fuse_op)
from repro_torch.core.cache import SemanticCache
from repro_torch.core.types import CacheConfig
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SchedulerConfig, SimulatedLLMBackend,
                                 build_multi_turn_workload, run_sessions,
                                 turn_levels)
from repro_torch.training import checkpoint

FUSE_TOL = 1e-6
SCORE_TOL = 1e-5
STRATEGIES = {"decay": (DecayMeanFusion, JDecay),
              "attention": (AttentionFusion, JAttention)}
TIMING_KEYS = ("avg_latency_with_cache_s", "latency_percentiles")
STATS = ("lookups", "hits", "misses", "expired_evictions", "inserts")


def _fusions(name, **kw):
    port, ref = STRATEGIES[name]
    return port(**kw), ref(**kw)


def _window_inputs(seed, b=8, w=4, d=384, lens=(0, 1, 2, 3, 4, 0, 4, 2)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    win = rng.standard_normal((b, w, d)).astype(np.float32)
    wl = np.asarray(lens[:b], dtype=np.int32)
    for i, n in enumerate(wl):
        win[i, n:] = 0.0                     # left-aligned, zero tail
    return q, win, wl


# --------------------------------------------------------------------- #
# fusion ops

@pytest.mark.parametrize("name", sorted(STRATEGIES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fusion_matches_jax(name, seed):
    fusion, jfusion = _fusions(name, window=4)
    q, win, wl = _window_inputs(seed)
    out = fuse_op(fusion, fusion.init_state("cpu"), torch.from_numpy(q),
                  torch.from_numpy(win), torch.from_numpy(wl)).numpy()
    want = np.asarray(jfuse_op(jfusion, jfusion.init_state(),
                               jnp.asarray(q), jnp.asarray(win),
                               jnp.asarray(wl)))
    np.testing.assert_allclose(out, want, rtol=0, atol=FUSE_TOL)
    empty = wl == 0
    # empty-window rows come back bit-identical, in both packages
    assert np.array_equal(out[empty], q[empty])
    assert np.array_equal(want[empty], q[empty])
    full = ~empty
    np.testing.assert_allclose(np.linalg.norm(out[full], axis=1), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_fusion_weights_match_jax_and_checkpoint_alike(name):
    fusion, jfusion = _fusions(name, window=3, context_weight=0.7)
    fs, jfs = fusion.init_state("cpu"), jfusion.init_state()
    for f in dataclasses.fields(FusionState):
        got, want = getattr(fs, f.name), np.asarray(getattr(jfs, f.name))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == want.item()
    cache = SemanticCache(CacheConfig(dim=8, capacity=16), fusion=fusion)
    flat = checkpoint.runtime_to_numpy(cache.init("cpu"))
    jflat = jflatten({"runtime": JCache(JConfig(dim=8, capacity=16),
                                        fusion=jfusion).init()})
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        assert flat[k].dtype == jflat[k].dtype, k


@pytest.mark.parametrize("kw", [
    dict(window=0), dict(context_weight=1.0), dict(context_weight=-0.1),
    dict(decay=0.0), dict(decay=1.5), dict(temp=0.0)])
def test_strategy_validation_matches_jax(kw):
    for port, ref in STRATEGIES.values():
        extra = {k: v for k, v in kw.items()
                 if k in {f.name for f in dataclasses.fields(port)}}
        if not extra:
            continue
        with pytest.raises(ValueError) as want:
            ref(**extra)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            port(**extra)


# --------------------------------------------------------------------- #
# SessionStore

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_session_store_matches_jax_step_by_step(seed):
    """A seeded mix of touches, appends, sweeps and probes over a few
    tenants and sessions: ring order, TTL on touch and on sweep, the LRU
    cap and tenant namespacing, each step against the reference store."""
    rng = np.random.default_rng(seed)
    kw = dict(window=3, dim=5, ttl=10.0, max_sessions=4)
    port, ref = SessionStore(**kw), JSessionStore(**kw)
    now = 0.0
    for _ in range(300):
        tenant = f"t{rng.integers(2)}"
        session = f"s{rng.integers(4)}"
        op = rng.integers(5)
        if op == 0:
            a, b = port.window_for(tenant, session, now), \
                ref.window_for(tenant, session, now)
            assert a[1] == b[1]
            assert np.array_equal(a[0], b[0])
        elif op == 1:
            emb = rng.standard_normal(5).astype(np.float32)
            port.append(tenant, session, emb, now)
            ref.append(tenant, session, emb, now)
        elif op == 2:
            assert port.expire(now) == ref.expire(now)
        elif op == 3:
            assert port.turns(tenant, session) == ref.turns(tenant, session)
        else:
            now += float(rng.choice([0.5, 3.0, 11.0]))
        assert port.stats() == ref.stats()
        assert len(port) == len(ref)
        assert list(port._sessions) == list(ref._sessions)


@pytest.mark.parametrize("kw", [dict(window=0, dim=4), dict(window=2, dim=0),
                                dict(window=2, dim=4, max_sessions=0),
                                dict(window=2, dim=4, ttl=0.0)])
def test_session_store_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JSessionStore(**kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        SessionStore(**kw)


# --------------------------------------------------------------------- #
# SemanticCache with windows

@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_cache_lookup_and_step_with_windows_match_jax(name):
    """Seeded batches with session windows through the port's and the
    reference's ``SemanticCache``: hits, slot ids and counters equal, slab
    keys within 1e-6."""
    fusion, jfusion = _fusions(name, window=4)
    kw = dict(dim=384, capacity=64, value_len=8, threshold=0.8)
    cache, jcache = SemanticCache(CacheConfig(**kw), fusion=fusion), \
        JCache(JConfig(**kw), fusion=jfusion)
    rt, jrt = cache.init("cpu"), jcache.init()
    rng = np.random.default_rng(5)
    prev = None
    for step in range(6):
        q, win, wl = _window_inputs(10 + step, b=8)
        if prev is not None:
            q[:3] = prev[:3]                  # repeats: some rows must hit
            win[:3], wl[:3] = prev_win[:3], prev_wl[:3]
        vals = rng.integers(1, 50, (8, 8)).astype(np.int32)
        lens = np.full((8,), 8, np.int32)
        now = float(step)
        res, rt = cache.step(rt, torch.from_numpy(q), torch.from_numpy(vals),
                             torch.from_numpy(lens), now,
                             window=torch.from_numpy(win),
                             window_len=torch.from_numpy(wl))
        jres, jrt = jcache.step(jrt, jnp.asarray(q), jnp.asarray(vals),
                                jnp.asarray(lens), now,
                                window=jnp.asarray(win),
                                window_len=jnp.asarray(wl))
        assert res.hit.tolist() == np.asarray(jres.hit).tolist()
        assert res.index.tolist() == np.asarray(jres.index).tolist()
        assert res.topk_index.tolist() == np.asarray(jres.topk_index).tolist()
        np.testing.assert_allclose(res.score.numpy(), np.asarray(jres.score),
                                   rtol=0, atol=SCORE_TOL)
        peek, _ = cache.lookup(rt, torch.from_numpy(q), now,
                               update_counters=False,
                               window=torch.from_numpy(win),
                               window_len=torch.from_numpy(wl))
        assert bool(peek.hit[:3].all())      # its own just-inserted keys
        prev, prev_win, prev_wl = q, win, wl
    for n in STATS:
        assert int(getattr(rt.stats, n)) == int(getattr(jrt.stats, n)), n
    np.testing.assert_allclose(rt.state.keys.numpy(),
                               np.asarray(jrt.state.keys), rtol=0,
                               atol=FUSE_TOL)
    assert rt.state.valid.tolist() == np.asarray(jrt.state.valid).tolist()


def test_cache_without_window_is_the_stateless_path():
    cache = SemanticCache(CacheConfig(dim=16, capacity=16),
                          fusion=DecayMeanFusion())
    rt = cache.init("cpu")
    q = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    assert cache._maybe_fuse(rt, q, None, None) is q
    with pytest.raises(ValueError, match="window_len"):
        cache._maybe_fuse(rt, q, torch.zeros(4, 4, 16), None)


# --------------------------------------------------------------------- #
# workloads

def test_multi_turn_workload_matches_jax():
    pairs = build_corpus(40, seed=0)
    convs = build_multi_turn_workload(pairs, 8, turns=3, seed=23,
                                      tenants=["a", "b"])
    jconvs = jbuild_multi_turn(pairs, 8, turns=3, seed=23,
                               tenants=["a", "b"])
    assert [[dataclasses.astuple(r) for r in c] for c in convs] == \
        [[dataclasses.astuple(r) for r in c] for c in jconvs]
    levels, jlevels = turn_levels(convs), jturn_levels(jconvs)
    assert [[dataclasses.astuple(r) for r in lv] for lv in levels] == \
        [[dataclasses.astuple(r) for r in lv] for lv in jlevels]
    for bad in (dict(n_groups=0), dict(n_groups=17), dict(turns=1)):
        args = dict(n_groups=4, turns=3) | bad
        with pytest.raises(ValueError) as want:
            jbuild_multi_turn(pairs, **args)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            build_multi_turn_workload(pairs, **args)


# --------------------------------------------------------------------- #
# the engine

def _context_config(fusion_name, fused=True, n=150, groups=10, batch=32,
                    int8=False):
    """``paper_tables.context_table``'s quick configuration for both
    packages: n pairs per category, 10 record/replay groups of 3 turns,
    batch 32, threshold 0.8, 8n slots (f32 keys, or int8 with ``int8``)."""
    pairs = build_corpus(n, seed=0)
    convs = build_multi_turn_workload(pairs, groups, turns=3, seed=23)
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}
    for conv in convs:
        for r in conv:
            key_by_sid.setdefault(r.source_id, r.semantic_key)

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key

    kw = dict(dim=384, capacity=8 * n, value_len=48, ttl=None,
              threshold=0.8)
    fusion = jfusion = None
    if fusion_name is not None:
        fusion, jfusion = _fusions(fusion_name, window=4)
    eng = CachedEngine(
        CacheConfig(**kw, key_dtype=torch.int8 if int8 else torch.float32),
        SimulatedLLMBackend(pairs), judge=judge, batch_size=batch,
        fusion=fusion, use_fused_step=fused, device="cpu")
    jeng = JEngine(
        JConfig(**kw, key_dtype=jnp.int8 if int8 else jnp.float32),
        JBackend(pairs), judge=judge, batch_size=batch, fusion=jfusion,
        use_fused_step=fused)
    eng.warm(pairs)
    jeng.warm(pairs)
    return pairs, convs, eng, jeng


def _serve_halves(eng, convs, request_type):
    """Record first, then replay, each half level by level."""
    out = []
    half = len(convs) // 2
    for part in (convs[:half], convs[half:]):
        for level in turn_levels(part):
            out += eng.process([request_type(**dataclasses.asdict(r))
                                for r in level])
    return out


def _same_responses(resp, jresp):
    assert len(resp) == len(jresp)
    for i, (t, j) in enumerate(zip(resp, jresp)):
        assert (t.answer, t.cached, t.context, t.near_hit, t.degraded,
                t.error) == (j.answer, j.cached, j.context, j.near_hit,
                             j.degraded, j.error), i
        assert abs(t.score - j.score) <= SCORE_TOL, (i, t.score, j.score)


def _same_summary(eng, jeng):
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in js:
        if key not in TIMING_KEYS:
            assert s[key] == js[key], key
    for name in STATS:
        assert int(getattr(eng.stats, name)) == \
            int(getattr(jeng.stats, name)), name


@pytest.mark.parametrize("fusion_name,fused,int8", [
    ("decay", True, False), ("attention", True, False), (None, True, False),
    ("decay", False, False), ("decay", True, True)])
def test_context_table_quick_config_matches_jax(fusion_name, fused, int8):
    """The ``context/*`` rows: request by request, the summary and the
    device counters equal to the JAX engine's; fused follow-up replays all
    hit, stateless ones none (BENCH_10.json: 1.0 and 0.0). On an int8 slab
    a hit's canonical key is the stored key dequantized by 1/127."""
    _, convs, eng, jeng = _context_config(fusion_name, fused=fused,
                                          int8=int8)
    resp = _serve_halves(eng, convs, Request)
    jresp = _serve_halves(jeng, convs, JRequest)
    _same_responses(resp, jresp)
    _same_summary(eng, jeng)
    rep = eng.metrics.summary()["categories"]["ctx/followup_repeat"]
    assert rep["lookups"] == 20
    if fusion_name is None:
        assert rep["cache_hits"] == 0
        assert not any(r.context for r in resp)
    else:
        if fusion_name == "decay":           # the reference's bar
            assert rep["hit_rate"] == 1.0
        assert rep["hit_rate"] >= 0.9 and rep["positive_rate"] == 1.0
        # every session row after its first turn was fused
        assert sum(r.context for r in resp) == 40
        assert eng.sessions.stats() == jeng.sessions.stats()
        for key, s in eng.sessions._sessions.items():
            js = jeng.sessions._sessions[key]
            assert (s.count, s.ptr) == (js.count, js.ptr)
            np.testing.assert_allclose(s.ring, js.ring, rtol=0,
                                       atol=FUSE_TOL)


def test_fused_path_equals_separate_path_with_sessions():
    _, convs, fused, _ = _context_config("decay", fused=True, n=40,
                                         groups=6, batch=8)
    _, _, sep, _ = _context_config("decay", fused=False, n=40, groups=6,
                                   batch=8)
    a = _serve_halves(fused, convs, Request)
    b = _serve_halves(sep, convs, Request)
    assert [(r.answer, r.cached, r.context) for r in a] == \
        [(r.answer, r.cached, r.context) for r in b]
    np.testing.assert_allclose([r.score for r in a], [r.score for r in b],
                               rtol=0, atol=1e-6)
    assert fused.stats.host() == sep.stats.host()


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_step_inserts_exactly_the_standalone_fused_key(name):
    """The engine fuses once a batch: the key the step inserts for a
    session miss is the standalone op's output, bit for bit."""
    pairs = build_corpus(10, seed=0)
    fusion, _ = _fusions(name, window=4)
    eng = CachedEngine(CacheConfig(dim=384, capacity=256, value_len=48),
                       SimulatedLLMBackend(pairs), batch_size=8,
                       fusion=fusion, device="cpu")
    sess = "parity-conv"
    eng.process([Request(query="seed turn for context", session=sess)])
    win, n = eng.sessions.window_for("default", sess, eng._now)
    assert n == 1
    q = "a brand new follow-up that must miss"
    (resp,) = eng.process([Request(query=q, session=sess)])
    assert resp.context and not resp.cached
    expect = fuse_op(fusion, eng.runtime.fusion,
                     torch.from_numpy(eng.embedder.embed_batch([q])),
                     torch.from_numpy(win[None]),
                     torch.tensor([n], dtype=torch.int32))[0]
    keys = eng.state.keys
    assert bool((keys == expect).all(dim=1).any())
    # and the session's second turn is that same key (a miss appends its
    # own fused key)
    win2, n2 = eng.sessions.window_for("default", sess, eng._now)
    assert n2 == 2 and np.array_equal(win2[1], expect.numpy())


def test_sessionless_traffic_identical_with_and_without_fusion():
    pairs = build_corpus(30, seed=0)
    reqs = [Request(query=p.question, source_id=p.qa_id,
                    semantic_key=p.semantic_key) for p in pairs[:40]]
    out = {}
    for fusion in (DecayMeanFusion(window=4), None):
        eng = CachedEngine(CacheConfig(dim=384, capacity=256, value_len=48),
                           SimulatedLLMBackend(pairs), batch_size=16,
                           fusion=fusion, device="cpu")
        eng.warm(pairs[:20])
        out[fusion is None] = [(r.answer, r.cached, r.score, r.context)
                               for r in eng.process(reqs)]
    assert out[True] == out[False]          # scores bit for bit
    assert not any(c for *_, c in out[True])


def test_sessions_expire_on_every_batch_like_jax():
    pairs = build_corpus(10, seed=0)
    engines = []
    for eng_type, req_type, kw in (
            (CachedEngine, Request, dict(device="cpu")),
            (JEngine, JRequest, {})):
        cfg = (CacheConfig if eng_type is CachedEngine else JConfig)(
            dim=384, capacity=128, value_len=48)
        fusion = (DecayMeanFusion if eng_type is CachedEngine else JDecay)()
        backend = (SimulatedLLMBackend if eng_type is CachedEngine
                   else JBackend)(pairs)
        eng = eng_type(cfg, backend, batch_size=4, fusion=fusion,
                       session_ttl_s=5.0, max_sessions=3, **kw)
        for i in range(5):
            eng.process([req_type(query=f"turn {i}", session=f"s{i}")])
            eng.tick(2.0)
        eng.process([req_type(query="sessionless")])
        engines.append(eng.sessions.stats())
    assert engines[0] == engines[1]
    assert engines[0]["evicted_lru"] + engines[0]["expired_ttl"] > 0


def test_explain_reports_the_session_window():
    pairs = build_corpus(10, seed=0)
    eng = CachedEngine(CacheConfig(dim=384, capacity=128, value_len=48),
                       SimulatedLLMBackend(pairs), batch_size=4,
                       fusion=DecayMeanFusion(), device="cpu")
    eng.process([Request(query="opening turn", session="c")])
    why = eng.explain("and a follow-up", session="c")
    assert why["session_fused"] and why["session"] == "c"
    assert not eng.explain("and a follow-up")["session_fused"]
    assert int(eng.stats.lookups) == 1      # explain is a pure peek


def test_run_sessions_keeps_turn_order_and_hits_like_sync():
    """The async front end through ``run_sessions``: the replays' fused
    follow-ups hit as many as in the sync turn-level run, and a TCP line
    with ``session`` gets the ``context`` key back."""
    pairs, convs, sync_eng, _ = _context_config("decay", n=40, groups=6,
                                                batch=8)
    _serve_halves(sync_eng, convs, Request)
    sync = sync_eng.metrics.summary()["categories"]["ctx/followup_repeat"]
    _, _, eng, _ = _context_config("decay", n=40, groups=6, batch=8)

    async def drive():
        async with AsyncCacheServer(eng, SchedulerConfig(max_batch=8)) as srv:
            for part in (convs[:6], convs[6:]):
                res = await run_sessions(srv.submit_request, part,
                                         concurrency=4)
                assert len(res.responses) == sum(len(c) for c in part)
            port = await srv.serve_tcp("127.0.0.1", 0)
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b'{"query": "what about it", "session": "tcp-s"}\n')
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(), 60)
            writer.close()
            await writer.wait_closed()
            return line

    line = json.loads(asyncio.run(drive()))
    assert "context" in line and line["context"] is False
    got = eng.metrics.summary()["categories"]["ctx/followup_repeat"]
    assert got["cache_hits"] == sync["cache_hits"] == got["lookups"]


# --------------------------------------------------------------------- #
# snapshots

def _replay_hits(eng, convs):
    half = len(convs) // 2
    resp = []
    for level in turn_levels(convs[half:]):
        resp += eng.process(level)
    return sum(r.cached for r in resp if r.context)


def test_fusion_snapshot_round_trip_keeps_replay_hits(tmp_path):
    pairs, convs, eng, _ = _context_config("attention", n=40, groups=6,
                                           batch=8)
    for level in turn_levels(convs[:6]):
        eng.process(level)
    eng.save_cache(str(tmp_path / "snap"))
    meta = checkpoint.read_metadata(str(tmp_path / "snap"))
    assert meta["fusion"] == "AttentionFusion"
    _, _, fresh, _ = _context_config("attention", n=40, groups=6, batch=8)
    fresh.load_cache(str(tmp_path / "snap"))
    assert _replay_hits(fresh, convs) == _replay_hits(eng, convs) >= 10


def test_pre_session_snapshot_loads_into_a_fusion_engine(tmp_path):
    pairs = build_corpus(20, seed=0)
    cfg = CacheConfig(dim=384, capacity=256, value_len=48)
    plain = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                         device="cpu")
    plain.warm(pairs)
    plain.save_cache(str(tmp_path / "pre"))
    fusion = DecayMeanFusion(context_weight=0.5)
    eng = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                       fusion=fusion, tokenizer=plain.tokenizer, device="cpu")
    eng.load_cache(str(tmp_path / "pre"))
    # fresh fusion weights; raw single-turn lookups match bit for bit
    assert eng.runtime.fusion.context_weight.item() == np.float32(0.5)
    reqs = [Request(query=p.question) for p in pairs[:8]]
    a, b = eng.process(reqs), plain.process(reqs)
    assert [(r.answer, r.cached, r.score) for r in a] == \
        [(r.answer, r.cached, r.score) for r in b]


def test_fusion_snapshot_into_fusionless_engine_raises(tmp_path):
    pairs = build_corpus(10, seed=0)
    cfg = CacheConfig(dim=384, capacity=128, value_len=48)
    eng = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                       fusion=DecayMeanFusion(), device="cpu")
    eng.save_cache(str(tmp_path / "fused"))
    plain = CachedEngine(cfg, SimulatedLLMBackend(pairs), batch_size=8,
                         device="cpu")
    with pytest.raises(ValueError, match="runtime/fusion"):
        plain.load_cache(str(tmp_path / "fused"))
    flat = checkpoint.open_checkpoint(str(tmp_path / "fused"))
    with pytest.raises(ValueError, match="fusion"):
        checkpoint.runtime_from_numpy(flat, cfg, torch.device("cpu"))


def test_jax_fusion_snapshot_loads_into_the_port(tmp_path):
    """A JAX fusion engine's snapshot, mid-conversation, restored into the
    port: the replays then hit as they do in the JAX engine, and the fusion
    weights come across."""
    _, convs, eng, jeng = _context_config("decay", n=40, groups=6, batch=8)
    for level in jturn_levels(convs[:6]):
        jeng.process([JRequest(**dataclasses.asdict(r)) for r in level])
    path = str(tmp_path / "jax_snap")
    jeng.save_cache(path)
    eng.load_cache(path)
    assert eng.runtime.fusion.decay.item() == np.float32(0.6)
    np.testing.assert_array_equal(eng.state.keys.numpy(),
                                  np.asarray(jeng.state.keys))
    assert _replay_hits(eng, convs) == 12
    # and the other way: the port's snapshot loads into a JAX engine
    eng.save_cache(str(tmp_path / "port_snap"))
    _, _, _, jfresh = _context_config("decay", n=40, groups=6, batch=8)
    jfresh.load_cache(str(tmp_path / "port_snap"))
    assert isinstance(jfresh.runtime.fusion, JFusionState)
    assert int(jfresh.stats.inserts) == int(eng.stats.inserts)
