"""The slice as a whole: the port's CachedEngine (on the CPU) against the
JAX package's, request by request, on the paper's serve loop — fused and
separate paths, f32 and int8 slabs, a ring that wraps, TTL expiry — plus
the quick Table 1 configuration, snapshots loaded across the two packages,
the serve driver, and the entry points that need CUDA."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import AdaptiveThreshold as JAdaptive
from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus, build_test_queries
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro_torch.core.cache import SemanticCache
from repro_torch.core.policy import AdaptiveThreshold
from repro_torch.core.types import CacheConfig
from repro_torch.launch import serve
from repro_torch.serving import CachedEngine, Request, SimulatedLLMBackend

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-5
THRESHOLD = 0.8
TIMING_KEYS = ("avg_latency_with_cache_s", "latency_percentiles")
STATS = ("lookups", "hits", "misses", "expired_evictions", "inserts")
KEY_DTYPES = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}


def _workload(corpus, queries):
    pairs = build_corpus(corpus, seed=0)
    tests = build_test_queries(pairs, n_per_category=queries, seed=1)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    return pairs, tests, judge


def _engines(corpus, queries, *, key_dtype="f32", fused=True, capacity=512,
             ttl=None, batch=16, adaptive=False):
    """A JAX engine and a port engine (CPU) over the same workload."""
    pairs, tests, judge = _workload(corpus, queries)
    kw = dict(dim=384, capacity=capacity, value_len=48, ttl=ttl,
              threshold=THRESHOLD)
    jeng = JEngine(
        JConfig(key_dtype=getattr(jnp, KEY_DTYPES[key_dtype]), **kw),
        JBackend(pairs), judge=judge, batch_size=batch, use_fused_step=fused,
        policy=JAdaptive() if adaptive else None)
    teng = CachedEngine(
        CacheConfig(key_dtype=getattr(torch, KEY_DTYPES[key_dtype]), **kw),
        SimulatedLLMBackend(pairs), judge=judge, batch_size=batch,
        use_fused_step=fused, policy=AdaptiveThreshold() if adaptive else None,
        device="cpu")
    jreq = [JRequest(query=q.query, category=q.category, source_id=q.source_id,
                     semantic_key=q.semantic_key) for q in tests]
    treq = [Request(query=q.query, category=q.category, source_id=q.source_id,
                    semantic_key=q.semantic_key) for q in tests]
    return pairs, jeng, teng, jreq, treq


def _same_responses(jresp, tresp):
    assert len(jresp) == len(tresp)
    for i, (j, t) in enumerate(zip(jresp, tresp)):
        assert (t.answer, t.cached) == (j.answer, j.cached), i
        assert t.score == j.score or abs(t.score - j.score) <= SCORE_TOL, \
            (i, t.score, j.score)
        # no decision may hinge on the summation order
        assert abs(j.score - THRESHOLD) > SCORE_TOL, (i, j.score)


def _same_summary(jeng, teng):
    js, ts = jeng.metrics.summary(), teng.metrics.summary()
    for key in js:
        if key not in TIMING_KEYS:
            assert ts[key] == js[key], key
    # wall-clock fields differ by host; their sample counts do not
    assert {p: r["count"] for p, r in ts["latency_percentiles"].items()} == \
        {p: r["count"] for p, r in js["latency_percentiles"].items()}
    for name in STATS:
        assert int(getattr(teng.stats, name)) == \
            int(getattr(jeng.stats, name)), name


@pytest.mark.parametrize("key_dtype,fused,capacity,ttl", [
    ("f32", True, 64, None),      # the ring wraps while warming and serving
    ("f32", False, 512, 10.0),    # TTL expiry via tick
    ("int8", True, 512, 10.0),
    ("int8", False, 64, None),
])
def test_engine_matches_jax_request_by_request(key_dtype, fused, capacity,
                                               ttl):
    pairs, jeng, teng, jreq, treq = _engines(
        30, 15, key_dtype=key_dtype, fused=fused, capacity=capacity, ttl=ttl)
    jeng.warm(pairs)
    teng.warm(pairs)
    half = len(jreq) // 2
    jresp = jeng.process(jreq[:half])
    tresp = teng.process(treq[:half])
    if ttl is not None:
        # every warm entry is past its deadline after this tick
        jeng.tick(ttl + 1.0)
        teng.tick(ttl + 1.0)
    jresp += jeng.process(jreq[half:])
    tresp += teng.process(treq[half:])
    _same_responses(jresp, tresp)
    _same_summary(jeng, teng)
    assert any(r.cached for r in tresp) and not all(r.cached for r in tresp)
    if capacity < len(pairs):
        assert int(teng.state.n_inserts) > capacity


def test_table1_quick_config_matches_jax():
    """paper_tables.table1(full=False): 400 pairs and 100 queries per
    category, capacity 3,200, batch 128."""
    pairs, jeng, teng, jreq, treq = _engines(400, 100, capacity=3200,
                                             batch=128)
    jeng.warm(pairs)
    teng.warm(pairs)
    _same_responses(jeng.process(jreq), teng.process(treq))
    _same_summary(jeng, teng)
    hits = {c: m["cache_hits"]
            for c, m in teng.metrics.summary()["categories"].items()}
    assert hits == {"python_basics": 57, "network_support": 63,
                    "order_shipping": 62, "customer_shopping": 55}


@pytest.mark.parametrize("key_dtype", ["f32", "bf16"])
def test_snapshots_load_across_packages(tmp_path, key_dtype):
    kw = dict(key_dtype=key_dtype, adaptive=True, ttl=50.0)
    pairs, jeng, teng, jreq, treq = _engines(30, 15, **kw)
    for eng in (jeng, teng):
        eng.warm(pairs)
        eng.tick(3.0)
    half = len(jreq) // 2
    _same_responses(jeng.process(jreq[:half]), teng.process(treq[:half]))
    jeng.save_cache(str(tmp_path / "jax"))
    teng.save_cache(str(tmp_path / "torch"))
    # a fresh engine of each package, restored from the other's snapshot
    _, jeng2, teng2, _, _ = _engines(30, 15, **kw)
    teng2.load_cache(str(tmp_path / "jax"))
    jeng2.load_cache(str(tmp_path / "torch"))
    for eng in (jeng2, teng2):
        # a snapshot holds token ids; the decoder table of a fresh tokenizer
        # learns the words as it encodes them, in both packages
        eng.tokenizer.encode_batch([p.answer for p in pairs], 48)
    assert teng2._now == jeng2._now == 3.0
    rest = [eng.process(reqs[half:]) for eng, reqs in
            ((jeng, jreq), (teng, treq), (jeng2, jreq), (teng2, treq))]
    for other in rest[1:]:
        _same_responses(rest[0], other)
    for j, t in ((jeng, teng2), (jeng2, teng)):
        np.testing.assert_allclose(t.policy_state.numpy(),
                                   np.asarray(j.policy_state), rtol=0,
                                   atol=1e-7)
        for name in ("n_inserts", "ptr"):
            assert int(getattr(t.state, name)) == int(getattr(j.state, name))
        # rows inserted after the restore were normalized by each package
        np.testing.assert_allclose(
            t.state.keys.float().numpy(),
            np.asarray(j.state.keys.astype(jnp.float32)), rtol=0, atol=1e-7)


def test_serve_driver_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    snap = tmp_path / "snap"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--corpus", "20", "--queries", "5", "--snapshot", str(snap)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"categories"' in out.stdout
    assert (tmp_path / "snap.npz").exists()
    assert (tmp_path / "snap.manifest.json").exists()


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cfg = CacheConfig(dim=8, capacity=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedEngine(cfg, SimulatedLLMBackend([]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SemanticCache(cfg).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--corpus", "2", "--queries", "1"])


@pytest.mark.parametrize("feature", ["fusion", "synthesizer", "tracer",
                                     "events", "explain_responses",
                                     "resilience", "mesh"])
def test_unported_engine_features_raise(feature):
    cfg = CacheConfig(dim=8, capacity=64)
    with pytest.raises(NotImplementedError, match="slice"):
        CachedEngine(cfg, SimulatedLLMBackend([]), device="cpu",
                     **{feature: object()})
