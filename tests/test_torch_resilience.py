"""Resilience in the port against the JAX package, on the CPU: fault
schedules, the faulty backend, backoff jitter and the circuit breaker step
by step; the engine's retries, deadline budgets, breaker and degraded
serving; ``paper_tables.resilience_table``'s quick configuration request by
request (availability and every counter equal to the reference's); and
fault-free runs byte-identical with and without resilience."""
import re

import numpy as np
import pytest

from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus
from repro.generative import BandPolicy as JBand
from repro.serving import CachedEngine as JEngine
from repro.serving import CircuitBreaker as JBreaker
from repro.serving import FaultSchedule as JSchedule
from repro.serving import FaultWindow as JWindow
from repro.serving import FaultyBackend as JFaulty
from repro.serving import Request as JRequest
from repro.serving import ResilienceConfig as JResilience
from repro.serving import RetryPolicy as JRetry
from repro.serving import SimulatedLLMBackend as JBackend
from repro.serving import build_workload as jbuild_workload
from repro_torch.core.types import CacheConfig
from repro_torch.generative import BandPolicy
from repro_torch.serving import (BackendTimeout, BackendUnavailable,
                                 CachedEngine, CircuitBreaker, FaultSchedule,
                                 FaultWindow, FaultyBackend, Request,
                                 ResilienceConfig, RetryPolicy,
                                 SimulatedLLMBackend, availability,
                                 build_workload)

SCORE_TOL = 1e-5
TIMING_KEYS = ("avg_latency_with_cache_s", "latency_percentiles")
STATS = ("lookups", "hits", "misses", "expired_evictions", "inserts")
NOVEL = ["how do ion thrusters achieve specific impulse",
         "what is the halting problem in plain words",
         "why do violins have f-shaped sound holes"]
WINDOWS = [("error", 2, 7, {}), ("brownout", 8, 11, dict(error_rate=0.5)),
           ("latency_spike", 11, 13, dict(extra_latency_s=0.02)),
           ("timeout", 20, 22, {}), ("brownout", 30, 60,
                                     dict(error_rate=0.3))]


def noop_sleep(s):
    pass


def _schedules(seed, windows=WINDOWS):
    return (FaultSchedule([FaultWindow(k, a, b, **kw)
                           for k, a, b, kw in windows], seed=seed),
            JSchedule([JWindow(k, a, b, **kw) for k, a, b, kw in windows],
                      seed=seed))


def _same_error(ref, port):
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        port()


# --------------------------------------------------------------------- #
# fault injection

@pytest.mark.parametrize("seed", [0, 5, 11])
def test_fault_schedule_matches_jax(seed):
    sched, jsched = _schedules(seed)
    for i in range(80):
        w, jw = sched.fault_at(i), jsched.fault_at(i)
        assert (w is None) == (jw is None), i
        if w is not None:
            assert (w.kind, w.start, w.stop) == (jw.kind, jw.start, jw.stop)


@pytest.mark.parametrize("args", [("boom", 0, 1, {}), ("error", 3, 3, {}),
                                  ("brownout", 0, 2, dict(error_rate=1.5)),
                                  ("latency_spike", 0, 2,
                                   dict(extra_latency_s=-1.0))])
def test_fault_window_validation_matches_jax(args):
    kind, a, b, kw = args
    _same_error(lambda: JWindow(kind, a, b, **kw),
                lambda: FaultWindow(kind, a, b, **kw))


def test_faulty_backend_matches_jax_call_by_call():
    pairs = build_corpus(10, seed=0)
    sched, jsched = _schedules(5)
    fb = FaultyBackend(SimulatedLLMBackend(pairs), sched)
    jfb = JFaulty(JBackend(pairs), jsched)
    for i in range(40):
        q = [pairs[i % len(pairs)].question, NOVEL[i % 3]]
        outcome = []
        for b in (fb, jfb):
            try:
                res = b.generate(q, ["", ""])
                outcome.append(("ok", res.answers, res.latency_s,
                                res.cost_usd))
            except Exception as exc:
                outcome.append((type(exc).__name__, str(exc)))
        assert outcome[0] == outcome[1], i
    assert (fb.calls_started, fb.faults_injected, fb.calls) == \
        (jfb.calls_started, jfb.faults_injected, jfb.calls)
    # every other attribute delegates to the wrapped backend
    assert fb.latency_per_call_s == 0.8 and fb.cost_per_call_usd == 0.002
    errs = FaultyBackend(SimulatedLLMBackend(pairs), FaultSchedule(
        [FaultWindow("timeout", 0, 1), FaultWindow("error", 1, 2)]))
    with pytest.raises(BackendTimeout):
        errs.generate(["q"])
    with pytest.raises(BackendUnavailable):
        errs.generate(["q"])


# --------------------------------------------------------------------- #
# retry policy and breaker

@pytest.mark.parametrize("kw", [dict(), dict(jitter=0.0, seed=3),
                                dict(base_backoff_s=0.001,
                                     max_backoff_s=0.002, seed=3),
                                dict(multiplier=3.0, max_backoff_s=1.0,
                                     jitter=0.5, seed=9)])
def test_retry_backoff_and_budget_match_jax(kw):
    pol, jpol = RetryPolicy(**kw), JRetry(**kw)
    for attempt in range(0, 8):
        for key in ("", "a query", "another"):
            assert pol.backoff_s(attempt, key=key) == \
                jpol.backoff_s(attempt, key=key)
        for elapsed, nxt, budget in ((0.0, 0.1, None), (0.0, 0.1, 0.05),
                                     (0.3, 0.1, 0.5), (0.4, 0.1, 0.5)):
            assert pol.allows(attempt, elapsed_s=elapsed, next_backoff_s=nxt,
                              budget_s=budget) == \
                jpol.allows(attempt, elapsed_s=elapsed, next_backoff_s=nxt,
                            budget_s=budget)


@pytest.mark.parametrize("kw", [dict(max_attempts=0),
                                dict(base_backoff_s=-1.0),
                                dict(multiplier=0.5), dict(jitter=1.0)])
def test_retry_validation_matches_jax(kw):
    _same_error(lambda: JRetry(**kw), lambda: RetryPolicy(**kw))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_transitions_match_jax_step_by_step(seed):
    """A seeded stream of allow/success/failure/clock steps through both
    breakers on one fake clock: state and counters equal after every step."""
    t = [0.0]
    kw = dict(failure_threshold=3, window=6, error_rate_threshold=0.5,
              cooldown_s=2.0, half_open_probes=2, clock=lambda: t[0])
    br, jbr = CircuitBreaker(**kw), JBreaker(**kw)
    rng = np.random.default_rng(seed)
    for _ in range(400):
        op = rng.integers(4)
        if op == 0:
            assert br.allow() == jbr.allow()
        elif op == 1:
            br.record_success()
            jbr.record_success()
        elif op == 2:
            br.record_failure()
            jbr.record_failure()
        else:
            t[0] += float(rng.choice([0.5, 1.0, 2.5]))
        assert (br.state, br.trips, br.recoveries, br.short_circuits,
                br._consecutive, br._recent) == \
            (jbr.state, jbr.trips, jbr.recoveries, jbr.short_circuits,
             jbr._consecutive, jbr._recent)
    assert br.trips > 0 and br.recoveries > 0


@pytest.mark.parametrize("kw", [dict(failure_threshold=0), dict(window=0),
                                dict(error_rate_threshold=0.0),
                                dict(half_open_probes=0)])
def test_breaker_validation_matches_jax(kw):
    _same_error(lambda: JBreaker(**kw), lambda: CircuitBreaker(**kw))
    _same_error(lambda: JResilience(degraded_band_lo=1.5),
                lambda: ResilienceConfig(degraded_band_lo=1.5))


# --------------------------------------------------------------------- #
# the engine

def _resilience_config(on: bool, schedule_windows=None, n=100, batch=16):
    """``paper_tables.resilience_table``'s quick configuration for both
    packages: n pairs a category, 12 batches of 16 paraphrase-heavy
    requests, one warm-up batch (fault index 0), the seed-5 schedule,
    ``BandPolicy(0.70, 0.80, degraded_lo=0.60)``; resilience on = 3
    attempts, 1-2 ms backoff, a zero-cooldown breaker, no real sleeps."""
    windows = schedule_windows if schedule_windows is not None else [
        ("error", 2, 7, {}), ("brownout", 8, 11, dict(error_rate=0.5)),
        ("latency_spike", 11, 13, dict(extra_latency_s=0.02))]
    pairs = build_corpus(n, seed=0)
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key

    sched, jsched = _schedules(5, windows)
    kw = dict(dim=384, capacity=8 * n, value_len=48, ttl=None,
              threshold=0.8)
    res = jres = None
    if on:
        res = ResilienceConfig(
            retry=RetryPolicy(max_attempts=3, base_backoff_s=0.001,
                              max_backoff_s=0.002, seed=3),
            breaker=CircuitBreaker(failure_threshold=3, window=8,
                                   cooldown_s=0.0),
            sleep=noop_sleep)
        jres = JResilience(
            retry=JRetry(max_attempts=3, base_backoff_s=0.001,
                         max_backoff_s=0.002, seed=3),
            breaker=JBreaker(failure_threshold=3, window=8, cooldown_s=0.0),
            sleep=noop_sleep)
    eng = CachedEngine(CacheConfig(**kw),
                       FaultyBackend(SimulatedLLMBackend(pairs), sched),
                       judge=judge, batch_size=batch,
                       policy=BandPolicy(0.70, 0.80, degraded_lo=0.60),
                       resilience=res, device="cpu")
    jeng = JEngine(JConfig(**kw), JFaulty(JBackend(pairs), jsched),
                   judge=judge, batch_size=batch,
                   policy=JBand(0.70, 0.80, degraded_lo=0.60),
                   resilience=jres)
    reqs = build_workload(pairs, 12 * batch, paraphrase_ratio=0.9, seed=43)
    jreqs = jbuild_workload(pairs, 12 * batch, paraphrase_ratio=0.9, seed=43)
    for e, r in ((eng, Request), (jeng, JRequest)):
        e.warm(pairs)
        e.serve_batch([r(query="resilience warmup")])
    return eng, jeng, reqs, jreqs


def _same(resp, jresp):
    assert len(resp) == len(jresp)
    for i, (t, j) in enumerate(zip(resp, jresp)):
        assert (t.answer, t.cached, t.near_hit, t.context, t.degraded,
                t.error) == (j.answer, j.cached, j.near_hit, j.context,
                             j.degraded, j.error), i
        assert abs(t.score - j.score) <= SCORE_TOL, (i, t.score, j.score)


@pytest.mark.parametrize("on", [False, True])
def test_resilience_table_quick_config_matches_jax(on):
    """The ``fault/*`` rows: availability 0.9948 on and 0.8073 off
    (BENCH_10.json), and the retry, breaker and degraded counters equal to
    the reference's."""
    eng, jeng, reqs, jreqs = _resilience_config(on)
    resp, jresp = eng.process(reqs), jeng.process(jreqs)
    _same(resp, jresp)
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    for key in js:
        if key not in TIMING_KEYS:
            assert s[key] == js[key], key
    for name in STATS:
        assert int(getattr(eng.stats, name)) == \
            int(getattr(jeng.stats, name)), name
    assert eng.backend.faults_injected == jeng.backend.faults_injected == 6
    assert round(availability(resp), 4) == (0.9948 if on else 0.8073)
    if on:
        br, jbr = eng.resilience.breaker, jeng.resilience.breaker
        assert (br.trips, br.recoveries, br.short_circuits, br.state) == \
            (jbr.trips, jbr.recoveries, jbr.short_circuits, jbr.state) == \
            (3, 1, 0, "closed")
        rm = s["resilience"]
        assert (rm["retries"], rm["retry_successes"],
                rm["backend_failures"]) == (5, 2, 6)
        assert sum(r.degraded for r in resp) == 3
        # degraded rows are never admitted and never move the band
        np.testing.assert_allclose(eng.policy_state.numpy(),
                                   np.asarray(jeng.policy_state), atol=0)
    else:
        assert sum(bool(r.error) for r in resp) == 37


def test_fault_free_runs_identical_with_and_without_resilience():
    on, _, reqs, _ = _resilience_config(True, schedule_windows=[])
    off, _, _, _ = _resilience_config(False, schedule_windows=[])
    a, b = on.process(reqs), off.process(reqs)
    assert [(r.answer, r.cached, r.score, r.near_hit, r.degraded, r.error)
            for r in a] == \
        [(r.answer, r.cached, r.score, r.near_hit, r.degraded, r.error)
         for r in b]
    assert on.stats.host() == off.stats.host()
    assert on.backend.faults_injected == 0
    assert on.metrics.summary()["resilience"]["retries"] == 0


def _engine(pairs, schedule, resilience, **kw):
    return CachedEngine(CacheConfig(dim=384, capacity=1024, value_len=48),
                        FaultyBackend(SimulatedLLMBackend(pairs), schedule),
                        batch_size=8, resilience=resilience, device="cpu",
                        **kw)


ALL_ERRORS = [("error", 0, 10_000, {})]


def test_deadline_budgets():
    pairs = build_corpus(20, seed=0)
    always, _ = _schedules(0, ALL_ERRORS)
    # a 10 s backoff never fits a 50 ms budget: no retry
    res = ResilienceConfig(retry=RetryPolicy(base_backoff_s=10.0, jitter=0.0),
                           breaker=None, degraded_serving=False,
                           sleep=noop_sleep)
    eng = _engine(pairs, always, res)
    (r,) = eng.process([Request(query=NOVEL[0], deadline_ms=50.0)])
    rm = eng.metrics.resilience
    assert r.error and (rm.retries, rm.deadline_exhausted) == (0, 1)
    assert eng.backend.calls_started == 1
    # a spent budget fails fast, without a call
    eng = _engine(pairs, FaultSchedule(), ResilienceConfig(
        breaker=None, degraded_serving=False, sleep=noop_sleep))
    (r,) = eng.process([Request(query=NOVEL[0], deadline_ms=0.0)])
    assert "DeadlineExhausted" in r.error
    assert eng.backend.calls_started == 0
    # a transient fault inside the budget is retried away
    once, _ = _schedules(0, [("error", 0, 1, {})])
    eng = _engine(pairs, once, ResilienceConfig(
        retry=RetryPolicy(base_backoff_s=0.0, jitter=0.0), breaker=None,
        sleep=noop_sleep))
    (r,) = eng.process([Request(query=NOVEL[0], deadline_ms=5000.0)])
    assert r.answer and not r.error
    assert eng.metrics.resilience.retry_successes == 1


def test_open_breaker_short_circuits_and_degraded_rows_stay_out():
    pairs = build_corpus(20, seed=0)
    always, _ = _schedules(0, ALL_ERRORS)
    res = ResilienceConfig(
        retry=RetryPolicy(base_backoff_s=0.0, jitter=0.0),
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=1000.0),
        degraded_band_lo=0.0, sleep=noop_sleep)
    eng = _engine(pairs, always, res)
    eng.warm(pairs)
    before = eng.stats.host()
    r1, r2 = eng.process([Request(query=NOVEL[0]),
                          Request(query=pairs[0].question)])
    assert r1.degraded and r1.answer and not r1.error and not r1.cached
    assert r2.cached
    assert res.breaker.state == "open" and eng.backend.calls_started == 1
    (r3,) = eng.process([Request(query=NOVEL[1])])
    assert r3.degraded and eng.backend.calls_started == 1
    assert eng.metrics.resilience.breaker_short_circuits >= 1
    after = eng.stats.host()
    # the degraded rows moved no device counter and were not inserted
    assert after["inserts"] == before["inserts"]
    assert after["lookups"] == before["lookups"] + 1
    assert eng.metrics.resilience.degraded_served == 2
