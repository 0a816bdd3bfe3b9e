"""The port's observability plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU: tracer retention step by step, the
engine's stage spans, ``why`` records (``explain()`` and
``Request(explain=True)``, the snapshot taken before the step that updates
the slab in place), the event log and the Prometheus exposition. Decisions
and counters must be equal, scores within 1e-5, span sequences equal."""
import numpy as np
import pytest
import torch

from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus as j_build_corpus
from repro.obs import EventLog as JEventLog
from repro.obs import TraceConfig as JTraceConfig
from repro.obs import Tracer as JTracer
from repro.obs import prometheus_text as j_prometheus_text
from repro.serving import CachedEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SimulatedLLMBackend as JBackend
from repro.serving.metrics import ServingMetrics as JServingMetrics
from repro.tenancy import TenantRegistry as JRegistry
from repro.tenancy import TenantSpec as JSpec
from repro_torch.core.types import CacheConfig
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.obs import (REQUIRED_FAMILIES, STAGES, EventLog,
                             MetricsExporter, TraceConfig, Tracer,
                             prometheus_text)
from repro_torch.serving import CachedEngine, Request, SimulatedLLMBackend
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.tenancy import TenantRegistry, TenantSpec

SCORE_TOL = 1e-5
#: exposition families whose samples are wall-clock times
TIMING_FAMILIES = ("repro_latency_seconds", "repro_latency_quantile_seconds",
                   "repro_tenant_latency_quantile_seconds",
                   "repro_trace_stage_seconds")
#: event fields that are wall-clock times
TIMING_FIELDS = ("ts", "cache_time_s", "llm_time_s")
NOVEL = ["why is the sky blue at noon",
         "best sourdough starter feeding schedule",
         "how tall is mount kilimanjaro",
         "difference between alligators and crocodiles",
         "what causes aurora borealis displays",
         "recommend a jazz album from 1959",
         "do tides depend on the moon"]


@pytest.fixture(scope="module")
def corpora():
    """The same QA corpus, built by each package's own code."""
    return j_build_corpus(60, seed=0), build_corpus(60, seed=0)


def _pair(corpora, *, batch=8, capacity=512, fused=True, tenants=None,
          j_extra=None, t_extra=None):
    """A JAX engine and a port engine (CPU) over the same corpus; each
    package's observability objects come in through ``*_extra``."""
    jpairs, tpairs = corpora
    by_id = {p.qa_id: p for p in tpairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    kw = dict(dim=384, capacity=capacity, value_len=48, ttl=None,
              threshold=0.8)
    jreg = treg = None
    if tenants is not None:
        jreg = JRegistry(tuple(JSpec(name=n, threshold=t)
                               for n, t in tenants))
        treg = TenantRegistry(tuple(TenantSpec(name=n, threshold=t)
                                    for n, t in tenants))
    jeng = JEngine(JConfig(**kw), JBackend(jpairs), judge=judge,
                   batch_size=batch, use_fused_step=fused, registry=jreg,
                   **(j_extra or {}))
    teng = CachedEngine(CacheConfig(**kw), SimulatedLLMBackend(tpairs),
                        judge=judge, batch_size=batch, use_fused_step=fused,
                        registry=treg, device="cpu", **(t_extra or {}))
    return jeng, teng


def _requests(pairs, rows, **kw):
    """(JAX, port) requests for corpus rows (ints) and novel texts."""
    out = []
    for cls in (JRequest, Request):
        reqs = []
        for r in rows:
            if isinstance(r, int):
                p = pairs[r]
                reqs.append(cls(query=p.question, category=p.category,
                                source_id=p.qa_id,
                                semantic_key=p.semantic_key, **kw))
            else:
                reqs.append(cls(query=r, category="novel", **kw))
        out.append(reqs)
    return out


def _close(a: float, b: float) -> bool:
    """Within SCORE_TOL, or the same infinity (a row that sees no slot)."""
    return a == b or abs(a - b) <= SCORE_TOL


def _same_why(j, t):
    assert t.keys() == j.keys()
    for key in j:
        if key == "score":
            assert _close(t[key], j[key]), (t[key], j[key])
        elif key == "topk":
            assert len(t[key]) == len(j[key])
            for a, b in zip(j[key], t[key]):
                assert (b["slot"], b["source_id"]) == \
                    (a["slot"], a["source_id"])
                assert _close(b["score"], a["score"])
        else:
            assert t[key] == j[key], key


def _same_responses(jresp, tresp):
    assert len(jresp) == len(tresp)
    for j, t in zip(jresp, tresp):
        assert (t.answer, t.cached, t.error, t.trace_id) == \
            (j.answer, j.cached, j.error, j.trace_id)
        assert _close(t.score, j.score)
        assert (t.why is None) == (j.why is None)
        if j.why is not None:
            _same_why(j.why, t.why)


# --------------------------------------------------------------------- #
RETENTION = {
    "head": dict(sample_rate=0.0, head=3),
    "rate": dict(sample_rate=0.3, head=0),
    "slow": dict(sample_rate=0.0, head=0, slow_threshold_s=0.05),
    "ring": dict(sample_rate=1.0, head=2, max_traces=4),
}


@pytest.mark.parametrize("case", sorted(RETENTION))
def test_tracer_retention_matches_jax_step_by_step(case):
    jt = JTracer(JTraceConfig(**RETENTION[case]))
    tt = Tracer(TraceConfig(**RETENTION[case]))
    e2e = np.random.default_rng(3).exponential(0.03, size=40)
    for i, x in enumerate(e2e):
        a, b = jt.start(stage=i), tt.start(stage=i)
        a.add("embed", 0.0, float(x) / 2)
        b.add("embed", 0.0, float(x) / 2)
        jt.finish(a, e2e_s=float(x))
        tt.finish(b, e2e_s=float(x))
        assert (tt.started, tt.finished, tt.retained) == \
            (jt.started, jt.finished, jt.retained), i
        assert [t.trace_id for t in tt.traces()] == \
            [t.trace_id for t in jt.traces()], i
    assert 0 < len(tt.traces()) < len(e2e)
    assert tt.drain() == jt.drain()
    assert tt.traces() == []


@pytest.mark.parametrize("fused", [True, False])
def test_engine_spans_match_jax(corpora, fused):
    """Same span names in the same order per request; on the sync path the
    spans tile the batch's wall time, so span sum == e2e."""
    jeng, teng = _pair(
        corpora, fused=fused,
        j_extra=dict(tracer=JTracer(JTraceConfig(sample_rate=1.0, head=0))),
        t_extra=dict(tracer=Tracer(TraceConfig(sample_rate=1.0, head=0))))
    pairs = corpora[1]
    jeng.warm(corpora[0][:30])
    teng.warm(pairs[:30])
    jreq, treq = _requests(pairs, [0, 1, NOVEL[0], 2, 40, NOVEL[1], 3, 4,
                                   41, NOVEL[2], 5])
    _same_responses(jeng.process(jreq), teng.process(treq))
    jtr, ttr = jeng.tracer.traces(), teng.tracer.traces()
    assert len(ttr) == len(jtr) == len(treq)
    for a, b in zip(jtr, ttr):
        assert [s.name for s in b.spans] == [s.name for s in a.spans]
        assert b.meta == a.meta and b.trace_id == a.trace_id
        assert set(s.name for s in b.spans) <= set(STAGES)
        assert b.span_sum_s == pytest.approx(b.e2e_s, rel=1e-9)
    assert set(teng.tracer.stage_decomposition()) == \
        set(jeng.tracer.stage_decomposition())


def test_tracing_off_allocates_nothing(corpora):
    _, teng = _pair(corpora)
    assert not teng.tracer.collecting
    teng.process([Request(query="off-path probe")])
    assert (teng.tracer.started, teng.tracer.finished) == (0, 0)
    assert teng.tracer.traces() == []


@pytest.mark.parametrize("query", [0, 40, NOVEL[3]])
def test_explain_matches_jax(corpora, query):
    """The dry-run ``why`` of a hit, a paraphrase and a miss; a pure peek
    in both packages."""
    jeng, teng = _pair(corpora)
    jeng.warm(corpora[0][:30])
    teng.warm(corpora[1][:30])
    text = corpora[1][query].question if isinstance(query, int) else query
    lookups = teng.stats.host()["lookups"]
    _same_why(jeng.explain(text), teng.explain(text))
    assert teng.stats.host()["lookups"] == lookups


def test_explain_tenant_override_matches_jax(corpora):
    jeng, teng = _pair(corpora, tenants=(("acme", 0.95), ("globex", None)))
    jeng.warm(corpora[0][:10], tenant="acme")
    teng.warm(corpora[1][:10], tenant="acme")
    q = corpora[1][0].question
    for tenant in ("acme", "globex"):
        jw, tw = jeng.explain(q, tenant=tenant), teng.explain(q, tenant=tenant)
        _same_why(jw, tw)
    assert tw["threshold_source"] == "policy"
    assert teng.explain(q, tenant="acme")["threshold_source"] == "tenant"


@pytest.mark.parametrize("explain_all", [False, True])
def test_request_explain_matches_jax(corpora, explain_all):
    jeng, teng = _pair(corpora, j_extra=dict(explain_responses=explain_all),
                       t_extra=dict(explain_responses=explain_all))
    jeng.warm(corpora[0][:30])
    teng.warm(corpora[1][:30])
    rows = [0, NOVEL[4], 41, 1, NOVEL[5]]
    jreq, treq = _requests(corpora[1], rows)
    for reqs, cls in ((jreq, JRequest), (treq, Request)):
        for i in (0, 1):                       # rows 0 and 1 opt in
            reqs[i] = cls(**{**reqs[i].__dict__, "explain": True})
    jresp, tresp = jeng.process(jreq), teng.process(treq)
    _same_responses(jresp, tresp)
    assert [r.why is not None for r in tresp] == \
        [True, True] + [explain_all] * 3
    assert tresp[0].why["decision"] == "hit"
    assert tresp[1].why["decision"] == "miss"


@pytest.mark.parametrize("fused", [True, False])
def test_why_is_taken_before_the_step(corpora, fused):
    """A slab of 8 slots, full: the hit row's matched slot 0 and its other
    neighbours are overwritten by the same batch's misses. The ``why``
    must show the slab the decision was made on, as the JAX engine's
    does (its step's buffer donation forces that order)."""
    jeng, teng = _pair(corpora, capacity=8, fused=fused)
    pairs = corpora[1]
    jeng.warm(corpora[0][:8])
    teng.warm(pairs[:8])
    jreq, treq = _requests(pairs, [0] + NOVEL, explain=True)
    for reqs in (jreq, treq):
        for i in range(1, len(reqs)):
            reqs[i].source_id = 1000 + i
    jresp, tresp = jeng.process(jreq), teng.process(treq)
    _same_responses(jresp, tresp)
    why = tresp[0].why
    assert why["decision"] == "hit" and why["matched_slot"] == 0
    assert why["matched_source_id"] == pairs[0].qa_id
    assert [t["source_id"] for t in why["topk"]] == \
        [pairs[t["slot"]].qa_id for t in why["topk"]]
    # the slab after the step: slot 0 now holds the first miss
    assert int(teng.state.source_id[0]) == 1001


def test_event_log_matches_jax(corpora):
    """One event per batch, equal except its timings; the last batch is
    padded."""
    jeng, teng = _pair(corpora, j_extra=dict(events=JEventLog(capacity=16)),
                       t_extra=dict(events=EventLog(capacity=16)))
    jeng.warm(corpora[0][:20])
    teng.warm(corpora[1][:20])
    jreq, treq = _requests(corpora[1], [0, 1, NOVEL[0], 40, 2, NOVEL[1], 3,
                                        4, 41, NOVEL[2]])
    _same_responses(jeng.process(jreq), teng.process(treq))

    def untimed(log):
        return [{k: v for k, v in ev.items() if k not in TIMING_FIELDS}
                for ev in log.events()]
    assert untimed(teng.events) == untimed(jeng.events)
    assert len(teng.events) == 2
    assert teng.events.to_jsonl().count("\n") == 2


def _untimed_lines(text: str) -> list[str]:
    def family(line):
        if line.startswith("#"):
            return line.split()[2]
        return line.split("{")[0].split(" ")[0]
    return [ln for ln in text.splitlines()
            if not family(ln).startswith(TIMING_FAMILIES)]


def _families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


@pytest.mark.parametrize("tenants", [None, (("acme", None),
                                            ("globex", 0.9))])
def test_exposition_matches_jax_line_by_line(corpora, tenants):
    jtr = JTracer(JTraceConfig(sample_rate=1.0, head=0))
    ttr = Tracer(TraceConfig(sample_rate=1.0, head=0))
    jeng, teng = _pair(corpora, tenants=tenants, j_extra=dict(tracer=jtr),
                       t_extra=dict(tracer=ttr))
    names = ["default"] if tenants is None else [n for n, _ in tenants]
    for name in names:
        kw = {} if tenants is None else {"tenant": name}
        jeng.warm(corpora[0][:20], **kw)
        teng.warm(corpora[1][:20], **kw)
    jreq, treq = [], []
    for i, name in enumerate(names):
        kw = {} if tenants is None else {"tenant": name}
        a, b = _requests(corpora[1], [i, 40 + i, NOVEL[i], 2 + i], **kw)
        jreq += a
        treq += b
    _same_responses(jeng.process(jreq), teng.process(treq))
    from repro.obs import MetricsExporter as JExporter
    jtext = JExporter(jeng).render()
    ttext = MetricsExporter(teng).render()
    assert _untimed_lines(ttext) == _untimed_lines(jtext)
    assert _families(ttext) == _families(jtext)
    assert set(REQUIRED_FAMILIES) <= _families(ttext)
    assert "repro_slab_hits_total" in ttext
    assert 'stage="device_step"' in ttext


def test_required_families_on_a_fresh_stack():
    text = prometheus_text(ServingMetrics())
    assert set(REQUIRED_FAMILIES) <= _families(text)
    assert text == j_prometheus_text(JServingMetrics())


def test_cache_stats_read_in_one_copy(corpora):
    """The exposition and the event log read the five device counters
    through ``CacheStats.host()``, one stacked copy."""
    _, teng = _pair(corpora)
    teng.warm(corpora[1][:5])
    teng.process([Request(query=corpora[1][0].question),
                  Request(query=NOVEL[6])])
    host = teng.stats.host()
    assert host == {k: int(getattr(teng.stats, k)) for k in
                    ("lookups", "hits", "misses", "inserts",
                     "expired_evictions")}
    assert all(isinstance(v, int) for v in host.values())
    assert isinstance(teng.stats.lookups, torch.Tensor)
