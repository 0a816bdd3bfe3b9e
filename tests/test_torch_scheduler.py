"""The port's async front end (``repro_torch.serving.scheduler``,
``server``, ``loadgen``) against the JAX package's, on the CPU: lockstep
waves equal to the sync engine and to the JAX async run request by request,
in-flight coalescing (exact and LSH-similar), DRR shares, load shedding,
the per-row backend-error split, drain on stop, and the TCP JSON-lines
wire; plus the four engine and backend repairs the scheduler relies on
(``Request``/``Response`` fields, ``serve_batch``'s keywords, a failed
backend call contained to its rows, ``SimulatedLLMBackend(block=)``)."""
import asyncio
import dataclasses
import json
import time

import pytest

from repro.core.types import CacheConfig as JConfig
from repro.data.qa_dataset import build_corpus as j_build_corpus
from repro.data.qa_dataset import build_test_queries as j_build_test_queries
from repro.obs import Tracer as JTracer
from repro.serving import AsyncCacheServer as JServer
from repro.serving import BackendError as JBackendError
from repro.serving import CachedEngine as JEngine
from repro.serving import Overloaded as JOverloaded
from repro.serving import Request as JRequest
from repro.serving import Response as JResponse
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import SimulatedLLMBackend as JBackend
from repro.serving import run_waves as j_run_waves
from repro.serving.metrics import ServingMetrics as JServingMetrics
from repro_torch.core.types import CacheConfig
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.obs import Tracer
from repro_torch.serving import (AsyncCacheServer, BackendError,
                                 CachedEngine, Overloaded, Request, Response,
                                 SchedulerConfig, SimulatedLLMBackend,
                                 build_workload, run_closed_loop, run_waves)
from repro_torch.serving.metrics import ServingMetrics

SCORE_TOL = 1e-5
STATS = ("lookups", "hits", "misses", "inserts", "expired_evictions")
DISTINCT = ["why is the sky blue at noon",
            "best sourdough starter feeding schedule",
            "how tall is mount kilimanjaro",
            "difference between alligators and crocodiles",
            "what causes aurora borealis displays",
            "recommend a jazz album from 1959",
            "do tides depend on the moon",
            "boiling point of ethanol at altitude"]


@dataclasses.dataclass(frozen=True)
class Pkg:
    """One package's serving names, so a test body runs on both."""

    name: str
    config: type
    engine: type
    backend: type
    request: type
    response: type
    server: type
    sched: type
    waves: object
    metrics: type
    tracer: type
    backend_error: type
    overloaded: type
    corpus: object
    queries: object


JAX = Pkg("jax", JConfig, JEngine, JBackend, JRequest, JResponse, JServer,
          JSchedulerConfig, j_run_waves, JServingMetrics, JTracer,
          JBackendError, JOverloaded, j_build_corpus, j_build_test_queries)
TORCH = Pkg("torch", CacheConfig, CachedEngine, SimulatedLLMBackend,
            Request, Response, AsyncCacheServer, SchedulerConfig, run_waves,
            ServingMetrics, Tracer, BackendError, Overloaded, build_corpus,
            build_test_queries)


@pytest.fixture(scope="module")
def corpora():
    return {p.name: p.corpus(120, seed=0) for p in (JAX, TORCH)}


def make_engine(pkg, pairs, *, batch_size=16, latency_s=0.0, block=False,
                capacity=4096, **kw):
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key
    cfg = pkg.config(dim=384, capacity=capacity, value_len=48, ttl=None,
                     threshold=0.8)
    backend = pkg.backend(pairs, latency_per_call_s=latency_s, block=block)
    if pkg is TORCH:
        kw["device"] = "cpu"
    return pkg.engine(cfg, backend, judge=judge, batch_size=batch_size, **kw)


def requests_of(pkg, queries):
    return [pkg.request(query=q.query, category=q.category,
                        source_id=q.source_id, semantic_key=q.semantic_key)
            for q in queries]


def stats_of(eng) -> dict:
    return {k: int(getattr(eng.stats, k)) for k in STATS}


def same_responses(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert (y.answer, y.cached, y.coalesced, y.error) == \
            (x.answer, x.cached, x.coalesced, x.error), i
        assert y.score == x.score or abs(y.score - x.score) <= SCORE_TOL, i


def same_json(a, b):
    """Equal key by key (and item by item), floats within SCORE_TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(b) == list(a)
        for key in a:
            same_json(a[key], b[key])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(b) == len(a)
        for x, y in zip(a, b):
            same_json(x, y)
    elif isinstance(a, float) and not isinstance(a, bool):
        assert b == a or abs(b - a) <= SCORE_TOL, (a, b)
    else:
        assert b == a, (a, b)


# --------------------------------------------------------------------- #
def test_waves_equal_sync_engine_and_jax_async(corpora):
    """run_waves(wave=max_batch) without coalescing reproduces the sync
    engine's batches: same decisions, answers, backend calls, counters
    and per-category hit rates, in the port and against the JAX run."""
    batch = 16
    runs = {}
    for pkg in (JAX, TORCH):
        pairs = corpora[pkg.name]
        reqs = requests_of(pkg, pkg.queries(pairs, n_per_category=12,
                                            seed=5))
        eng = make_engine(pkg, pairs, batch_size=batch)
        eng.warm(pairs)

        async def drive(eng=eng, reqs=reqs, pkg=pkg):
            sched = pkg.sched(max_batch=batch, max_wait_ms=50.0,
                              coalesce=False)
            async with pkg.server(eng, sched) as server:
                return await pkg.waves(server.submit_request, reqs,
                                       wave=batch)
        runs[pkg.name] = (eng, asyncio.run(drive()).responses)
    sync = make_engine(TORCH, corpora["torch"], batch_size=batch)
    sync.warm(corpora["torch"])
    sync_resp = sync.process(requests_of(
        TORCH, build_test_queries(corpora["torch"], n_per_category=12,
                                  seed=5)))
    (jeng, jresp), (teng, tresp) = runs["jax"], runs["torch"]
    same_responses(sync_resp, tresp)
    same_responses(jresp, tresp)
    assert any(r.cached for r in tresp) and not all(r.cached for r in tresp)
    assert teng.backend.calls == sync.backend.calls == jeng.backend.calls
    assert stats_of(teng) == stats_of(sync) == stats_of(jeng)
    rates = {c: m["hit_rate"] for c, m in
             teng.metrics.summary()["categories"].items()}
    for other in (sync, jeng):
        assert rates == {c: m["hit_rate"] for c, m in
                         other.metrics.summary()["categories"].items()}


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=lambda p: p.name)
def test_herd_of_identical_misses_costs_one_call(corpora, pkg):
    """A leader miss held in flight by a blocking backend; seven identical
    requests arriving meanwhile attach to it."""
    eng = make_engine(pkg, corpora[pkg.name], latency_s=0.2, block=True)
    q = "what is the airspeed velocity of an unladen swallow"

    async def herd():
        sched = pkg.sched(max_batch=8, max_wait_ms=2.0)
        async with pkg.server(eng, sched) as server:
            first = asyncio.create_task(server.submit(q))
            await asyncio.sleep(0.05)   # the leader is in its backend call
            rest = [asyncio.create_task(server.submit(q)) for _ in range(7)]
            return await asyncio.gather(first, *rest)

    responses = asyncio.run(herd())
    assert eng.backend.calls == 1
    assert [r.coalesced for r in responses] == [False] + [True] * 7
    assert len({r.answer for r in responses}) == 1
    assert eng.metrics.coalesced_calls == 7
    assert int(eng.stats.lookups) == 1


#: (leader, follower) texts and whether the follower attaches at cosine
#: >= 0.8: a collision above the bound attaches; a collision below it is
#: rejected by the exact check; a paraphrase in no shared bucket is missed
LSH_CASES = [
    ("can i expedite the delivery", "hey can i expedite the delivery", True),
    ("why the wifi is not visible",
     "sorry to bother you why the wifi is not visible", False),
    ("i want to know how long does it take to get my parcel",
     "excuse me i want to know how long does it take to get my parcel",
     False),
    ("why is there a delay with the second package",
     "why does is there a delay with the second box", True),
]


def test_lsh_similarity_coalescing_matches_jax(corpora):
    queries = [c[0] for c in LSH_CASES] + [c[1] for c in LSH_CASES]
    want = [False] * len(LSH_CASES) + [c[2] for c in LSH_CASES]
    runs = {}
    for pkg in (JAX, TORCH):
        eng = make_engine(pkg, corpora[pkg.name])

        async def drive(eng=eng, pkg=pkg):
            sched = pkg.sched(max_batch=8, max_wait_ms=20.0,
                              coalesce_sim=0.8)
            async with pkg.server(eng, sched) as server:
                out = await asyncio.gather(
                    *(server.submit(q) for q in queries))
                return out, server.scheduler
        responses, sched = asyncio.run(drive())
        assert [r.coalesced for r in responses] == want, pkg.name
        assert sched._pending == {} and sched._sim_buckets == {}
        runs[pkg.name] = (eng, responses)
    same_responses(runs["jax"][1], runs["torch"][1])
    assert runs["torch"][0].backend.calls == runs["jax"][0].backend.calls \
        == len(queries) - sum(want)


class _FakeEngine:
    """Duck-typed engine recording batch compositions: the scheduler only
    touches ``serve_batch``, ``metrics``, ``tracer``, ``registry`` and
    ``explain_all``."""

    def __init__(self, pkg, delay_s=0.0):
        self.pkg = pkg
        self.metrics = pkg.metrics()
        self.tracer = pkg.tracer()
        self.registry = None
        self.explain_all = False
        self.delay_s = delay_s
        self.batches: list[list[str]] = []

    def serve_batch(self, batch, record_path_latency=True, traces=None):
        self.batches.append([r.tenant for r in batch])
        if self.delay_s:
            time.sleep(self.delay_s)
        return [self.pkg.response(answer=f"ok:{r.query}", cached=False,
                                  score=0.0, latency_s=0.0) for r in batch]


def test_drr_shares_match_jax():
    """Weight-3 and weight-1 tenants both backlogged behind a busy engine:
    the same batch compositions in both packages, ~3:1 when contended."""
    runs = {}
    for pkg in (JAX, TORCH):
        eng = _FakeEngine(pkg, delay_s=0.02)
        sched = pkg.sched(max_batch=8, max_wait_ms=1000.0, coalesce=False,
                          tenant_weights={"vip": 3.0, "std": 1.0})

        async def drive(eng=eng, sched=sched, pkg=pkg):
            async with pkg.server(eng, sched) as server:
                tasks = [asyncio.create_task(server.submit_request(
                    pkg.request(query=f"{t}{i}", tenant=t)))
                    for i in range(24) for t in ("vip", "std")]
                await asyncio.gather(*tasks)
        asyncio.run(drive())
        runs[pkg.name] = eng.batches
    assert runs["torch"] == runs["jax"]
    contended = [b for b in runs["torch"] if "vip" in b and "std" in b]
    assert contended
    assert sum(b.count("vip") for b in contended) >= \
        2 * sum(b.count("std") for b in contended)


def test_shed_raises_overloaded_like_jax():
    runs = {}
    for pkg in (JAX, TORCH):
        eng = _FakeEngine(pkg, delay_s=0.02)
        sched = pkg.sched(max_batch=2, max_queue=2, max_wait_ms=1000.0,
                          coalesce=False, overload_policy="shed")

        async def drive(eng=eng, sched=sched, pkg=pkg):
            async with pkg.server(eng, sched) as server:
                return await asyncio.gather(
                    *(server.submit(f"q{i}") for i in range(10)),
                    return_exceptions=True)
        out = asyncio.run(drive())
        runs[pkg.name] = [type(r).__name__ for r in out]
        shed = [r for r in out if isinstance(r, pkg.overloaded)]
        assert shed and len(shed) == eng.metrics.resilience.shed
    assert runs["torch"] == runs["jax"]
    assert runs["torch"].count("Response") == 2


class _DownBackend:
    """A backend whose every call raises, counting the calls."""

    latency_per_call_s = 0.0
    cost_per_call_usd = 0.002

    def __init__(self):
        self.calls = 0

    def generate(self, queries, semantic_keys=None):
        self.calls += 1
        raise RuntimeError("backend down")


def test_backend_errors_split_per_row_like_jax(corpora):
    """A hit row of the flush resolves; the miss row and the waiter that
    attached to it get a BackendError; no scheduler state is left."""
    runs = {}
    for pkg in (JAX, TORCH):
        pairs = corpora[pkg.name]
        eng = make_engine(pkg, pairs)
        eng.warm(pairs)
        eng.backend = _DownBackend()
        miss_q = DISTINCT[0]

        async def drive(eng=eng, pkg=pkg, pairs=pairs, miss_q=miss_q):
            sched = pkg.sched(max_batch=4, max_wait_ms=20.0)
            async with pkg.server(eng, sched) as server:
                out = await asyncio.gather(
                    server.submit(pairs[0].question), server.submit(miss_q),
                    server.submit(miss_q), return_exceptions=True)
                return out, server.scheduler
        (hit, miss, waiter), sched = asyncio.run(drive())
        assert isinstance(hit, pkg.response) and hit.cached and hit.answer
        assert isinstance(miss, pkg.backend_error)
        assert isinstance(waiter, pkg.backend_error)
        assert eng.backend.calls == 1
        assert eng.metrics.resilience.backend_failures == 1
        assert sched._pending == {}
        runs[pkg.name] = (str(miss), hit.answer, stats_of(eng),
                          eng.metrics.summary()["latency_percentiles"]
                          .keys())
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][0] == "RuntimeError: backend down"


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=lambda p: p.name)
def test_stop_drains_the_queue(corpora, pkg):
    eng = make_engine(pkg, corpora[pkg.name])
    reqs = [pkg.request(query=q) for q in DISTINCT[:5]]

    async def submit_then_stop():
        server = pkg.server(eng, pkg.sched(max_batch=64,
                                           max_wait_ms=10_000.0))
        await server.start()
        tasks = [asyncio.create_task(server.submit_request(r))
                 for r in reqs]
        await asyncio.sleep(0.05)   # all queued, none flushed (64 / 10 s)
        await server.stop()         # the drain serves them
        with pytest.raises(RuntimeError, match="not running"):
            await server.submit("too late")
        return await asyncio.gather(*tasks)

    responses = asyncio.run(submit_then_stop())
    assert len(responses) == 5 and all(r.answer for r in responses)
    assert eng.backend.calls == 5 and int(eng.stats.inserts) == 5


def test_closed_loop_serves_every_request(corpora):
    pairs = corpora["torch"]
    eng = make_engine(TORCH, pairs)
    eng.warm(pairs)
    wl = build_workload(pairs, 60, burst_prob=0.2, burst_size=3, seed=9)

    async def drive():
        async with AsyncCacheServer(eng) as server:
            return await run_closed_loop(server.submit_request, wl,
                                         concurrency=8)

    res = asyncio.run(drive())
    assert len(res.responses) == 60
    assert all(r is not None and r.answer for r in res.responses)
    assert eng.metrics.queries + eng.metrics.coalesced_calls == 60
    assert res.achieved_qps > 0


def test_tcp_lines_match_jax(corpora):
    """A pipelined burst of identical known queries, one opted into
    ``explain``, and a malformed line: the same lines key by key in both
    packages, ``latency_s`` aside."""
    runs = {}
    for pkg in (JAX, TORCH):
        pairs = corpora[pkg.name]
        eng = make_engine(pkg, pairs)
        eng.warm(pairs)
        known = pairs[0].question

        async def client(eng=eng, pkg=pkg, known=known):
            sched = pkg.sched(max_batch=8, max_wait_ms=5.0)
            async with pkg.server(eng, sched) as server:
                try:
                    port = await server.serve_tcp("127.0.0.1", 0)
                except OSError as exc:       # loopback cannot bind here
                    pytest.skip(f"cannot bind loopback: {exc}")
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                lines = [{"id": i, "query": known} for i in range(4)]
                lines.append({"id": 4, "query": known, "explain": True})
                for obj in lines:
                    writer.write(json.dumps(obj).encode() + b"\n")
                writer.write(b"not json\n")
                await writer.drain()
                out = [json.loads(await reader.readline())
                       for _ in range(6)]
                writer.close()
                return out
        lines = asyncio.run(client())
        for line in lines:
            line.pop("latency_s", None)
        runs[pkg.name] = sorted(lines, key=lambda d: d.get("id", -1))
    tl = runs["torch"]
    same_json(runs["jax"], tl)
    answers = [l for l in tl if "answer" in l]
    assert [l["id"] for l in answers] == [0, 1, 2, 3, 4]
    assert all(l["cached"] for l in answers)
    assert sum(l["coalesced"] for l in answers) >= 4
    assert len([l for l in tl if "error" in l]) == 1


# --------------------------------------------------------------------- #
# the four repairs the scheduler depends on
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("cls", ["Request", "Response"])
def test_request_response_fields_match_jax(cls):
    """``coalesce_key`` reads ``session``, the scheduler's ``_serve``
    reads ``error``, ``degraded`` and ``near_hit``: every field of the
    JAX dataclass exists in the port with its default."""
    jcls, tcls = {"Request": (JRequest, Request),
                  "Response": (JResponse, Response)}[cls]

    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(tcls) == fields(jcls)


def test_serve_batch_takes_the_scheduler_keywords(corpora):
    """``serve_batch(batch, record_path_latency=False, traces=...)``, as
    the scheduler calls it: no path latency recorded, no trace touched
    when tracing is off."""
    runs = {}
    for pkg in (JAX, TORCH):
        pairs = corpora[pkg.name]
        eng = make_engine(pkg, pairs, batch_size=4)
        eng.warm(pairs[:20])
        batch = [pkg.request(query=pairs[0].question),
                 pkg.request(query=DISTINCT[1])]
        traces = [eng.tracer.start() for _ in batch]
        out = eng.serve_batch(batch, record_path_latency=False,
                              traces=traces)
        assert eng.metrics.summary()["latency_percentiles"] == {}
        runs[pkg.name] = out
    same_responses(runs["jax"], runs["torch"])


@pytest.mark.parametrize("fused", [True, False])
def test_backend_failure_is_contained_to_its_rows(corpora, fused):
    """The sync engine without a resilience config: a raising backend
    fails only the miss rows (``error`` set, out of the slab and, on the
    fused path, out of every counter); the hit row is served."""
    runs = {}
    for pkg in (JAX, TORCH):
        pairs = corpora[pkg.name]
        eng = make_engine(pkg, pairs, batch_size=4, use_fused_step=fused)
        eng.warm(pairs[:20])
        eng.backend = _DownBackend()
        out = eng.process([pkg.request(query=pairs[0].question,
                                       category="c"),
                           pkg.request(query=DISTINCT[2], category="c")])
        assert out[0].cached and not out[0].error
        assert out[1].error == "RuntimeError: backend down"
        assert not out[1].answer and not out[1].cached
        assert eng.metrics.resilience.backend_failures == 1
        assert eng.metrics.summary()["categories"]["c"]["lookups"] == 1
        runs[pkg.name] = (out, stats_of(eng), eng.metrics.queries)
    same_responses(runs["jax"][0], runs["torch"][0])
    assert runs["torch"][1:] == runs["jax"][1:]
    assert runs["torch"][1]["inserts"] == 20


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=lambda p: p.name)
def test_simulated_backend_block_sleeps_one_round_trip(corpora, pkg):
    backend = pkg.backend(corpora[pkg.name], latency_per_call_s=0.05,
                          block=True)
    t0 = time.perf_counter()
    res = backend.generate(DISTINCT[:3])
    assert time.perf_counter() - t0 >= 0.05
    assert res.latency_s == pytest.approx(0.15) and backend.calls == 3
    quick = pkg.backend(corpora[pkg.name], latency_per_call_s=5.0)
    t0 = time.perf_counter()
    quick.generate(DISTINCT[:1])
    assert time.perf_counter() - t0 < 1.0
