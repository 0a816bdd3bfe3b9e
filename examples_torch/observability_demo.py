"""Observability walkthrough on the PyTorch port (DESIGN.md §18): serve
traffic through the async stack with tracing + attribution + the event
ring on, then drain all three planes: a retained request trace, an
``explain`` decision record, and a live ``GET /metrics`` scrape.

    PYTHONPATH=src python examples_torch/observability_demo.py [--device cpu]
"""
import argparse
import asyncio
import json

from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.obs import EventLog, TraceConfig, Tracer
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SchedulerConfig, SimulatedLLMBackend)
from repro_torch.tenancy import TenantRegistry, TenantSpec

WANTED = ("repro_queries_total", "repro_coalesced_requests_total",
          "repro_tenant_hits_total", "repro_latency_quantile",
          "repro_trace_stage_seconds")


async def scrape(server) -> str:
    try:
        port = await server.serve_metrics()
    except OSError as exc:          # sandboxed environment: render inline
        print(f"(no loopback sockets: {exc}; rendering directly)")
        return server.exporter.render()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /metrics HTTP/1.1\r\nHost: x\r\n\r\n")
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw.decode().partition("\r\n\r\n")[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    pairs = build_corpus(200, seed=0)
    queries = build_test_queries(pairs, n_per_category=12, seed=1)

    # two tenants, one with a stricter hit threshold, so the explain record
    # has a tenant-sourced edge to attribute
    registry = TenantRegistry((TenantSpec(name="acme", threshold=0.9),
                               TenantSpec(name="globex")))
    engine = CachedEngine(
        CacheConfig(dim=384, capacity=8192, value_len=48, ttl=None,
                    threshold=0.8),
        SimulatedLLMBackend(pairs, latency_per_call_s=0.01),
        batch_size=16, registry=registry,
        tracer=Tracer(TraceConfig(sample_rate=1.0, head=8, max_traces=512)),
        events=EventLog(capacity=256), device=device)
    for name in registry.names:
        engine.warm(pairs[:100], tenant=name)

    async def serve():
        sched = SchedulerConfig(max_batch=16, max_wait_ms=5.0)
        async with AsyncCacheServer(engine, sched) as server:
            print("serving 48 queries (async scheduler, tracing on) ...")
            reqs = [Request(query=q.query, category=q.category,
                            source_id=q.source_id,
                            semantic_key=q.semantic_key,
                            tenant=registry.names[i % 2])
                    for i, q in enumerate(queries[:48])]
            # a duplicate herd rides along so the trace set shows coalescing
            herd = [Request(query="what exactly does the warranty cover",
                            tenant="acme") for _ in range(4)]
            responses = await asyncio.gather(
                *(server.submit_request(r) for r in reqs + herd))

            print("\n--- one retained request trace " + "-" * 30)
            trace = engine.tracer.traces()[-1]
            print(json.dumps(trace.to_dict(), indent=1))

            print("\n--- per-stage decomposition over retained traces "
                  + "-" * 12)
            stages = engine.tracer.stage_decomposition()
            print(json.dumps(stages, indent=1))

            print("\n--- explain: why would this query hit/miss right now? "
                  + "-" * 6)
            why = engine.explain(pairs[0].question, tenant="acme")
            print(json.dumps(why, indent=1))

            print("\n--- last structured events " + "-" * 34)
            events = engine.events.events()[-3:]
            for ev in events:
                print(json.dumps(ev, sort_keys=True))

            print("\n--- GET /metrics (Prometheus text exposition) "
                  + "-" * 15)
            text = await scrape(server)
            for line in text.splitlines():
                if any(line.startswith(w) for w in WANTED):
                    print(line)
            print(f"({len(text.splitlines())} exposition lines total)")
            return responses, stages, why, events, text

    responses, stages, why, events, text = asyncio.run(serve())
    families = sorted({w for w in WANTED for line in text.splitlines()
                       if line.startswith(w)})
    # which rows share a batch or coalesce (so hit, miss or pay a call),
    # and every span's length, depend on timing; the explain record's
    # decision and the exposition's families do not
    return {"decisions": {
                "answered": sum(bool(r.answer) for r in responses),
                "explain": {k: why[k] for k in (
                    "decision", "matched_source_id", "threshold_source",
                    "band", "in_band", "session_fused", "tenant",
                    "dry_run")},
                "families": families,
                "stages": sorted(stages)},
            "scores": {"explain": [why["score"],
                                   why["effective_threshold"]]},
            "counters": {},
            "observed": {"cached": [r.cached for r in responses],
                         "answers": [r.answer for r in responses],
                         # the misses inserted so far depend on timing,
                         # and so may the neighbours below the match
                         "explain_topk": why["topk"],
                         "events": events,
                         "exposition_lines": len(text.splitlines())}}


if __name__ == "__main__":
    main()
