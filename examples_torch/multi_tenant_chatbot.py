"""Multi-tenant cached chatbot on the PyTorch port: three isolation domains
sharing ONE device-resident semantic cache (DESIGN.md §13).

    PYTHONPATH=src python examples_torch/multi_tenant_chatbot.py [--device cpu]

Scenes over the simulated LLM API:

  1. *isolation*: "acme" caches an answer; "globex" asking the byte-
     identical question (cosine similarity 1.0) still misses: the
     partition map makes other tenants' entries invisible, not merely
     sub-threshold;
  2. *noisy neighbour*: "free" floods the scheduler while "acme"
     trickles; deficit-round-robin admission keeps the trickle tenant's
     latency flat instead of queueing it behind the flood;
  3. *accounting*: per-tenant hit/miss/insert/eviction counters from the
     device (TenancyState) and per-tenant latency percentiles from the
     host (ServingMetrics).

On CUDA each tenant's lookup runs the interval cosine top-k kernel, each
row searching only its tenant's slot range.
"""
import argparse
import asyncio
import json

from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SchedulerConfig, ServingMetrics,
                                 SimulatedLLMBackend,
                                 build_multi_tenant_workload)
from repro_torch.tenancy import TenantRegistry, TenantSpec

FLOOD = 240


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    registry = TenantRegistry((
        TenantSpec("acme", share=2.0, weight=2.0),
        TenantSpec("globex", share=1.0, weight=1.0),
        TenantSpec("free", share=1.0, weight=1.0),
    ))

    print("building corpus and warming each tenant's region ...")
    pairs = build_corpus(120, seed=0)
    backend = SimulatedLLMBackend(pairs, latency_per_call_s=0.02, block=True)
    engine = CachedEngine(
        CacheConfig(dim=384, capacity=3 * 4096, value_len=48, ttl=None,
                    threshold=0.8),
        backend, batch_size=16, registry=registry, device=device)
    for name in registry.names:
        engine.warm(pairs[:60], tenant=name)
    # run the serve path once outside the timed scenes (the reference
    # compiles it there), then zero the metrics
    engine.serve_batch([Request(query="compile warmup", tenant="acme")])
    engine.metrics = ServingMetrics()

    # -- scene 1: isolation at cosine 1.0 ------------------------------ #
    q = "is the artisanal coffee subscription available in belgium"
    first = engine.process([Request(query=q, tenant="acme")])[0]
    again = engine.process([Request(query=q, tenant="acme")])[0]
    cross = engine.process([Request(query=q, tenant="globex")])[0]
    print(f"isolation: acme first={first.cached} acme again={again.cached} "
          f"globex same bytes={cross.cached}  (True/False = hit/miss)")
    assert again.cached and not cross.cached

    async def noisy_neighbour():
        sched = SchedulerConfig(max_batch=16, max_wait_ms=3.0,
                                tenant_weights=registry.weights(),
                                max_queue_per_tenant=256)
        async with AsyncCacheServer(engine, sched) as server:
            # -- scene 2: noisy neighbour ------------------------------ #
            flood = build_multi_tenant_workload(
                pairs, FLOOD, tenants=["free"], skew=0.0, seed=7)
            vip = [Request(query=p.question, tenant="acme")
                   for p in pairs[:20]]      # warm entries -> pure hits

            flood_tasks = [asyncio.create_task(server.submit_request(r))
                           for r in flood]
            await asyncio.sleep(0.01)        # flood is queued first
            vip_resp = await asyncio.gather(
                *(server.submit_request(r) for r in vip))
            flood_resp = await asyncio.gather(*flood_tasks)
            vip_p95 = sorted(r.latency_s for r in vip_resp)[
                int(0.95 * (len(vip_resp) - 1))]
            print(f"noisy neighbour: acme served {len(vip_resp)} hits at "
                  f"p95={vip_p95 * 1e3:.1f}ms while free flooded "
                  f"{len(flood)} requests")
            return vip_resp, flood_resp, vip_p95

    vip_resp, flood_resp, vip_p95 = asyncio.run(noisy_neighbour())

    # -- scene 3: per-tenant accounting -------------------------------- #
    device_stats = engine.tenant_stats()
    host_stats = engine.metrics.summary()["tenants"]
    print("device-side per-tenant counters:")
    print(json.dumps(device_stats, indent=1))
    print("host-side per-tenant serving metrics:")
    print(json.dumps(host_stats, indent=1))

    # which flood rows hit, and how many coalesced onto an in-flight
    # twin, depend on timing; acme's and globex's rows do not
    def host_counts(name):
        return {k: host_stats[name][k] for k in ("lookups", "cache_hits")}
    return {"decisions": {"isolation": [first.cached, again.cached,
                                        cross.cached],
                          "vip_cached": [r.cached for r in vip_resp],
                          "vip_answers": [r.answer for r in vip_resp],
                          "flood_answered": sum(bool(r.answer)
                                                for r in flood_resp)},
            "scores": {"isolation": [first.score, again.score, cross.score],
                       "vip": [r.score for r in vip_resp]},
            "counters": {"acme": device_stats["acme"],
                         "globex": device_stats["globex"],
                         "acme_host": host_counts("acme"),
                         "globex_host": host_counts("globex")},
            "observed": {"free": device_stats["free"],
                         "free_host": host_stats["free"],
                         "vip_p95_s": vip_p95}}


if __name__ == "__main__":
    main()
