"""Serving driver: ``python -m repro_torch.launch.serve [--device cuda|cpu]``.

Runs the paper's serve loop on the port: warm the cache with the QA corpus,
stream the test queries through ``CachedEngine`` in fixed batches, and
print the paper's metrics as JSON. The defaults are those of
``python -m repro.launch.serve``: 2,000 QA pairs and 500 test queries per
category, a 16,384-slot slab, d=384, batch 128, threshold 0.8, the fused
step. ``--device`` defaults to ``cuda`` and fails without it.

``--index ivf`` serves through ``IVFIndex(ncentroids=128, nprobe=16,
bucket_cap=1024)``, as ``repro.launch.serve --index ivf`` does: per batch
the cosine kernel probes the 16 best of 128 centroids and the IVF kernel
scores the probed buckets' members. It composes with ``--tenants``,
``--key-dtype`` and ``--no-fused``.

``--tenants N`` runs the multi-tenant path of ``repro.launch.serve
--tenants N`` (sync scheduler): N uniform tenants, a slab of
``max(16384, 8 * corpus) * N`` slots split into N regions, each warmed
with the whole corpus, then a Zipf-skewed stream of ``4 * queries``
requests (``--tenant-skew``); the device-side per-tenant counters are
printed after the metrics.

``--scheduler async`` routes the workload through the continuous
micro-batching scheduler (``AsyncCacheServer``, DESIGN.md §12) instead of
the sync batch loop, as ``repro.launch.serve --scheduler async`` does:
open-loop Poisson arrivals at ``--rate-qps``, or ``--concurrency``
closed-loop clients when no rate is given, with in-flight duplicate
coalescing (``--no-coalesce`` turns it off) and DRR admission over the
tenants. One warm-up batch is served and the metrics reset before the
clock starts, so the kernel's build at first use enters no percentile.
``--metrics-port`` serves ``/metrics``, ``/traces`` and ``/events`` over
HTTP for the run's duration; ``--trace-sample`` / ``--trace-slow-ms``
turn on request tracing and print the per-stage decomposition.

``--shards S`` splits the slab over S shards of a ``DistributedCache``
(``make_mesh((S,), ("data",))`` on ``--device``; DESIGN.md §19): each
batch's lookup runs one search per shard over its N/S slots, merged into
the same decisions as one shard's. It composes with ``--tenants`` (each
region split S ways), ``--index ivf`` (one index per shard) and
``--key-dtype``. ``--shards cuda:0,cpu,cuda:0,cpu`` names one device a
shard instead (``make_mesh(..., device=[...])``): the engine's device is
the first, the controller's. ``repro.launch.serve`` has no such flag; its
engine takes a mesh.

``--backend model`` answers the misses with a real decoder instead of the
simulated API, as ``repro.launch.serve --backend model`` does: ``--arch``
(default ``yi-6b``; any dense, moe, ssm, hybrid or vlm config, e.g.
``grok-1-314b``, ``llama4-maverick-400b-a17b``, ``mamba2-130m``,
``hymba-1.5b``, ``qwen2-vl-2b`` (text only, no prefix); the audio
``musicgen-large`` raises a ValueError: the text miss path has one
codebook, and the reference fails there too) at its reduced width,
weights drawn from a seeded generator on the device (nothing is
downloaded). ``--full-width`` takes the published width instead
(``build(reduced=False)``), and ``--n-layers N`` cuts the depth: grok-1 and
llama4 do not fit one 80 GB card whole (``--n-layers 2``: two MoE layers
of grok-1, one dense and one MoE layer of llama4).
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
from typing import Sequence

import torch

from repro_torch.configs import get_arch
from repro_torch.core.distributed import make_mesh
from repro_torch.core.index import IVFIndex
from repro_torch.core.policy import AdaptiveThreshold
from repro_torch.core.types import CacheConfig
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import Model
from repro_torch.obs.trace import TraceConfig, Tracer
from repro_torch.serving.engine import CachedEngine, Request, Response
from repro_torch.serving.llm_backend import ModelBackend, SimulatedLLMBackend
from repro_torch.serving.loadgen import (LoadResult,
                                         build_multi_tenant_workload,
                                         run_closed_loop, run_open_loop)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import SchedulerConfig
from repro_torch.serving.server import AsyncCacheServer
from repro_torch.tenancy import TenantRegistry

KEY_DTYPES = {"f32": torch.float32, "int8": torch.int8}


def run(*, log=print, **kw
        ) -> tuple[CachedEngine, list[Request], list[Response]]:
    """Build and warm the engine (``build(**kw)``), then serve the workload.
    Returns the engine, the requests and their responses."""
    engine, requests = build(log=log, **kw)
    log(f"serving {len(requests)} queries (sync batches) ...")
    return engine, requests, engine.process(requests)


def _mesh(shards: int | Sequence[str], device: str):
    """``--shards``: a count of shards on ``device``, or a device each."""
    if isinstance(shards, int):
        return make_mesh((shards,), ("data",), device=device) if shards \
            else None
    return make_mesh((len(shards),), ("data",), device=list(shards))


def _shards_arg(text: str) -> int | list[str]:
    return int(text) if text.isdigit() else text.split(",")


def build(*, corpus: int = 2000, queries: int = 500, threshold: float = 0.8,
          ttl: float | None = None, batch: int = 128, policy: str = "fixed",
          fused: bool = True, device: str = "cuda", key_dtype: str = "f32",
          tenants: int = 0, tenant_skew: float = 1.0, index: str = "exact",
          backend: str = "sim", arch: str = "yi-6b", reduced: bool = True,
          n_layers: int | None = None, tracer: Tracer | None = None,
          shards: int | Sequence[str] = 0, log=print
          ) -> tuple[CachedEngine, list[Request]]:
    """The warmed engine and the requests to serve. ``tenants > 0``
    partitions the slab into that many uniform tenant regions and builds a
    multi-tenant stream; ``index`` is ``"exact"`` or ``"ivf"``.
    ``backend="model"`` puts ``arch`` (reduced unless ``reduced=False``;
    ``n_layers`` layers if given) behind the cache, its weights drawn from
    a generator on ``device`` seeded with 0 (``repro.launch.serve`` draws
    them from ``PRNGKey(0)``).
    ``tracer`` goes to the engine. ``shards > 0`` serves through a
    ``DistributedCache`` of that many shards on ``device``; a sequence of
    devices, through one shard on each, the engine on the first."""
    pairs = build_corpus(corpus, seed=0)
    tests = build_test_queries(pairs, n_per_category=queries, seed=1)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key

    registry = None
    if tenants > 0:
        registry = TenantRegistry.uniform(
            [f"tenant-{i}" for i in range(tenants)])
    # multi-tenant: every tenant's region must hold the warm corpus
    capacity = max(16384, 8 * corpus) * max(1, tenants)
    cfg = CacheConfig(dim=384, capacity=capacity, value_len=48,
                      ttl=ttl, threshold=threshold,
                      key_dtype=KEY_DTYPES[key_dtype])
    if backend == "sim":
        llm = SimulatedLLMBackend(pairs)
    elif backend == "model":
        config = get_arch(arch)
        if reduced:
            config = config.reduced()
        if n_layers is not None:
            config = dataclasses.replace(config, n_layers=n_layers)
        model = Model(config, device=device)
        model.init_params(torch.Generator(device=model.device).manual_seed(0))
        llm = ModelBackend(model, HashTokenizer(vocab_size=config.vocab))
    else:
        raise ValueError(f"unknown backend {backend!r}")
    engine = CachedEngine(
        cfg, llm, judge=judge, batch_size=batch,
        policy=AdaptiveThreshold(init=threshold) if policy == "adaptive"
        else None,
        use_fused_step=fused, registry=registry, device=device if
        isinstance(shards, int) else shards[0], tracer=tracer,
        mesh=_mesh(shards, device),
        index=IVFIndex(ncentroids=128, nprobe=16, bucket_cap=1024)
        if index == "ivf" else None)
    if registry is None:
        log(f"warming cache with {len(pairs)} QA pairs ...")
        engine.warm(pairs)
        requests = [Request(query=q.query, category=q.category,
                            source_id=q.source_id,
                            semantic_key=q.semantic_key) for q in tests]
    else:
        log(f"warming {tenants} tenant regions with {len(pairs)} QA pairs "
            "each ...")
        for name in registry.names:
            engine.warm(pairs, tenant=name)
        requests = build_multi_tenant_workload(
            pairs, len(tests), tenants=list(registry.names),
            skew=tenant_skew, seed=1)
    return engine, requests


def warm_serve_path(engine: CachedEngine) -> None:
    """Serve one batch, then zero the engine's metrics. On the card the
    first batch builds the kernels (nvcc) on the scheduler's worker thread
    while requests queue; that build must enter no percentile."""
    tenant = "default" if engine.registry is None \
        else engine.registry.names[0]
    engine.serve_batch([Request(query="serve-path compile warmup",
                                tenant=tenant)])
    engine.metrics = ServingMetrics()


async def serve_async(engine: CachedEngine, requests: list[Request], *,
                      max_wait_ms: float = 5.0, coalesce: bool = True,
                      rate_qps: float | None = None, concurrency: int = 32,
                      metrics_port: int | None = None,
                      log=print) -> LoadResult:
    """Drive ``requests`` through an ``AsyncCacheServer`` whose flush size
    is the engine's batch size: open loop at ``rate_qps``, else closed
    loop with ``concurrency`` clients. ``metrics_port`` serves the
    exposition over HTTP while the run lasts."""
    sched = SchedulerConfig(
        max_batch=engine.batcher.batch_size, max_wait_ms=max_wait_ms,
        coalesce=coalesce, tenant_weights=None if engine.registry is None
        else engine.registry.weights())
    async with AsyncCacheServer(engine, sched) as server:
        if metrics_port is not None:
            port = await server.serve_metrics(port=metrics_port)
            log(f"/metrics exposition on http://127.0.0.1:{port}/metrics")
        if rate_qps:
            return await run_open_loop(server.submit_request, requests,
                                       rate_qps)
        return await run_closed_loop(server.submit_request, requests,
                                     concurrency=concurrency)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("sim", "model"), default="sim")
    ap.add_argument("--arch", default="yi-6b",
                    help="arch for --backend model (reduced variant)")
    ap.add_argument("--full-width", dest="reduced", action="store_false",
                    help="--backend model at the arch's published width")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="--backend model: cut the arch to this many layers")
    ap.add_argument("--corpus", type=int, default=2000,
                    help="QA pairs per category")
    ap.add_argument("--queries", type=int, default=500,
                    help="test queries per category")
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--ttl", type=float, default=None)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--index", choices=("exact", "ivf"), default="exact",
                    help="ANN index plugin behind the cache")
    ap.add_argument("--policy", choices=("fixed", "adaptive"),
                    default="fixed", help="threshold policy plugin")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    help="use separate lookup+insert instead of the fused "
                         "step")
    ap.add_argument("--snapshot", default=None,
                    help="save the full cache runtime here after serving")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the CUDA kernel) or cpu (the "
                         "plain PyTorch path)")
    ap.add_argument("--key-dtype", choices=tuple(KEY_DTYPES), default="f32",
                    help="slab key storage: f32 or int8")
    ap.add_argument("--tenants", type=int, default=0,
                    help="partition the cache into N tenant regions and "
                         "serve a multi-tenant workload (0 = single-tenant)")
    ap.add_argument("--tenant-skew", type=float, default=1.0,
                    help="Zipf skew of tenant popularity (0 = uniform)")
    ap.add_argument("--shards", type=_shards_arg, default=0,
                    help="split the slab over S shards of a "
                         "DistributedCache (0 = unsharded), or over one "
                         "shard a device of a comma list (cuda:0,cpu,...)")
    ap.add_argument("--scheduler", choices=("sync", "async"),
                    default="sync",
                    help="sync batch loop vs async continuous micro-batching "
                         "with in-flight coalescing")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="async admission deadline per micro-batch")
    ap.add_argument("--rate-qps", type=float, default=None,
                    help="async: open-loop Poisson arrival rate; omit for "
                         "closed-loop")
    ap.add_argument("--concurrency", type=int, default=32,
                    help="async closed-loop client count")
    ap.add_argument("--no-coalesce", dest="coalesce", action="store_false",
                    help="disable in-flight duplicate coalescing")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="async: serve the Prometheus-style /metrics (+ "
                         "/traces, /events) exposition on this HTTP port "
                         "for the run's duration")
    ap.add_argument("--trace-sample", type=float, default=0.0,
                    help="request-trace retention rate in [0,1] "
                         "(0 = tracing off, the default)")
    ap.add_argument("--trace-slow-ms", type=float, default=None,
                    help="always retain traces slower than this many ms, "
                         "even when the rate sampler would drop them")
    args = ap.parse_args(argv)
    tracer = None
    if args.trace_sample > 0.0 or args.trace_slow_ms is not None:
        tracer = Tracer(TraceConfig(
            sample_rate=args.trace_sample,
            slow_threshold_s=None if args.trace_slow_ms is None
            else args.trace_slow_ms / 1000.0))
    engine, requests = build(
        corpus=args.corpus, queries=args.queries, threshold=args.threshold,
        ttl=args.ttl, batch=args.batch, policy=args.policy, fused=args.fused,
        device=args.device, key_dtype=args.key_dtype, tenants=args.tenants,
        tenant_skew=args.tenant_skew, index=args.index, backend=args.backend,
        arch=args.arch, reduced=args.reduced, n_layers=args.n_layers,
        tracer=tracer, shards=args.shards)
    if args.scheduler == "sync":
        print(f"serving {len(requests)} queries (sync batches) ...")
        engine.process(requests)
    else:
        mode = (f"open-loop {args.rate_qps:.0f} qps" if args.rate_qps
                else f"closed-loop x{args.concurrency}")
        print(f"serving {len(requests)} queries (async scheduler, {mode}) "
              "...")
        warm_serve_path(engine)
        res = asyncio.run(serve_async(
            engine, requests, max_wait_ms=args.max_wait_ms,
            coalesce=args.coalesce, rate_qps=args.rate_qps,
            concurrency=args.concurrency, metrics_port=args.metrics_port))
        print(f"sustained {res.achieved_qps:.1f} qps "
              f"({res.wall_s:.2f}s wall)")
        if tracer is not None and tracer.retained:
            print("trace stage decomposition (retained traces):")
            print(json.dumps(tracer.stage_decomposition(), indent=1))
    print(json.dumps(engine.metrics.summary(), indent=1))
    if args.tenants > 0:
        print("device-side per-tenant counters:")
        print(json.dumps(engine.tenant_stats(), indent=1))
    if args.snapshot:
        engine.save_cache(args.snapshot)
        print(f"runtime snapshot (slab+policy+index state) -> {args.snapshot}")


if __name__ == "__main__":
    main()
