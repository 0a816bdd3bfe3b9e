"""Serving driver: ``python -m repro_torch.launch.serve [--device cuda|cpu]``.

Runs the paper's serve loop on the port: warm the cache with the QA corpus,
stream the test queries through ``CachedEngine`` in fixed batches, and
print the paper's metrics as JSON. The defaults are those of
``python -m repro.launch.serve``: 2,000 QA pairs and 500 test queries per
category, a 16,384-slot slab, d=384, batch 128, threshold 0.8, the fused
step. ``--device`` defaults to ``cuda`` and fails without it.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core.policy import AdaptiveThreshold
from repro_torch.core.types import CacheConfig
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.serving.engine import CachedEngine, Request, Response
from repro_torch.serving.llm_backend import SimulatedLLMBackend

KEY_DTYPES = {"f32": torch.float32, "int8": torch.int8}


def run(*, corpus: int = 2000, queries: int = 500, threshold: float = 0.8,
        ttl: float | None = None, batch: int = 128, policy: str = "fixed",
        fused: bool = True, device: str = "cuda", key_dtype: str = "f32",
        log=print) -> tuple[CachedEngine, list[Request], list[Response]]:
    """Build the engine, warm it, serve the workload. Returns the engine,
    the requests and their responses."""
    pairs = build_corpus(corpus, seed=0)
    tests = build_test_queries(pairs, n_per_category=queries, seed=1)
    by_id = {p.qa_id: p for p in pairs}

    def judge(req, sid):
        return sid >= 0 and sid in by_id and \
            by_id[sid].semantic_key == req.semantic_key

    cfg = CacheConfig(dim=384, capacity=max(16384, 8 * corpus), value_len=48,
                      ttl=ttl, threshold=threshold,
                      key_dtype=KEY_DTYPES[key_dtype])
    engine = CachedEngine(
        cfg, SimulatedLLMBackend(pairs), judge=judge, batch_size=batch,
        policy=AdaptiveThreshold(init=threshold) if policy == "adaptive"
        else None,
        use_fused_step=fused, device=device)
    log(f"warming cache with {len(pairs)} QA pairs ...")
    engine.warm(pairs)
    requests = [Request(query=q.query, category=q.category,
                        source_id=q.source_id, semantic_key=q.semantic_key)
                for q in tests]
    log(f"serving {len(requests)} queries (sync batches) ...")
    return engine, requests, engine.process(requests)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=2000,
                    help="QA pairs per category")
    ap.add_argument("--queries", type=int, default=500,
                    help="test queries per category")
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--ttl", type=float, default=None)
    ap.add_argument("--batch", type=int, default=128)
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
    args = ap.parse_args(argv)
    engine, _, _ = run(corpus=args.corpus, queries=args.queries,
                       threshold=args.threshold, ttl=args.ttl,
                       batch=args.batch, policy=args.policy, fused=args.fused,
                       device=args.device, key_dtype=args.key_dtype)
    print(json.dumps(engine.metrics.summary(), indent=1))
    if args.snapshot:
        engine.save_cache(args.snapshot)
        print(f"runtime snapshot (slab+policy+index state) -> {args.snapshot}")


if __name__ == "__main__":
    main()
