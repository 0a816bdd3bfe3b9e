"""End-to-end driver on the PyTorch port: a cached customer-service chatbot
serving batched requests with a REAL model backend (reduced yi-6b) behind
the semantic cache.

    PYTHONPATH=src python examples_torch/serve_cached_chatbot.py [--device cpu]

Pipeline per batch: embed -> semantic cache lookup -> hits answered from
the cache -> misses answered by the PyTorch model (prefill + greedy
decode) and inserted. Prints the paper's serving metrics at the end. On
CUDA the lookup runs the cosine top-k kernel, the model's prefill and
decode the flash- and decode-attention kernels, and its weights are drawn
from the reference's key 0 by the threefry kernel.
"""
import argparse
import json

from repro_torch import prng
from repro_torch.configs import get_arch
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.model import Model
from repro_torch.serving import CachedEngine, ModelBackend, Request


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    print("building reduced yi-6b backend ...")
    config = get_arch("yi-6b").reduced()
    # the port's Model holds its weights (the reference passes a params
    # pytree beside it), drawn from the reference's PRNGKey(0) stream
    model = Model(config, device=device).init_params(prng.key(0))
    backend = ModelBackend(model, HashTokenizer(vocab_size=config.vocab),
                           max_prompt_len=32, max_new_tokens=12)

    engine = CachedEngine(
        CacheConfig(dim=384, capacity=4096, value_len=32, ttl=None,
                    threshold=0.8),
        backend, batch_size=16, device=device)

    pairs = build_corpus(100, seed=0)
    queries = build_test_queries(pairs, n_per_category=10, seed=1)

    # first pass: everything misses -> the model generates (and is cached)
    reqs = [Request(query=q.query, category=q.category) for q in queries[:32]]
    print("pass 1 (cold cache) ...")
    r1 = engine.process(reqs)
    calls_pass1 = backend.calls
    print(f"  hits: {sum(r.cached for r in r1)}/32, model calls: "
          f"{calls_pass1}")

    # second pass: identical traffic -> served from cache, no model calls
    print("pass 2 (warm cache) ...")
    r2 = engine.process(reqs)
    new_calls = backend.calls - calls_pass1
    print(f"  hits: {sum(r.cached for r in r2)}/32, "
          f"new model calls: {new_calls}")

    # NOTE: the backend model is randomly initialized (no checkpoint
    # downloads offline), so its generations are gibberish tokens: the
    # point is the CACHE behaviour: pass 2 answers are identical bytes to
    # pass 1 and cost zero model calls.
    for r in r2[:3]:
        print(f"  [cached={r.cached} score={r.score:.2f}] {r.answer[:70]}")

    summary = engine.metrics.summary()
    print(json.dumps(summary, indent=1))
    return {"decisions": {"pass1_cached": [r.cached for r in r1],
                          "pass2_cached": [r.cached for r in r2],
                          "pass1_answers": [r.answer for r in r1],
                          "pass2_answers": [r.answer for r in r2],
                          "model_calls": calls_pass1,
                          "new_model_calls": new_calls},
            "scores": {"pass1": [r.score for r in r1],
                       "pass2": [r.score for r in r2]},
            "counters": {"categories": summary["categories"],
                         "queries": summary["queries"]},
            "observed": {"latency_percentiles":
                         summary["latency_percentiles"]}}


if __name__ == "__main__":
    main()
