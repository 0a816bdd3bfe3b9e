"""Quickstart: the GPT Semantic Cache on the PyTorch port in ~40 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Embeds queries, caches responses, and shows a paraphrase being served from
the cache without an LLM call (the paper's core loop, §2.5). All cache
state (slab, counters, policy and index state) lives in one
``CacheRuntime`` threaded through the lookup/insert calls. On CUDA the
lookup runs the hand-written cosine top-k kernel.
"""
import argparse

import torch

from repro_torch.core import CacheConfig, SemanticCache, resolve_device
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embedding import HashEmbedder


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    # 1. a semantic cache: 384-dim embeddings, cosine threshold 0.8, 1h TTL
    cache = SemanticCache(CacheConfig(dim=384, capacity=1024, value_len=32,
                                      ttl=3600.0, threshold=0.8))
    runtime = cache.init(device)   # slab + stats + policy + index, on device
    embedder = HashEmbedder(dim=384)
    tok = HashTokenizer()

    def on_device(x):
        # the reference's jnp.asarray: host numpy onto the cache's device
        return torch.as_tensor(x, device=device)

    # 2. cache one (question, answer) pair, as if an LLM had just answered it
    question = "How do I reset my online banking password?"
    answer = ("Go to Settings -> Security -> Reset password, then follow "
              "the email link.")
    emb = on_device(embedder.embed_batch([question]))
    toks, lens = tok.encode_batch([answer], 32)
    runtime = cache.insert(runtime, emb, on_device(toks), on_device(lens),
                           now=0.0)

    # 3. a semantically similar query arrives
    paraphrase = "please how do I reset my online banking password"
    q = on_device(embedder.embed_batch([paraphrase]))
    result, runtime = cache.lookup(runtime, q, now=10.0)
    score, hit = float(result.score[0]), bool(result.hit[0])
    served = tok.decode(result.values[0].cpu().numpy())
    print(f"query      : {paraphrase}")
    print(f"cosine     : {score:.3f}")
    print(f"cache hit  : {hit}")
    print(f"answer     : {served}")

    # 4. an unrelated query misses -> would go to the LLM
    other = on_device(embedder.embed_batch(["what's the best pizza topping"]))
    result, runtime = cache.lookup(runtime, other, now=11.0)
    other_score, other_hit = float(result.score[0]), bool(result.hit[0])
    stats = runtime.stats.host()
    print(f"unrelated  : hit={other_hit} (score {other_score:.3f}) -> call "
          "the LLM")
    print(f"stats      : lookups={stats['lookups']} hits={stats['hits']}")
    return {"decisions": {"hit": hit, "answer": served,
                          "unrelated_hit": other_hit},
            "scores": {"cosine": score, "unrelated": other_score},
            "counters": {"lookups": stats["lookups"], "hits": stats["hits"]},
            "observed": {}}


if __name__ == "__main__":
    main()
