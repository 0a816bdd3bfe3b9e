"""Distributed semantic cache on the PyTorch port (paper §2.10 future work,
implemented).

    PYTHONPATH=src python examples_torch/distributed_cache_demo.py [--device cpu]

Runs the sharded cache on a (4, 2) ``data`` x ``model`` mesh: the slab
shards over the ``data`` axis, lookups fan out with a max combine,
inserts route round-robin: a query cached on one shard is served to a
query landing anywhere on the mesh. Each shard keeps its own runtime on
its device; stats and policy are replicated. On CUDA the mesh is run
twice: every shard on the card, then the shards over the mixed devices
``[cuda, cpu, cuda, cpu]``, which must give the same answers.
"""
import argparse

import torch

from repro_torch.core import (CacheConfig, DistributedCache, SemanticCache,
                              make_mesh, resolve_device)
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.embedding import HashEmbedder

FAQS = [
    ("what are the interest rates for savings accounts",
     "Savings accounts earn 4.1% APY, paid monthly."),
    ("how do i reset my online banking password",
     "Use Settings -> Security -> Reset password."),
    ("where is the nearest branch",
     "Use the branch locator on the website homepage."),
    ("how do i order a new debit card",
     "Request a replacement card under Cards -> Replace."),
]
PARAPHRASES = [
    "what are the interest rates for savings accounts please",
    "hi how do i reset my online banking password",
    "where is the nearest branch located",
    "how do i order a new debit card today",
]


def run(device, mesh_devices, log=print) -> dict:
    """Both passes on a (4, 2) mesh whose shards sit on ``mesh_devices``
    (8 entries, shard-major); queries arrive on ``device``."""
    # the port's mesh names a device a shard (the reference's
    # jax.make_mesh over 8 forced host devices)
    mesh = make_mesh((4, 2), ("data", "model"), device=mesh_devices)
    log(f"mesh: {mesh.shape} over "
        f"{sorted({str(d) for d in mesh.devices})}")

    cache = SemanticCache(CacheConfig(dim=384, capacity=1024, value_len=24,
                                      ttl=3600.0, threshold=0.8))
    dc = DistributedCache(cache, mesh, cache_axes=("data",))
    runtime = dc.init()
    step = dc.make_lookup_insert()
    embedder = HashEmbedder()
    tok = HashTokenizer()

    def on_device(x):
        return torch.as_tensor(x, device=device)

    q_emb = on_device(embedder.embed_batch([q for q, _ in FAQS]))
    vals, lens = tok.encode_batch([a for _, a in FAQS], 24)
    vals, lens = on_device(vals), on_device(lens)
    src = torch.arange(len(FAQS), dtype=torch.int32, device=device)

    # pass 1: cold: every query misses and the responses are inserted
    runtime, (slot, score, hit, v, vl, s) = step(
        runtime, q_emb, vals, lens, src, 0.0)
    cold_hits = int(hit.sum())
    log(f"cold pass: hits={cold_hits}/4")
    per_shard = runtime.state.valid.reshape(4, -1).sum(dim=1).tolist()
    log(f"entries per cache shard (round-robin): {per_shard}")

    # pass 2: paraphrased traffic: served from whichever shard owns it
    p_emb = on_device(embedder.embed_batch(PARAPHRASES))
    runtime, (slot, score, hit, v, vl, s) = step(
        runtime, p_emb, vals, lens, src, 1.0)
    hits, scores = hit.tolist(), score.tolist()
    shards = (slot // dc.local_capacity).tolist()
    answers = [tok.decode(row[:n]) for row, n in zip(v.cpu().numpy(),
                                                     vl.tolist())]
    for i, p in enumerate(PARAPHRASES):
        log(f"[hit={hits[i]} score={scores[i]:.2f} shard={shards[i]}] {p}")
    stats = runtime.stats.host()
    log(f"global stats: lookups={stats['lookups']} hits={stats['hits']} "
        f"inserts={stats['inserts']}")
    return {"decisions": {"cold_hits": cold_hits, "hits": hits,
                          "shards": shards, "answers": answers},
            "scores": {"paraphrases": scores},
            "counters": {"entries_per_shard": per_shard,
                         "stats": {k: stats[k] for k in
                                   ("lookups", "hits", "inserts")}}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)
    out = run(device, [device] * 8)
    out["observed"] = {}
    if device.type == "cuda":
        # shards 0 and 2 on the card, 1 and 3 on the host (each shard's
        # two model-axis entries share its device)
        mixed = run(device, [device, device, "cpu", "cpu"] * 2)
        for key in ("decisions", "counters"):
            if mixed[key] != out[key]:
                raise AssertionError(f"mixed mesh {key} {mixed[key]} != "
                                     f"one-device {out[key]}")
        gap = max(abs(a - b) for a, b in zip(mixed["scores"]["paraphrases"],
                                             out["scores"]["paraphrases"]))
        if not gap <= 1e-5:
            raise AssertionError(f"mixed mesh scores differ by {gap}")
        out["observed"] = {"mixed_mesh": mixed, "mixed_score_gap": gap}
    return out


if __name__ == "__main__":
    main()
