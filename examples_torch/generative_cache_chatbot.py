"""Generative near-hit chatbot on the PyTorch port: the [τ_lo, τ_hi) band
turning almost-hits into synthesized answers instead of backend calls
(DESIGN.md §17).

    PYTHONPATH=src python examples_torch/generative_cache_chatbot.py [--device cpu]

Scenes over the simulated LLM API:

  1. *the band*: the same paraphrase traffic through an exact-reuse
     engine and a banded engine with a ``TemplateSplice`` synthesizer:
     near-hits convert, backend calls drop strictly below the baseline,
     and every row the exact path hit is byte-identical;
  2. *admission*: a served near-hit is admitted under the query's own
     key: repeating it is an exact hit with zero new backend calls;
  3. *abstention*: a rivalrous band row (two neighbours of different
     provenance, close scores) abstains and pays the backend: synthesis
     reduces cost, never correctness;
  4. *small-model rewrite*: the same gate with a cheap rewrite call at
     ~10% of a full backend call, with its cost/latency accounted;
  5. *wire protocol*: the additive ``near_hit`` response flag; a
     band-less engine's payload stays byte-for-byte the old one.
"""
import argparse
import asyncio
import json

from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus, build_test_queries
from repro_torch.generative import (BandPolicy, Neighbour, SmallModelRewrite,
                                    SmallRewriteBackend, TemplateSplice)
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SimulatedLLMBackend)


async def wire_demo(engine, question):
    async with AsyncCacheServer(engine) as server:
        port = await server.serve_tcp()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(json.dumps({"id": 1, "query": question}).encode()
                     + b"\n")
        await writer.drain()
        resp = json.loads(await reader.readline())
        writer.close()
        await writer.wait_closed()
        return resp


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    print("building corpus and engines (band on / off) ...")
    pairs = build_corpus(100, seed=0)
    key_by_sid = {p.qa_id: p.semantic_key for p in pairs}

    def judge(req, sid):
        return key_by_sid.get(sid, "") == req.semantic_key

    def mk_engine(synthesizer=None):
        eng = CachedEngine(
            CacheConfig(dim=384, capacity=4096, value_len=48, ttl=None,
                        threshold=0.8),
            SimulatedLLMBackend(pairs, latency_per_call_s=0.02),
            judge=judge, batch_size=8, synthesizer=synthesizer,
            policy=None if synthesizer is None
            else BandPolicy(tau_lo=0.75, tau_hi=0.8), device=device)
        eng.warm(pairs)
        return eng

    queries = build_test_queries(pairs, 60, paraphrase_ratio=0.8, seed=1)
    reqs = [Request(query=q.query, category=q.category,
                    source_id=q.source_id, semantic_key=q.semantic_key)
            for q in queries]

    # -- scene 1: the band vs exact reuse ------------------------------- #
    exact = mk_engine()
    exact_resp = exact.process(reqs)
    banded = mk_engine(TemplateSplice(rival_margin=0.12))
    band_resp = banded.process(reqs)

    near = banded.metrics.near
    print(f"band: {near.band} band rows -> {near.served} near-hits served "
          f"(judge precision {near.precision:.2f}), backend calls "
          f"{banded.backend.calls} vs {exact.backend.calls} exact-only")
    assert near.served > 0
    assert banded.backend.calls < exact.backend.calls
    for a, b in zip(exact_resp, band_resp):
        if a.cached:                   # exact-path rows are untouched
            assert b.cached and b.answer == a.answer and b.score == a.score

    # -- scene 2: admission under the query's own key ------------------- #
    i = next(i for i, r in enumerate(band_resp) if r.near_hit)
    calls = banded.backend.calls
    again = banded.process([reqs[i]])[0]
    print(f"admission: near-hit repeat cached={again.cached} "
          f"near_hit={again.near_hit} new_backend_calls="
          f"{banded.backend.calls - calls}")
    assert again.cached and not again.near_hit
    assert again.answer == band_resp[i].answer
    assert banded.backend.calls == calls

    # -- scene 3: abstention on rivalrous neighbours -------------------- #
    splice = TemplateSplice(rival_margin=0.12)
    confident = splice.synthesize("q", [
        Neighbour(slot=0, score=0.78, source_id=7, answer="the dominant one"),
        Neighbour(slot=1, score=0.61, source_id=9, answer="a distant rival")])
    rivalrous = splice.synthesize("q", [
        Neighbour(slot=0, score=0.78, source_id=7, answer="too close"),
        Neighbour(slot=1, score=0.74, source_id=9, answer="to call")])
    print(f"abstention: clear margin -> {confident.answer!r}; "
          f"rival within margin -> {rivalrous}")
    assert confident is not None and rivalrous is None

    # -- scene 4: small-model rewrite at ~10% cost ----------------------- #
    small = SmallRewriteBackend(latency_per_call_s=0.002,
                                cost_per_call_usd=0.0002)
    rewriter = mk_engine(SmallModelRewrite(backend=small))
    rewriter.process(reqs)
    m = rewriter.metrics.near
    print(f"rewrite: {m.served} rewrites, {small.calls} small-model calls, "
          f"synthesis cost ${m.synthesis_cost_usd:.4f} "
          f"(vs ${0.002 * m.served:.4f} at full-call price)")
    assert small.calls == m.served > 0
    assert m.synthesis_cost_usd < 0.002 * m.served

    # -- scene 5: the wire protocol ------------------------------------- #
    with_band = asyncio.run(wire_demo(banded, pairs[0].question))
    without = asyncio.run(wire_demo(exact, pairs[0].question))
    print("wire: banded ->",
          {k: with_band[k] for k in ("cached", "near_hit")},
          "| band-less keys:", sorted(without))
    assert "near_hit" in with_band
    assert "near_hit" not in without       # additive: old payload untouched
    print("ok")

    def flags(resp):
        return [(r.cached, r.near_hit) for r in resp]
    return {"decisions": {
                "exact": flags(exact_resp), "banded": flags(band_resp),
                "banded_answers": [r.answer for r in band_resp],
                "exact_answers": [r.answer for r in exact_resp],
                "backend_calls": [banded.backend.calls, exact.backend.calls],
                "admission": [i, again.cached, again.near_hit,
                              again.answer],
                "abstention": [confident.answer, rivalrous],
                "rewrite_calls": [m.served, small.calls],
                "wire": [with_band["cached"], with_band["near_hit"],
                         sorted(without)]},
            "scores": {"banded": [r.score for r in band_resp],
                       "exact": [r.score for r in exact_resp]},
            "counters": {"band": near.band, "served": near.served,
                         "precision": near.precision,
                         "synthesis_cost_usd": m.synthesis_cost_usd},
            "observed": {}}


if __name__ == "__main__":
    main()
