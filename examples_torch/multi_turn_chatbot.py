"""Multi-turn cached chatbot on the PyTorch port: one semantic cache
serving *conversations*, with each session's recent turns fused into the
lookup key (DESIGN.md §16).

    PYTHONPATH=src python examples_torch/multi_turn_chatbot.py [--device cpu]

Scenes over the simulated LLM API:

  1. *ellipsis*: a follow-up that is meaningless in isolation ("what
     about the free tier?") misses, is answered, and a second
     conversation in the same dialogue state asking it *differently*
     ("would the same hold for the free tier?") hits the fused entry,
     while a stateless engine serving the identical traffic cannot;
  2. *no collision*: the byte-identical follow-up text under an
     unrelated conversation misses: different dialogue state, different
     fused key (the rotated-subspace guarantee, §16.2);
  3. *wire protocol*: the TCP JSON-lines front-end with the additive
     ``session`` field and the ``context`` response flag; a request line
     without the field gets the pre-session payload byte-for-byte;
  4. *hygiene*: session-store counters: bounded sessions, TTL expiry.
"""
import argparse
import asyncio
import json

from repro_torch.context import DecayMeanFusion
from repro_torch.core.types import CacheConfig, resolve_device
from repro_torch.data.qa_dataset import build_corpus
from repro_torch.serving import (AsyncCacheServer, CachedEngine, Request,
                                 SimulatedLLMBackend)

FOLLOW_A = "what about the free tier?"               # recording's phrasing
FOLLOW_B = "would the same hold for the free tier?"  # replay's phrasing


def turn(eng, query, session):
    return eng.process([Request(query=query, session=session)])[0]


async def wire_demo(engine, pairs, opener):
    async with AsyncCacheServer(engine) as server:
        port = await server.serve_tcp()
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        lines = [
            # a fresh dialogue state (unused opener): its follow-up has
            # nothing fused to hit, so the flags below are deterministic
            {"id": 1, "query": pairs[2].question, "session": "wire-conv"},
            {"id": 2, "query": "and for mobile devices?",
             "session": "wire-conv"},
            {"id": 3, "query": opener},           # no session field
        ]
        out = {}
        # a session's turns are sequential: await each response before
        # sending the next turn (the §16.1 ordering contract: pipelining
        # two turns of ONE session would co-batch them blind to each other)
        for obj in lines:
            writer.write(json.dumps(obj).encode() + b"\n")
            await writer.drain()
            resp = json.loads(await reader.readline())
            out[resp["id"]] = resp
        writer.close()
        await writer.wait_closed()
        return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(ap.parse_args(argv).device)

    print("building corpus and two engines (context fusion on / off) ...")
    pairs = build_corpus(120, seed=0)

    def mk_engine(fusion):
        eng = CachedEngine(
            CacheConfig(dim=384, capacity=4096, value_len=48, ttl=None,
                        threshold=0.8),
            SimulatedLLMBackend(pairs, latency_per_call_s=0.02),
            batch_size=8, fusion=fusion, session_ttl_s=1800.0,
            max_sessions=64, device=device)
        eng.warm(pairs[:60])
        return eng

    fused = mk_engine(DecayMeanFusion(window=4))
    stateless = mk_engine(None)
    opener = pairs[0].question

    # -- scene 1: elliptical follow-ups across two conversations -------- #
    # recording: opener (warm hit) then an elliptical follow-up (miss)
    rec_open = turn(fused, opener, "conv-rec")
    rec_follow = turn(fused, FOLLOW_A, "conv-rec")
    # replay: same opener verbatim, then the follow-up REPHRASED
    rep_open = turn(fused, opener, "conv-rep")
    rep_follow = turn(fused, FOLLOW_B, "conv-rep")
    print(f"fused:     recording follow-up cached={rec_follow.cached} "
          f"(miss, pays the LLM) -> replay rephrased "
          f"cached={rep_follow.cached} score={rep_follow.score:.3f}")
    assert not rec_follow.cached and rep_follow.cached
    assert rep_follow.answer == rec_follow.answer

    # identical traffic through the stateless engine: the rephrased
    # follow-up shares too few tokens with anything cached: it can only miss
    for q, s in ((opener, "conv-rec"), (FOLLOW_A, "conv-rec"),
                 (opener, "conv-rep")):
        turn(stateless, q, s)
    flat = turn(stateless, FOLLOW_B, "conv-rep")
    print(f"stateless: replay rephrased cached={flat.cached} "
          f"score={flat.score:.3f}  (no context to resolve the ellipsis)")
    assert not flat.cached

    # -- scene 2: same text, different dialogue state ------------------- #
    turn(fused, pairs[1].question, "conv-other")   # an unrelated opener
    other = turn(fused, FOLLOW_A, "conv-other")    # byte-identical text!
    print(f"collision: identical follow-up text under an unrelated "
          f"conversation cached={other.cached} (must be a miss)")
    assert not other.cached

    # -- scene 3: the wire protocol ------------------------------------- #
    replies = asyncio.run(wire_demo(fused, pairs, opener))
    print("wire: session line ->", {k: replies[2][k] for k in
                                    ("cached", "context")})
    assert replies[2]["context"] is True          # fused under a window
    assert replies[2]["cached"] is False          # fresh dialogue state
    assert "context" not in replies[3]            # stateless line: old payload

    # -- scene 4: session hygiene --------------------------------------- #
    fused.tick(3600.0)                            # everyone idle past TTL
    turn(fused, "a fresh question after the lull", "conv-new")
    sessions = fused.sessions.stats()
    print("session store:", json.dumps(sessions))
    assert sessions["sessions"] <= 64
    print("ok")
    rows = (rec_open, rec_follow, rep_open, rep_follow, flat, other)
    return {"decisions": {
                "cached": [r.cached for r in rows],
                "answers": [r.answer for r in rows],
                "wire": {i: {k: replies[i].get(k)
                             for k in ("answer", "cached", "context")}
                         for i in sorted(replies)},
                "wire_keys": {i: sorted(replies[i]) for i in sorted(replies)},
                "sessions": sessions},
            "scores": {"turns": [r.score for r in rows],
                       "wire": [replies[i]["score"] for i in sorted(replies)]},
            "counters": {},
            "observed": {}}


if __name__ == "__main__":
    main()
