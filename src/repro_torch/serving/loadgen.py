"""Load generators over the QA corpus (DESIGN.md §12.4), PyTorch port of
``repro.serving.loadgen``.

Three traffic shapes against any async ``submit(Request) -> Response``:

  * ``run_open_loop``   — open-loop Poisson arrivals at a target QPS:
    requests fire on their arrival clock whether or not earlier ones have
    completed. This is the shape that exposes queueing delay and tail
    latency (closed-loop generators self-throttle and hide both).
  * ``run_closed_loop`` — N concurrent clients, each submitting its next
    request when the previous response lands (think: N chat sessions).
  * ``run_waves``       — lockstep waves of exactly ``wave`` concurrent
    submits. A wave equal to the scheduler's ``max_batch`` reproduces the
    sync engine's batch partitioning exactly, which is what the
    async-vs-sync equivalence checks rely on.

``build_workload`` draws the paper's §3.2 mixture (paraphrases of cached
questions + novel held-out queries) and can inject *duplicate bursts* —
``burst_size`` byte-identical copies of one query back to back — the
thundering-herd pattern in-flight coalescing exists to absorb.

``build_multi_turn_workload`` (DESIGN.md §16.6) builds *conversations* —
per-session turn sequences whose follow-up turns ("what about the second
option?") are elliptical: meaningless in isolation, resolvable only
against the session's prior turns. Conversations come in recording/replay
pairs sharing one dialogue state with differently-phrased follow-ups, so a
context-fused cache converts the replay's follow-ups into hits while a
stateless cache cannot (the raw texts are below threshold). Serve them
with ``turn_levels`` (sync) or ``run_sessions`` (async) — both keep each
session's turns strictly ordered.

``build_multi_tenant_workload`` interleaves per-tenant request streams
with Zipf-skewed tenant popularity. Every tenant's stream is drawn from its
own ``random.Random`` seeded from ``(seed, tenant)`` — stable hashing, not
Python's salted ``hash()`` — so adding or removing a tenant never perturbs
another tenant's request sequence. Every workload function returns the JAX
package's stream for the same arguments.
"""
from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import random
import time
from typing import Awaitable, Callable, Sequence

from repro_torch.data.qa_dataset import QAPair, build_test_queries
from repro_torch.serving.engine import Request, Response

Submit = Callable[[Request], Awaitable[Response]]


def tenant_rng(seed: int, tenant: str) -> random.Random:
    """A ``random.Random`` stream owned by ``(seed, tenant)``: a stable
    SHA-256 of both, the same in every run and on every host, whichever
    other tenants exist."""
    digest = hashlib.sha256(f"{seed}\x1f{tenant}".encode()).digest()
    return random.Random(int.from_bytes(digest[:8], "big"))


def zipf_weights(n: int, skew: float = 1.0) -> list[float]:
    """Normalized Zipf popularity: weight of rank-i tenant ∝ 1/(i+1)^skew.
    ``skew=0`` is uniform; larger = one tenant dominates."""
    raw = [1.0 / (i + 1) ** skew for i in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


@dataclasses.dataclass
class LoadResult:
    """One generator run: responses in submission order + throughput."""

    responses: list[Response]
    wall_s: float

    @property
    def achieved_qps(self) -> float:
        return len(self.responses) / self.wall_s if self.wall_s > 0 else 0.0


def availability(responses: Sequence[object]) -> float:
    """Fraction of a run's slots answered with a usable response.

    A generator run with ``return_exceptions=True`` yields a mix of
    ``Response`` objects, per-row ``BackendError`` / ``Overloaded``
    exceptions, and failed ``Response`` rows carrying ``error``. A slot
    counts as available iff it holds a ``Response`` with no error —
    degraded responses count (the caller got an answer)."""
    if not responses:
        return 0.0
    ok = sum(1 for r in responses
             if isinstance(r, Response) and not r.error)
    return ok / len(responses)


def build_workload(pairs: Sequence[QAPair], n_requests: int, *,
                   paraphrase_ratio: float = 0.75,
                   burst_prob: float = 0.0, burst_size: int = 4,
                   seed: int = 1) -> list[Request]:
    """Paper-mixture request stream with optional duplicate bursts.

    With probability ``burst_prob`` a drawn query is emitted ``burst_size``
    times consecutively (identical bytes — the strongest coalescing case);
    otherwise once. Exactly ``n_requests`` requests are returned.
    """
    rng = random.Random(seed)
    base = build_test_queries(
        list(pairs), n_per_category=max(1, n_requests // 4 + burst_size),
        paraphrase_ratio=paraphrase_ratio, seed=seed)
    out: list[Request] = []
    i = 0
    while len(out) < n_requests:
        q = base[i % len(base)]
        i += 1
        copies = burst_size if (burst_prob > 0.0
                                and rng.random() < burst_prob) else 1
        req = Request(query=q.query, category=q.category,
                      source_id=q.source_id, semantic_key=q.semantic_key)
        for _ in range(min(copies, n_requests - len(out))):
            out.append(req)
    return out


#: Elliptical follow-up phrasings. The *recording* conversation of a group
#: uses set A; its *replay* uses set B with the same entity — close enough
#: in meaning that the replay should reuse the recording's cached answer,
#: far enough in surface form that raw (unfused) embeddings score below
#: the hit threshold. Entity-bearing, ~half-overlapping token sets.
FOLLOWUP_TEMPLATES_A = (
    "what about {e}",
    "and for {e}",
    "does that also apply to {e}",
    "what happens with {e}",
)
FOLLOWUP_TEMPLATES_B = (
    "how about {e} then",
    "would it be different for {e}",
    "would the same hold for {e}",
    "and if we consider {e} instead",
)
#: Entity pool for follow-up ellipses. Entities are handed out WITHOUT
#: replacement across the whole workload (never reused between groups or
#: turns), so every follow-up's raw text is globally unique — the
#: "0 stateless hits" claim needs no luck. Content words are pairwise
#: distinct so same-template different-entity texts stay far apart.
FOLLOWUP_ENTITIES = (
    "the second option", "smaller models", "the free tier",
    "windows machines", "larger batches", "the older version",
    "mobile devices", "the enterprise plan", "overnight jobs",
    "first-time users", "the european region", "legacy hardware",
    "rate limits", "open source forks", "the command line",
    "older browsers", "the staging environment", "third party plugins",
    "long documents", "low memory phones", "the dark theme",
    "weekend traffic", "the python client", "cold starts",
    "encrypted backups", "the beta channel", "offline mode",
    "slow networks", "the admin console", "spot instances",
    "the audit log", "streaming responses",
)

#: Synthetic source-id space for follow-up turns, far above real qa_ids.
_CTX_SID_BASE = 1_000_000


def followup_source_id(base_qa_id: int, turn: int) -> int:
    """Ground-truth id of one dialogue state's turn-``turn`` answer."""
    return _CTX_SID_BASE + base_qa_id * 32 + turn


def build_multi_turn_workload(
        pairs: Sequence[QAPair], n_groups: int, *, turns: int = 3,
        tenants: Sequence[str] | None = None,
        seed: int = 1) -> list[list[Request]]:
    """Recording/replay conversation pairs (DESIGN.md §16.6).

    Returns ``2 * n_groups`` conversations of ``turns`` turns each. Group
    ``g`` is one *dialogue state* served twice:

      * the **recording** (session ``s{seed}-{g}r``): turn 0 asks a base
        corpus question verbatim (category ``ctx/open``); follow-ups are
        set-A ellipses over per-turn entities (``ctx/followup``). All of
        these miss a cold cache and populate it.
      * the **replay** (session ``s{seed}-{g}p``): turn 0 repeats the
        identical opening text (``ctx/open_repeat`` — a hit with or
        without fusion, and it reconstructs the same context window);
        follow-ups re-ask the *same* entities through set-B phrasings
        (``ctx/followup_repeat``). These are the measured rows: their raw
        texts score below threshold against everything cached, but their
        *fused* keys match the recording's fused follow-up keys.

    Recording and replay follow-ups share ``followup_source_id`` and a
    ``ctx|…`` semantic key, so the ground-truth judge scores replay hits
    exactly like paraphrase hits in the stateless workload. Each group
    draws a distinct base question, and entities are assigned WITHOUT
    replacement across the workload — every follow-up's raw text is
    globally unique, so a stateless cache serves **zero**
    ``ctx/followup_repeat`` hits (and zero false ones).

    Ordering contract: the returned list is ``recordings + replays``
    (first ``n_groups`` conversations are the recordings). Serve ALL
    recordings before any replay — a replay's hits depend on the
    recording's inserts ("record first, then replay"). ``turn_levels``
    each half separately for the sync engine, or ``run_sessions`` the
    halves in sequence for the async scheduler.
    """
    if n_groups < 1 or turns < 2:
        raise ValueError("need n_groups >= 1 and turns >= 2")
    if n_groups > len(pairs):
        raise ValueError(f"need {n_groups} distinct base questions but the "
                         f"corpus has {len(pairs)}")
    n_entities = n_groups * (turns - 1)
    if n_entities > len(FOLLOWUP_ENTITIES):
        raise ValueError(
            f"{n_groups} groups x {turns - 1} follow-ups need {n_entities} "
            f"distinct entities but the pool has {len(FOLLOWUP_ENTITIES)}; "
            "fewer groups/turns (or grow FOLLOWUP_ENTITIES)")
    rng = random.Random(seed)
    bases = rng.sample(list(pairs), n_groups)
    entity_deck = rng.sample(FOLLOWUP_ENTITIES, n_entities)
    recordings: list[list[Request]] = []
    replays: list[list[Request]] = []
    for g, base in enumerate(bases):
        tenant = tenants[g % len(tenants)] if tenants else "default"
        grng = tenant_rng(seed, f"ctx-group-{g}")
        entities = entity_deck[g * (turns - 1):(g + 1) * (turns - 1)]
        ta = [grng.randrange(len(FOLLOWUP_TEMPLATES_A))
              for _ in range(turns - 1)]
        tb = [grng.randrange(len(FOLLOWUP_TEMPLATES_B))
              for _ in range(turns - 1)]
        for out, sess_suffix, open_cat, follow_cat, templates, tidx in (
                (recordings, "r", "ctx/open", "ctx/followup",
                 FOLLOWUP_TEMPLATES_A, ta),
                (replays, "p", "ctx/open_repeat", "ctx/followup_repeat",
                 FOLLOWUP_TEMPLATES_B, tb)):
            session = f"s{seed}-{g}{sess_suffix}"
            conv = [Request(query=base.question, category=open_cat,
                            source_id=base.qa_id,
                            semantic_key=base.semantic_key,
                            tenant=tenant, session=session)]
            for t in range(1, turns):
                e = entities[t - 1]
                conv.append(Request(
                    query=templates[tidx[t - 1]].format(e=e),
                    category=follow_cat,
                    source_id=followup_source_id(base.qa_id, t),
                    semantic_key=f"ctx|{base.semantic_key}|{t}|{e}",
                    tenant=tenant, session=session))
            out.append(conv)
    return recordings + replays


def turn_levels(conversations: Sequence[Sequence[Request]]
                ) -> list[list[Request]]:
    """Transpose conversations into turn levels for the sync engine.

    Level ``k`` holds every conversation's ``k``-th turn. Serving each
    level as its own ``process()`` call guarantees a session's turn ``k``
    is appended to its window before turn ``k+1`` is looked up — two turns
    of one session co-batched would not see each other (§16.1).
    """
    depth = max((len(c) for c in conversations), default=0)
    return [[c[k] for c in conversations if k < len(c)]
            for k in range(depth)]


async def run_sessions(submit: Submit,
                       conversations: Sequence[Sequence[Request]],
                       *, concurrency: int = 8) -> LoadResult:
    """Closed-loop over conversations: each client plays whole
    conversations, awaiting every turn before submitting the next — the
    ordering contract sessions require (a turn's window must contain the
    previous turn). Responses come back in conversation-major turn order.
    """
    t0 = time.perf_counter()
    responses: dict[tuple[int, int], Response] = {}
    it = iter(range(len(conversations)))

    async def client() -> None:
        for ci in it:                     # single event loop: next() is safe
            for ti, req in enumerate(conversations[ci]):
                responses[(ci, ti)] = await submit(req)

    await asyncio.gather(*(client() for _ in range(max(1, concurrency))))
    ordered = [responses[k] for k in sorted(responses)]
    return LoadResult(responses=ordered, wall_s=time.perf_counter() - t0)


def build_multi_tenant_workload(
        pairs: Sequence[QAPair], n_requests: int, *,
        tenants: Sequence[str], skew: float = 1.0,
        paraphrase_ratio: float = 0.75,
        burst_prob: float = 0.0, burst_size: int = 4,
        seed: int = 1) -> list[Request]:
    """Zipf-skewed multi-tenant request stream.

    Tenant popularity follows ``zipf_weights(len(tenants), skew)`` in the
    order given (first tenant = heaviest). Each tenant draws its own
    paper-mixture stream — paraphrase choices, burst rolls and query
    sequence all come from ``tenant_rng(seed, tenant)`` — and a separate
    interleaving stream picks which tenant emits next. So tenant T's
    request sequence is a pure function of (seed, T, n_requests), and
    duplicate bursts (``burst_size`` copies with probability
    ``burst_prob``) stay within one tenant.
    """
    if not tenants:
        raise ValueError("need at least one tenant")
    weights = zipf_weights(len(tenants), skew)
    pick = random.Random(seed)               # interleaving stream only
    streams = {}
    for t in tenants:
        rng = tenant_rng(seed, t)
        base = build_test_queries(
            list(pairs),
            n_per_category=max(1, n_requests // 4 + burst_size),
            paraphrase_ratio=paraphrase_ratio,
            seed=rng.randrange(2 ** 31))
        streams[t] = {"rng": rng, "base": base, "i": 0, "carry": []}
    out: list[Request] = []
    while len(out) < n_requests:
        (t,) = pick.choices(tenants, weights=weights)
        s = streams[t]
        if not s["carry"]:
            q = s["base"][s["i"] % len(s["base"])]
            s["i"] += 1
            copies = burst_size if (burst_prob > 0.0 and
                                    s["rng"].random() < burst_prob) else 1
            req = Request(query=q.query, category=q.category,
                          source_id=q.source_id,
                          semantic_key=q.semantic_key, tenant=t)
            s["carry"] = [req] * copies
        out.append(s["carry"].pop())
    return out


async def run_open_loop(submit: Submit, requests: Sequence[Request],
                        rate_qps: float, *, seed: int = 0,
                        return_exceptions: bool = False) -> LoadResult:
    """Open-loop Poisson: exponential inter-arrivals at ``rate_qps``.

    ``return_exceptions=True`` keeps failed submits — shed ``Overloaded``
    rejections, per-row backend errors — in the response list as exception
    objects instead of aborting the run; score the result with
    ``availability``."""
    rng = random.Random(seed)
    loop = asyncio.get_running_loop()
    start = loop.time()
    tasks: list[asyncio.Task] = []
    next_t = 0.0
    for req in requests:
        next_t += rng.expovariate(rate_qps)
        delay = start + next_t - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.create_task(submit(req)))
    responses = list(await asyncio.gather(
        *tasks, return_exceptions=return_exceptions))
    return LoadResult(responses=responses, wall_s=loop.time() - start)


async def run_closed_loop(submit: Submit, requests: Sequence[Request],
                          *, concurrency: int = 8) -> LoadResult:
    """Closed-loop: ``concurrency`` clients, one outstanding request each."""
    t0 = time.perf_counter()
    responses: list[Response | None] = [None] * len(requests)
    it = iter(range(len(requests)))

    async def client() -> None:
        for i in it:                      # single event loop: next() is safe
            responses[i] = await submit(requests[i])

    await asyncio.gather(*(client() for _ in range(max(1, concurrency))))
    return LoadResult(responses=list(responses),
                      wall_s=time.perf_counter() - t0)


async def run_waves(submit: Submit, requests: Sequence[Request],
                    *, wave: int,
                    return_exceptions: bool = False) -> LoadResult:
    """Lockstep waves of ``wave`` concurrent submits (sync-batch analogue).

    ``return_exceptions=True`` keeps per-slot failures in the response
    list (see ``run_open_loop``)."""
    t0 = time.perf_counter()
    responses: list[Response] = []
    for i in range(0, len(requests), wave):
        chunk = requests[i:i + wave]
        responses.extend(await asyncio.gather(
            *(submit(r) for r in chunk),
            return_exceptions=return_exceptions))
    return LoadResult(responses=responses, wall_s=time.perf_counter() - t0)
