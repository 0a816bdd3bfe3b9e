"""Load generators over the QA corpus (DESIGN.md §12.4), PyTorch port of
``repro.serving.loadgen``; sessions (``build_multi_turn_workload``,
``turn_levels``, ``run_sessions``) arrive with the sessions slice.

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
