"""Async continuous micro-batch scheduler with in-flight coalescing
(PyTorch port of ``repro.serving.scheduler``: the same host-side asyncio
code in front of the port's ``CachedEngine``).

The paper measures one synchronous batch at a time (§2.5, Figures 2–4);
production traffic is *concurrent*. This module is the admission layer in
front of ``CachedEngine`` (DESIGN.md §12): requests arrive on an asyncio
event loop, wait in a bounded FIFO queue, and are flushed to the engine's
``serve_batch`` as micro-batches — on ``max_batch`` occupancy or on the
oldest request's ``max_wait_ms`` deadline, whichever comes first.

**In-flight coalescing** (DESIGN.md §12.3): concurrent requests with the
same semantic key attach as *waiters* to the one pending entry — queued or
already dispatched to the backend — so a thundering herd of N identical
misses costs ONE LLM call instead of N. Without a semantic cache in front,
this is the classic request-dedup proxy; with one, it closes the window
the paper leaves open between "first miss starts generating" and "response
is inserted", during which every duplicate would also miss.

**Embedding-similarity coalescing** (``SchedulerConfig.coalesce_sim``):
with a cosine threshold set, a request whose normalized text matches no
pending leader is additionally probed against the leaders' *embeddings* —
a SimHash LSH bucket collision (cheap prefilter,
``repro_torch.embedding.lsh``)
nominates candidate leaders and an exact host-side cosine >=
``coalesce_sim`` verifies before attaching, so in-flight *paraphrases*
("how do I sort a list" / "how to sort lists") share one backend call too.
The verification step is what keeps the guarantee one-sided: an LSH false
collision is rejected by exact cosine, so distinct-meaning queries never
share a leader; a missed collision merely forfeits a dedup. Buckets are
scoped by (tenant, session), so similarity coalescing obeys exactly the
same isolation boundaries as the text path. ``None`` (default) keeps
today's text-equality behaviour bit for bit.

**Multi-tenant admission** (DESIGN.md §13.3): requests queue per tenant
and micro-batches are formed by *deficit round robin* over the backlogged
tenants — each rotation credits a tenant its (weight-proportional) quantum
and takes that many of its oldest requests — so a bursty tenant can fill
idle slots but can never starve the others out of a contended batch.
Backpressure is also per tenant: a tenant at its own queue bound blocks
(and forces a flush) without consuming other tenants' admission capacity.
With one tenant all of this degenerates to the original FIFO queue.

Invariants (tested in ``tests/test_torch_scheduler.py``):
  * admission order is FIFO within a tenant — a flush takes each tenant's
    oldest entries, and the flush trigger is the globally oldest deadline;
  * under contention a tenant's share of a micro-batch is proportional to
    its DRR weight, regardless of how deep its backlog is;
  * a full queue (global or per-tenant) never deadlocks submitters: it
    forces an immediate flush (backpressure, §12.2);
  * coalescing never crosses tenants: the dedup key is (tenant, query),
    so identical queries from different tenants each pay their own way;
  * at most one ``serve_batch`` runs at a time (single-worker executor —
    the engine's runtime is owned linearly, and on a card its kernels
    launch from that one thread on the default stream, so their launch
    counters stay exact), while the event loop stays free to accept and
    coalesce new arrivals;
  * every accepted request's future is resolved exactly once, also on
    backend failure and on ``stop()`` (drain).
"""
from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.serving.engine import CachedEngine, Request, Response
from repro_torch.serving.llm_backend import BackendError
from repro_torch.serving.resilience import Overloaded


def normalize_query(text: str) -> str:
    """Whitespace/case-insensitive canonical form for coalescing: strip,
    casefold, collapse internal whitespace. Trivially-different duplicates
    ("How do I…", "  how do i …") now share one in-flight leader — the
    first step toward the ROADMAP's embedding-similarity coalescing."""
    return " ".join(text.split()).casefold()


def coalesce_key(request: Request) -> str:
    """Semantic identity for in-flight dedup: (tenant, session, normalized
    query).

    The tenant prefix makes cross-tenant coalescing structurally impossible
    — two tenants asking the same question must not share an answer object,
    let alone a cache decision (§13.3). The session component does the same
    for multi-turn context (§16.3): two sessions asking the identical
    follow-up *text* ("what about the second one?") are different dialogue
    states with different fused keys, so they must not share a leader —
    without it one session would receive an answer fused under the *other*
    session's context. Sessionless requests keep the exact pre-session key
    shape (empty middle component), so their coalescing is unchanged. The
    embedding-similarity upgrade is named in ROADMAP open items."""
    return (f"{request.tenant}\x1f{request.session}\x1f"
            f"{normalize_query(request.query)}")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission-control knobs (DESIGN.md §12.2, §13.3)."""

    max_batch: int = 32        # flush when this many requests are queued ...
    max_wait_ms: float = 5.0   # ... or when the oldest one has waited this long
    max_queue: int = 1024      # bounded total backlog; full -> immediate flush
    coalesce: bool = True      # in-flight duplicate merging (§12.3)
    coalesce_sim: float | None = None  # cosine bound for embedding-similarity
                                       # coalescing; None = text-equality only
    max_queue_per_tenant: int | None = None  # per-tenant backlog bound
                                             # (None -> max_queue)
    tenant_weights: dict | None = None       # DRR quanta by tenant name;
                                             # unlisted tenants weigh 1.0
    overload_policy: str = "block"           # full queue: "block" parks the
                                             # submitter until a slot frees
                                             # (pre-§20 behaviour); "shed"
                                             # raises Overloaded instead —
                                             # an explicit rejection beats
                                             # unbounded latency (§20.5)

    def __post_init__(self):
        if self.max_batch <= 0 or self.max_queue <= 0:
            raise ValueError("max_batch and max_queue must be positive")
        if self.overload_policy not in ("block", "shed"):
            raise ValueError(
                f"overload_policy must be 'block' or 'shed', "
                f"got {self.overload_policy!r}")
        if self.max_wait_ms < 0:
            raise ValueError("max_wait_ms must be >= 0")
        if self.coalesce_sim is not None \
                and not 0.0 < self.coalesce_sim <= 1.0:
            raise ValueError("coalesce_sim must be within (0, 1]")
        if self.max_queue_per_tenant is not None \
                and self.max_queue_per_tenant <= 0:
            raise ValueError("max_queue_per_tenant must be positive")
        if self.tenant_weights and \
                any(w <= 0 for w in self.tenant_weights.values()):
            raise ValueError("tenant weights must be positive")


class _Entry:
    """One queued leader request and its completion future."""

    __slots__ = ("request", "future", "arrival", "trace")

    def __init__(self, request: Request, future: asyncio.Future,
                 arrival: float, trace=None):
        self.request = request
        self.future = future
        self.arrival = arrival
        # RequestTrace when the engine's tracer is collecting, else the
        # shared NULL_TRACE (no per-request allocation, DESIGN.md §18.2)
        self.trace = trace


class AsyncScheduler:
    """Continuous micro-batching in front of one ``CachedEngine``.

    Usage::

        scheduler = AsyncScheduler(engine, SchedulerConfig(max_batch=32))
        await scheduler.start()
        response = await scheduler.submit(Request(query="..."))
        await scheduler.stop()      # drains the queue

    ``submit`` is safe to call from many concurrent tasks; the engine runs
    in a single worker thread so the device-side serve path is serialized
    while admission/coalescing continue on the event loop.
    """

    def __init__(self, engine: CachedEngine,
                 config: SchedulerConfig | None = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        # per-tenant FIFO queues + deficit-round-robin state (§13.3); a
        # single-tenant workload uses exactly one queue = the old FIFO
        self._queues: dict[str, deque[_Entry]] = {}
        self._rr: deque[str] = deque()     # backlogged tenants, rotation order
        self._deficit: dict[str, float] = {}
        self._qlen = 0                     # total backlog across tenants
        # key -> list of (waiter future, arrival time, waiter trace, waiter
        # request); present from leader enqueue until its response is
        # delivered (covers queued AND dispatched-to-backend windows —
        # that is the "in-flight" part)
        self._pending: dict[str, list[tuple]] = {}
        # embedding-similarity coalescing state (coalesce_sim, §12.3): the
        # LSH prefilter plus, per pending leader, its embedding and bucket
        # registrations (for cosine verification and cleanup)
        self._lsh = None
        self._leader_emb: dict[str, np.ndarray] = {}
        self._leader_buckets: dict[str, list[tuple]] = {}
        self._sim_buckets: dict[tuple, set[str]] = {}
        if self.config.coalesce_sim is not None:
            from repro_torch.embedding.lsh import SimHashLSH
            self._lsh = SimHashLSH(engine.embedder.dim)
        self._cond: asyncio.Condition | None = None
        self._loop_task: asyncio.Task | None = None
        self._executor: ThreadPoolExecutor | None = None
        self._force_flush = False
        self._stopping = False
        self._running = False
        self.batches_served = 0

    def _waiter_trace(self, arrival: float, leader_key: str):
        """Trace for a coalesced waiter: its whole queue life is one
        ``coalesce_attach`` span (arrival -> attached to the in-flight
        leader); the ``respond`` span is added at resolution. Returns the
        shared NULL_TRACE when the tracer is off."""
        tr = self.engine.tracer.start()
        if tr:
            tr.add("coalesce_attach", arrival, time.perf_counter())
            tr.annotate(leader=leader_key)
        return tr

    def _weight(self, tenant: str) -> float:
        w = self.config.tenant_weights
        return w.get(tenant, 1.0) if w else 1.0

    def _tenant_of(self, request: Request) -> str | None:
        """Tenant tag for metrics — only when the engine actually runs a
        registry (a bare 'default' on a single-tenant engine is noise)."""
        return request.tenant if getattr(self.engine, "registry", None) \
            is not None else None

    def _oldest_arrival(self) -> float:
        return min(q[0].arrival for q in self._queues.values() if q)

    # -- embedding-similarity coalescing (coalesce_sim, §12.3) ----------- #
    def _similar_leader(self, request: Request,
                        emb: np.ndarray) -> str | None:
        """Pending leader whose embedding verifies cosine >= coalesce_sim
        against ``emb``, or None. The LSH bucket probe only *nominates*
        candidates (scoped to this request's tenant+session); the exact
        cosine check is what admits — a colliding-but-dissimilar leader is
        rejected here, so distinct-meaning queries never share a leader."""
        scope = (request.tenant, request.session)
        cands: set[str] = set()
        for t, b in enumerate(self._lsh.buckets(emb)):
            cands |= self._sim_buckets.get(scope + (t, b), set())
        from repro_torch.embedding.lsh import cosine
        best, best_sim = None, float(self.config.coalesce_sim)
        for k in sorted(cands):            # deterministic tie-break
            if k in self._pending:
                sim = cosine(emb, self._leader_emb[k])
                if sim >= best_sim:
                    best, best_sim = k, sim
        return best

    def _register_leader(self, request: Request, key: str,
                         emb: np.ndarray) -> None:
        scope = (request.tenant, request.session)
        buckets = [scope + (t, b)
                   for t, b in enumerate(self._lsh.buckets(emb))]
        self._leader_emb[key] = emb
        self._leader_buckets[key] = buckets
        for bk in buckets:
            self._sim_buckets.setdefault(bk, set()).add(key)

    def _unregister_leader(self, key: str) -> None:
        """Drop a resolved leader's similarity state (no-op for keys that
        never registered — LSH off, or a pre-LSH leader)."""
        self._leader_emb.pop(key, None)
        for bk in self._leader_buckets.pop(key, ()):
            members = self._sim_buckets.get(bk)
            if members is not None:
                members.discard(key)
                if not members:
                    del self._sim_buckets[bk]

    # -- lifecycle ------------------------------------------------------- #
    async def start(self) -> None:
        if self._running:
            return
        self._cond = asyncio.Condition()
        # fresh worker per start: stop() shut the previous one down, and a
        # drained scheduler may be started again
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-batch")
        self._stopping = False
        self._running = True
        self._loop_task = asyncio.create_task(self._run())

    async def stop(self) -> None:
        """Drain: serve everything already accepted, then shut down."""
        if not self._running:
            return
        async with self._cond:
            self._stopping = True
            self._cond.notify_all()
        await self._loop_task
        self._running = False
        self._executor.shutdown(wait=True)

    async def __aenter__(self) -> "AsyncScheduler":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- admission ------------------------------------------------------- #
    async def submit(self, request: Request) -> Response:
        """Enqueue one request and await its response.

        Duplicates of an in-flight (tenant, query) key attach as waiters
        (no queue slot, no extra backend call); otherwise the request
        becomes that key's leader in its tenant's queue. A full queue —
        the tenant's own bound or the global one — blocks the submitter
        and forces an immediate flush until a slot frees up; other
        tenants' submitters are unaffected by a neighbour's full queue.
        """
        if not self._running or self._stopping:
            raise RuntimeError("scheduler is not running")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        arrival = time.perf_counter()
        key = coalesce_key(request)
        tenant = request.tenant
        cap_tenant = self.config.max_queue_per_tenant or self.config.max_queue
        async with self._cond:
            # re-check under the lock: stop() may have begun draining
            # between the fast-path check above and lock acquisition, and
            # an entry enqueued after the drain would strand its future
            if not self._running or self._stopping:
                raise RuntimeError("scheduler is not running")
            sim_leader = None
            emb = None
            if self.config.coalesce and self._lsh is not None \
                    and key not in self._pending:
                # embedding probe only when the exact-text key missed: the
                # host-side hash embedding is cheap but not free
                emb = np.asarray(self.engine.embedder.embed(request.query),
                                 dtype=np.float32)
                sim_leader = self._similar_leader(request, emb)
            if self.config.coalesce and key in self._pending:
                self._pending[key].append(
                    (fut, arrival, self._waiter_trace(arrival, key),
                     request))
                self.engine.metrics.record_coalesced(
                    1, tenant=self._tenant_of(request))
            elif sim_leader is not None:
                # cosine-verified paraphrase of an in-flight leader (§12.3)
                self._pending[sim_leader].append(
                    (fut, arrival, self._waiter_trace(arrival, sim_leader),
                     request))
                self.engine.metrics.record_coalesced(
                    1, tenant=self._tenant_of(request))
            else:
                queue = self._queues.setdefault(tenant, deque())
                while (self._qlen >= self.config.max_queue
                       or len(queue) >= cap_tenant):
                    # backpressure (§12.2): demand an immediate flush and
                    # wait for a freed slot in *this* tenant's budget —
                    # or, under the shed policy (§20.5), reject loudly
                    # instead of queueing latency the caller never agreed to
                    self._force_flush = True
                    self._cond.notify_all()
                    if self.config.overload_policy == "shed":
                        self.engine.metrics.resilience.shed += 1
                        self.engine.metrics.resilience_seen = True
                        raise Overloaded(
                            f"queue full (tenant {tenant!r}: "
                            f"{len(queue)}/{cap_tenant}, total "
                            f"{self._qlen}/{self.config.max_queue}); "
                            "load shed — retry with backoff")
                    await self._cond.wait()
                    if self._stopping:
                        raise RuntimeError("scheduler stopped while queued")
                queue.append(_Entry(request, fut, arrival,
                                    trace=self.engine.tracer.start()))
                self._qlen += 1
                if tenant not in self._rr:
                    self._rr.append(tenant)
                if self.config.coalesce:
                    self._pending.setdefault(key, [])
                    if self._lsh is not None and emb is not None:
                        self._register_leader(request, key, emb)
                self._cond.notify_all()
        # awaited OUTSIDE the condition lock: the serve loop needs the lock
        # to resolve this future
        return await fut

    # -- scheduler loop --------------------------------------------------- #
    async def _run(self) -> None:
        while True:
            entries = await self._admit()
            if entries is None:
                return
            await self._serve(entries)

    def _form_batch(self) -> list[_Entry]:
        """Deficit-round-robin batch formation over backlogged tenants
        (§13.3). Each rotation credits the tenant its weight as quantum and
        takes that many of its oldest entries (FIFO within tenant). The
        deficit persists across batches while a tenant stays backlogged —
        that is what makes long-run shares weight-proportional — and resets
        when its queue drains (classic DRR, Shreedhar & Varghese 1996)."""
        out: list[_Entry] = []
        while len(out) < self.config.max_batch and self._qlen > 0:
            tenant = self._rr.popleft()
            queue = self._queues[tenant]
            if not queue:
                self._deficit[tenant] = 0.0
                continue              # drained earlier: drop from rotation
            self._deficit[tenant] = self._deficit.get(tenant, 0.0) \
                + self._weight(tenant)
            take = min(len(queue), int(self._deficit[tenant]),
                       self.config.max_batch - len(out))
            for _ in range(take):
                out.append(queue.popleft())
            self._qlen -= take
            self._deficit[tenant] -= take
            if queue:
                self._rr.append(tenant)   # still backlogged: keep rotating
            else:
                self._deficit[tenant] = 0.0
        return out

    async def _admit(self) -> list[_Entry] | None:
        """Block until a flush condition holds, then form one micro-batch.
        The flush trigger watches the *globally* oldest arrival, so no
        tenant's deadline is hostage to another tenant's traffic."""
        async with self._cond:
            while True:
                if self._qlen > 0:
                    age_ms = (time.perf_counter()
                              - self._oldest_arrival()) * 1000.0
                    if (self._qlen >= self.config.max_batch
                            or age_ms >= self.config.max_wait_ms
                            or self._force_flush or self._stopping):
                        self._force_flush = False
                        t_flush = time.perf_counter()
                        entries = self._form_batch()
                        if self.engine.tracer.collecting:
                            # queue-side spans (§18.1): queue_wait is
                            # arrival -> flush decision, batch_form the
                            # DRR assembly; the engine's contiguous stage
                            # clock picks up from the executor handoff
                            t_formed = time.perf_counter()
                            for e in entries:
                                e.trace.add("queue_wait", e.arrival,
                                            t_flush)
                                e.trace.add("batch_form", t_flush,
                                            t_formed)
                        self._cond.notify_all()   # wake blocked submitters
                        return entries
                    timeout = self.config.max_wait_ms / 1000.0 - age_ms / 1000.0
                elif self._stopping:
                    return None
                else:
                    timeout = None
                try:
                    await asyncio.wait_for(self._cond.wait(), timeout)
                except asyncio.TimeoutError:
                    pass

    async def _serve(self, entries: list[_Entry]) -> None:
        """One engine round for one admission batch, off the event loop."""
        loop = asyncio.get_running_loop()
        # deadline budgets (§20.3): the engine must see the budget that
        # REMAINS after queue wait, so retries can never push a request
        # past the SLO its caller stated at submit time. Requests without
        # a deadline pass through untouched (identical object).
        t_dispatch = time.perf_counter()
        batch = []
        for e in entries:
            r = e.request
            if r.deadline_ms is not None:
                waited_ms = (t_dispatch - e.arrival) * 1000.0
                r = dataclasses.replace(
                    r, deadline_ms=max(r.deadline_ms - waited_ms, 0.0))
            batch.append(r)
        try:
            responses = await loop.run_in_executor(
                self._executor,
                lambda: self.engine.serve_batch(
                    batch, record_path_latency=False,
                    traces=[e.trace for e in entries]))
        except Exception as exc:                    # resolve, never strand
            async with self._cond:
                for e in entries:
                    key = coalesce_key(e.request)
                    self._unregister_leader(key)
                    for fut, *_ in self._pending.pop(key, []):
                        if not fut.done():
                            fut.set_exception(exc)
                    if not e.future.done():
                        e.future.set_exception(exc)
            return
        self.batches_served += 1
        done = time.perf_counter()
        async with self._cond:
            for e, r in zip(entries, responses):
                tenant = self._tenant_of(e.request)
                key = coalesce_key(e.request)
                if r.error:
                    # per-row failure domain (§20.2): only the rows whose
                    # backend call actually failed reject — hit/near/
                    # degraded rows of the same flush resolved normally
                    exc = BackendError(r.error)
                    self._unregister_leader(key)
                    self.engine.metrics.record_latency(
                        "error", done - e.arrival, tenant=tenant)
                    if not e.future.done():
                        e.future.set_exception(exc)
                    if e.trace:
                        self.engine.tracer.finish(e.trace,
                                                  e2e_s=done - e.arrival)
                    for fut, w_arrival, wtr, _w_req in self._pending.pop(
                            key, []):
                        self.engine.metrics.record_latency(
                            "error", done - w_arrival, tenant=tenant)
                        if wtr:
                            self.engine.tracer.finish(
                                wtr, e2e_s=done - w_arrival)
                        if not fut.done():
                            fut.set_exception(exc)
                    continue
                # end-to-end latency: queue wait + service (the sync path's
                # samples are service-only; these are what a client sees)
                path = "degraded" if r.degraded else (
                    "hit" if r.cached else
                    ("near" if r.near_hit else "miss"))
                self.engine.metrics.record_latency(
                    path, done - e.arrival, tenant=tenant)
                if not e.future.done():
                    e.future.set_result(
                        dataclasses.replace(r, latency_s=done - e.arrival))
                if e.trace:
                    # true client-observed e2e: queue wait + service
                    self.engine.tracer.finish(e.trace,
                                              e2e_s=done - e.arrival)
                # waiters inherit the leader's answer/decision; they paid
                # no lookup and no backend call (and shared the leader's
                # tenant — the coalesce key guarantees it; similarity
                # waiters additionally passed the cosine >= coalesce_sim
                # verification against this leader)
                self._unregister_leader(key)
                for fut, w_arrival, wtr, w_req in self._pending.pop(
                        key, []):
                    # the waiter's latency files under its OWN "coalesced"
                    # path — folding it into the leader's hit/miss bucket
                    # would skew those paths' p99 (§18.5)
                    self.engine.metrics.record_latency(
                        "coalesced", done - w_arrival, tenant=tenant)
                    w_resp = dataclasses.replace(
                        r, coalesced=True, latency_s=done - w_arrival,
                        trace_id="", why=None)
                    if w_req.explain or self.engine.explain_all:
                        w_resp = dataclasses.replace(
                            w_resp, why=self._waiter_why(r, w_req, key))
                    if wtr:
                        t_att = wtr.spans[-1].t1 if wtr.spans else w_arrival
                        wtr.add("respond", t_att, done)
                        wtr.why = w_resp.why
                        w_resp = dataclasses.replace(
                            w_resp, trace_id=wtr.trace_id)
                        self.engine.tracer.finish(
                            wtr, e2e_s=done - w_arrival)
                    if not fut.done():
                        fut.set_result(w_resp)

    @staticmethod
    def _waiter_why(r: Response, w_req: Request, leader_key: str) -> dict:
        """Attribution for a coalesced waiter (§18.3): the decision is
        ``coalesced`` (this request paid nothing), ``coalesced_into`` names
        the leader, and the leader's own record — when it carried one —
        rides along with its decision demoted to ``leader_decision``."""
        leader_decision = ("degraded" if r.degraded
                          else "hit" if r.cached
                          else "near_hit" if r.near_hit else "miss")
        why = dict(r.why) if r.why is not None else {
            "score": round(float(r.score), 6),
            "tenant": w_req.tenant, "session": w_req.session}
        why.update(decision="coalesced", coalesced_into=leader_key,
                   leader_decision=leader_decision)
        return why
