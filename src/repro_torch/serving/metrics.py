"""Serving metrics: the paper's evaluation quantities (Figures 2–4, Table 1).

Per-category counters for lookups / hits / positive hits plus latency and
cost accumulators for the cached and uncached paths. ``summary()`` emits
exactly the rows the paper reports: cache-hit rate, API-call reduction,
positive-hit rate, average response time with/without cache, cost saved.

Beyond-paper serving additions (DESIGN.md §12): per-path latency samples
("hit" / "miss" / "coalesced") summarized as p50/p95/p99 percentiles, and
a ``coalesced_calls`` counter — requests that attached to an in-flight
duplicate instead of paying their own lookup/backend call. The paper-table
rows of ``summary()`` are unchanged; the new quantities ride along under
new keys.

Multi-tenant serving (DESIGN.md §13) adds a per-tenant breakdown under the
same contract: ``record_batch(..., tenants=...)`` and
``record_latency(..., tenant=...)`` accumulate per-tenant hit/miss counts,
coalesced counts and per-tenant latency percentiles, surfaced under
``summary()["tenants"]`` without touching any existing row.

Multi-turn serving (DESIGN.md §16) adds context-hit rows the same way:
``record_batch(..., contexts=...)`` splits every lookup into the
*context-fused* bucket (the row was looked up under a non-empty session
turn window) vs the *single-turn* bucket, surfaced under
``summary()["context"]`` — the quantities the context table reports
(context hit rate vs single-turn hit rate, and context positive-hit
precision, which must clear the same >97% bar as stateless serving).

Generative near-hit serving (DESIGN.md §17) rides the same contract:
``record_batch(..., nears=..., near_served=...)`` counts band rows
([τ_lo, τ_hi) lookups), how many of them the synthesizer actually served
(vs abstained back to the full backend call), judged synthesis precision
and the marginal synthesis cost/latency, surfaced under
``summary()["near"]`` without touching any existing row.
"""
from __future__ import annotations

import dataclasses
import random
from collections import defaultdict


_PCTS = (50.0, 95.0, 99.0)

#: Histogram bucket upper bounds (seconds) for the Prometheus exposition
#: (repro.obs.export). Spans sub-millisecond cache hits to multi-second
#: backend calls; the +Inf bucket is implicit (``count`` closes it).
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0)


def percentiles(samples: list[float]) -> dict:
    """p50/p95/p99 (linear interpolation, numpy-compatible) of one path."""
    if not samples:
        return {"count": 0, "p50_s": 0.0, "p95_s": 0.0, "p99_s": 0.0}
    xs = sorted(samples)
    out = {"count": len(xs)}
    for p in _PCTS:
        rank = (len(xs) - 1) * p / 100.0
        lo = int(rank)
        hi = min(lo + 1, len(xs) - 1)
        val = xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)
        out[f"p{int(p)}_s"] = round(val, 6)
    return out


class LatencyReservoir:
    """Bounded latency sample buffer (DESIGN.md §18.5).

    ``record_latency`` used to append every sample to an unbounded
    ``list[float]`` per path/tenant — a slow memory leak under sustained
    load. This keeps three bounded things instead:

      * exact scalars: ``count`` and ``total_s`` over ALL samples ever;
      * a uniform random reservoir (Vitter's Algorithm R) of at most
        ``cap`` samples, so percentile estimates stay statistically
        honest over the full stream, not just a recent window;
      * per-bucket counts over ``LATENCY_BUCKETS_S`` — exact histogram
        counters for the Prometheus exposition, O(len(buckets)) memory.

    The replacement RNG is seeded per-reservoir, so runs reproduce.
    ``summary()`` matches the ``percentiles()`` row shape except that
    ``count`` reports the true stream length, not the reservoir size.
    """

    __slots__ = ("cap", "count", "total_s", "samples", "_rng", "_buckets")

    def __init__(self, cap: int = 2048, seed: int = 0x5eed):
        if cap <= 0:
            raise ValueError("cap must be positive")
        self.cap = cap
        self.count = 0
        self.total_s = 0.0
        self.samples: list[float] = []
        self._rng = random.Random(seed)
        self._buckets = [0] * (len(LATENCY_BUCKETS_S) + 1)   # last = +Inf

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        for b, le in enumerate(LATENCY_BUCKETS_S):
            if seconds <= le:
                self._buckets[b] += 1
                break
        else:
            self._buckets[-1] += 1
        if len(self.samples) < self.cap:
            self.samples.append(seconds)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.samples[j] = seconds

    def __len__(self) -> int:
        return len(self.samples)

    def summary(self) -> dict:
        row = percentiles(self.samples)
        row["count"] = self.count           # true stream length, not |reservoir|
        return row

    def bucket_rows(self) -> list[tuple[float, int]]:
        """``(upper_bound_s, count)`` per bucket, +Inf last, non-cumulative."""
        bounds = list(LATENCY_BUCKETS_S) + [float("inf")]
        return list(zip(bounds, self._buckets))


@dataclasses.dataclass
class CategoryMetrics:
    lookups: int = 0
    hits: int = 0
    positive_hits: int = 0
    judged_hits: int = 0
    cache_latency_s: float = 0.0
    llm_latency_s: float = 0.0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def positive_rate(self) -> float:
        return self.positive_hits / self.judged_hits if self.judged_hits else 0.0

    @property
    def api_call_fraction(self) -> float:
        return 1.0 - self.hit_rate


@dataclasses.dataclass
class TenantMetrics:
    """Host-side per-tenant accounting (mirrors the device-side
    ``TenancyState`` counters, plus latency samples only the host sees)."""

    lookups: int = 0
    hits: int = 0
    coalesced: int = 0
    latency_samples: dict = dataclasses.field(
        default_factory=lambda: defaultdict(LatencyReservoir))
    # path -> LatencyReservoir (bounded, §18.5)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0


@dataclasses.dataclass
class ContextMetrics:
    """One bucket of the context-fused vs single-turn split (§16)."""

    lookups: int = 0
    hits: int = 0
    positive_hits: int = 0
    judged_hits: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    @property
    def positive_rate(self) -> float:
        return self.positive_hits / self.judged_hits if self.judged_hits else 0.0

    def row(self) -> dict:
        return {"lookups": self.lookups, "cache_hits": self.hits,
                "hit_rate": round(self.hit_rate, 4),
                "positive_hits": self.positive_hits,
                "positive_rate": round(self.positive_rate, 4)}


@dataclasses.dataclass
class NearHitMetrics:
    """Band-row accounting for the generative near-hit path (§17.5).

    ``band`` counts lookups landing in [τ_lo, τ_hi); ``served`` is the
    subset the synthesizer converted (the backend calls saved beyond exact
    reuse); the rest abstained back to a full call. ``positives/judged``
    is synthesis precision under the ground-truth judge — the quantity the
    serve-bench near-hit stage asserts > 0.9.
    """

    band: int = 0
    served: int = 0
    positives: int = 0
    judged: int = 0
    synthesis_cost_usd: float = 0.0
    synthesis_time_s: float = 0.0

    @property
    def conversion_rate(self) -> float:
        return self.served / self.band if self.band else 0.0

    @property
    def precision(self) -> float:
        return self.positives / self.judged if self.judged else 0.0

    def row(self) -> dict:
        return {"band_lookups": self.band,
                "near_hits_served": self.served,
                "abstained": self.band - self.served,
                "conversion_rate": round(self.conversion_rate, 4),
                "positive_near_hits": self.positives,
                "near_precision": round(self.precision, 4),
                "synthesis_cost_usd": round(self.synthesis_cost_usd, 6),
                "synthesis_time_s": round(self.synthesis_time_s, 6)}


@dataclasses.dataclass
class ResilienceMetrics:
    """Fault-path accounting for resilient serving (DESIGN.md §20.5).

    ``backend_failures`` counts failed backend calls (including failed
    retries); ``retries`` the §20.3 re-attempts and ``retry_successes``
    the calls a retry rescued; ``breaker_short_circuits`` the calls the
    open breaker refused without touching the backend. ``degraded_*``
    track the §20.4 fallback: rows served from a cached neighbour under
    the relaxed floor (never admitted to the slab), rows with no servable
    neighbour, and the judged quality of what was served. ``shed`` counts
    explicit Overloaded rejections from the scheduler's shed policy.
    """

    backend_failures: int = 0
    retries: int = 0
    retry_successes: int = 0
    breaker_short_circuits: int = 0
    degraded_served: int = 0
    degraded_failed: int = 0
    degraded_judged: int = 0
    degraded_positives: int = 0
    deadline_exhausted: int = 0
    shed: int = 0

    @property
    def degraded_precision(self) -> float:
        return self.degraded_positives / self.degraded_judged \
            if self.degraded_judged else 0.0

    def row(self) -> dict:
        return {"backend_failures": self.backend_failures,
                "retries": self.retries,
                "retry_successes": self.retry_successes,
                "breaker_short_circuits": self.breaker_short_circuits,
                "degraded_served": self.degraded_served,
                "degraded_failed": self.degraded_failed,
                "degraded_precision": round(self.degraded_precision, 4),
                "deadline_exhausted": self.deadline_exhausted,
                "shed": self.shed}


@dataclasses.dataclass
class ServingMetrics:
    per_category: dict = dataclasses.field(
        default_factory=lambda: defaultdict(CategoryMetrics))
    per_tenant: dict = dataclasses.field(
        default_factory=lambda: defaultdict(TenantMetrics))
    context: ContextMetrics = dataclasses.field(
        default_factory=ContextMetrics)       # session rows with a window
    single_turn: ContextMetrics = dataclasses.field(
        default_factory=ContextMetrics)       # stateless / first-turn rows
    context_seen: bool = False                # any contexts=... recorded?
    near: NearHitMetrics = dataclasses.field(
        default_factory=NearHitMetrics)       # band-row accounting (§17)
    near_seen: bool = False                   # any nears=... recorded?
    resilience: ResilienceMetrics = dataclasses.field(
        default_factory=ResilienceMetrics)    # fault-path accounting (§20)
    resilience_seen: bool = False             # resilience configured, or
                                              # any backend failure seen?
    total_cost_usd: float = 0.0
    baseline_cost_usd: float = 0.0          # what 100% API calls would cost
    cache_path_time_s: float = 0.0          # embed + lookup wall time
    llm_path_time_s: float = 0.0            # miss-path LLM latency
    baseline_time_s: float = 0.0            # all-queries-to-LLM latency
    queries: int = 0
    coalesced_calls: int = 0                # requests merged into in-flight
                                            # duplicates (scheduler, §12.3)
    latency_samples: dict = dataclasses.field(
        default_factory=lambda: defaultdict(LatencyReservoir))
    # path -> LatencyReservoir (bounded, §18.5)

    def record_latency(self, path: str, seconds: float,
                       tenant: str | None = None) -> None:
        """One request's end-to-end latency on ``path`` (hit/miss/coalesced).
        ``tenant`` additionally files the sample under that tenant's
        breakdown (multi-tenant serving, §13). Any path name is accepted;
        unknown names simply open a new bounded reservoir."""
        self.latency_samples[path].add(seconds)
        if tenant is not None:
            self.per_tenant[tenant].latency_samples[path].add(seconds)

    def record_coalesced(self, n: int = 1, tenant: str | None = None) -> None:
        """Count requests merged into an in-flight duplicate. Their
        end-to-end latency is recorded separately (at resolution time)
        via ``record_latency("coalesced", ...)``."""
        self.coalesced_calls += n
        if tenant is not None:
            self.per_tenant[tenant].coalesced += n

    def record_batch(self, categories, hits, positives, *, judged,
                     cache_time_s: float, llm_time_s: float,
                     llm_cost: float, baseline_cost: float,
                     baseline_time: float, tenants=None,
                     contexts=None, nears=None, near_served=None,
                     syn_cost: float = 0.0, syn_time: float = 0.0) -> None:
        if contexts is not None:
            self.context_seen = True
        if nears is not None:
            # band rows ([τ_lo, τ_hi) lookups) and the synthesized subset;
            # a served row's judged outcome arrives in ``positives`` at the
            # same index, exactly like an exact hit's does
            self.near_seen = True
            for i in range(len(categories)):
                if bool(nears[i]):
                    self.near.band += 1
                if near_served is not None and bool(near_served[i]):
                    self.near.served += 1
                    if judged is None or judged[i]:
                        self.near.judged += 1
                        if bool(positives[i]):
                            self.near.positives += 1
            self.near.synthesis_cost_usd += syn_cost
            self.near.synthesis_time_s += syn_time
        for i, cat in enumerate(categories):
            m = self.per_category[cat]
            m.lookups += 1
            if bool(hits[i]):
                m.hits += 1
                if judged is None or judged[i]:
                    m.judged_hits += 1
                    if bool(positives[i]):
                        m.positive_hits += 1
            m.cache_latency_s += cache_time_s / max(len(categories), 1)
            m.llm_latency_s += llm_time_s / max(len(categories), 1)
            if tenants is not None:
                t = self.per_tenant[tenants[i]]
                t.lookups += 1
                t.hits += int(bool(hits[i]))
            if contexts is not None:
                c = self.context if bool(contexts[i]) else self.single_turn
                c.lookups += 1
                if bool(hits[i]):
                    c.hits += 1
                    if judged is None or judged[i]:
                        c.judged_hits += 1
                        if bool(positives[i]):
                            c.positive_hits += 1
        self.total_cost_usd += llm_cost
        self.baseline_cost_usd += baseline_cost
        self.cache_path_time_s += cache_time_s
        self.llm_path_time_s += llm_time_s
        self.baseline_time_s += baseline_time
        self.queries += len(categories)

    # ------------------------------------------------------------------ #
    def summary(self) -> dict:
        cats = {}
        for cat, m in sorted(self.per_category.items()):
            cats[cat] = {
                "lookups": m.lookups,
                "cache_hits": m.hits,
                "hit_rate": round(m.hit_rate, 4),
                "positive_hits": m.positive_hits,
                "positive_rate": round(m.positive_rate, 4),
                "api_call_fraction": round(m.api_call_fraction, 4),
            }
        avg_with = ((self.cache_path_time_s + self.llm_path_time_s)
                    / max(self.queries, 1))
        avg_without = self.baseline_time_s / max(self.queries, 1)
        tenants = {}
        for name, t in sorted(self.per_tenant.items()):
            tenants[name] = {
                "lookups": t.lookups,
                "cache_hits": t.hits,
                "hit_rate": round(t.hit_rate, 4),
                "coalesced_calls": t.coalesced,
                "latency_percentiles": {
                    path: res.summary()
                    for path, res in sorted(t.latency_samples.items())},
            }
        context = {}
        if self.context_seen:
            context = {"context": self.context.row(),
                       "single_turn": self.single_turn.row()}
        return {
            "categories": cats,
            "tenants": tenants,
            "context": context,
            "near": self.near.row() if self.near_seen else {},
            "resilience": self.resilience.row()
            if self.resilience_seen else {},
            "queries": self.queries,
            "total_cost_usd": round(self.total_cost_usd, 4),
            "baseline_cost_usd": round(self.baseline_cost_usd, 4),
            "cost_saving_pct": round(
                100 * (1 - self.total_cost_usd
                       / max(self.baseline_cost_usd, 1e-9)), 2),
            "avg_latency_with_cache_s": round(avg_with, 4),
            "avg_latency_without_cache_s": round(avg_without, 4),
            "coalesced_calls": self.coalesced_calls,
            "latency_percentiles": {
                path: res.summary()
                for path, res in sorted(self.latency_samples.items())},
        }
