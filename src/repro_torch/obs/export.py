"""Metrics export plane: event ring + Prometheus-style text exposition
(DESIGN.md §18.4), PyTorch port of ``repro.obs.export``.

Two complementary drains for the numbers the stack already keeps:

  * ``EventLog`` — a ring-buffered structured event stream (one dict per
    serve step: batch size, hits, near-hits, backend calls, stage times
    and the per-step ``CacheStats`` delta). Bounded by construction
    (``deque(maxlen=...)``) and drained as JSON lines — the greppable
    "what happened, in order" record that aggregate counters destroy.

  * ``prometheus_text`` / ``MetricsExporter`` — a text exposition in the
    Prometheus 0.0.4 format (``# HELP`` / ``# TYPE`` + samples) derived
    from ``ServingMetrics`` (host-side, incl. per-tenant labels), the
    device-side ``CacheStats``/``TenancyState`` counters, and the
    tracer's per-stage latency decomposition. Served from ``GET
    /metrics`` on the TCP front-end and from ``repro_torch.launch.serve
    --metrics-port``; any Prometheus-compatible scraper can poll it.

The device counters are read with one device-to-host copy a scrape
(``CacheStats.host()``, one stacked copy inside ``tenant_stats()``): each
read waits for the card, and a scrape runs on the server's event loop.

No third-party client library (the repo's offline constraint): the
format is plain text and the histogram/summary conventions are followed
by hand — cumulative ``le`` buckets, ``_sum``/``_count`` rows, labeled
quantile gauges.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque

#: Metric families the exposition always emits (CI's scrape assertion and
#: the serve-bench smoke validate against this list, so it is the contract).
REQUIRED_FAMILIES = (
    "repro_queries_total",
    "repro_coalesced_requests_total",
    "repro_lookups_total",
    "repro_cache_hits_total",
    "repro_latency_seconds",
    "repro_latency_quantile_seconds",
    "repro_cost_usd_total",
    "repro_slab_lookups_total",
    "repro_slab_inserts_total",
    "repro_backend_retries_total",
    "repro_breaker_transitions_total",
    "repro_degraded_served_total",
)


class EventLog:
    """Bounded structured event ring with a JSON-lines drain (§18.4)."""

    def __init__(self, capacity: int = 2048):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._seq = itertools.count()
        self._ring: deque[dict] = deque(maxlen=capacity)
        self.emitted = 0                     # total ever (ring holds a tail)

    def emit(self, kind: str, **fields) -> dict:
        ev = {"seq": next(self._seq), "ts": time.time(), "kind": kind}
        ev.update(fields)
        self._ring.append(ev)
        self.emitted += 1
        return ev

    def __len__(self) -> int:
        return len(self._ring)

    def events(self) -> list[dict]:
        return list(self._ring)

    def to_jsonl(self) -> str:
        return "".join(json.dumps(ev, sort_keys=True) + "\n"
                       for ev in self._ring)

    def drain(self) -> list[dict]:
        out = list(self._ring)
        self._ring.clear()
        return out


# --------------------------------------------------------------------- #
# Prometheus-style text exposition
# --------------------------------------------------------------------- #
def _esc(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _fmt(value) -> str:
    f = float(value)
    if f == float("inf"):
        return "+Inf"
    return repr(round(f, 9)) if isinstance(value, float) else str(value)


class _Lines:
    """Accumulates one exposition document, one family at a time."""

    def __init__(self):
        self.lines: list[str] = []

    def family(self, name: str, kind: str, help_text: str) -> None:
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {kind}")

    def sample(self, name: str, labels: dict | None, value) -> None:
        lab = ""
        if labels:
            inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
            lab = "{" + inner + "}"
        self.lines.append(f"{name}{lab} {_fmt(value)}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


def _latency_families(out: _Lines, samples: dict, *, extra_labels: dict):
    """Histogram + quantile rows for one ``path -> LatencyReservoir`` map."""
    for path, res in sorted(samples.items()):
        labels = {**extra_labels, "path": path}
        cum = 0
        for le, n in res.bucket_rows():
            cum += n
            out.sample("repro_latency_seconds_bucket",
                       {**labels, "le": _fmt(le)}, cum)
        out.sample("repro_latency_seconds_sum", labels, res.total_s)
        out.sample("repro_latency_seconds_count", labels, res.count)


def _quantile_rows(out: _Lines, family: str, samples: dict, *,
                   extra_labels: dict):
    for path, res in sorted(samples.items()):
        row = res.summary()
        for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                       ("0.99", "p99_s")):
            out.sample(family,
                       {**extra_labels, "path": path, "quantile": q},
                       row[key])


def prometheus_text(metrics, *, cache_stats=None, tenant_stats=None,
                    tracer=None, capacity: int | None = None,
                    breaker=None) -> str:
    """Render one scrape of the serving stack.

    ``metrics`` is a ``ServingMetrics``; the rest are optional extra
    planes: ``cache_stats`` the device ``CacheStats``, ``tenant_stats``
    the ``CachedEngine.tenant_stats()`` dict, ``tracer`` a
    ``repro_torch.obs.Tracer`` (adds the per-stage decomposition),
    ``capacity`` the slab capacity gauge, ``breaker`` the engine's
    ``CircuitBreaker`` (adds the live state gauge; the transition
    counters are emitted unconditionally — zeros without one — per
    REQUIRED_FAMILIES).
    """
    out = _Lines()
    s = metrics  # host-side ServingMetrics

    out.family("repro_queries_total", "counter",
               "Requests that paid their own lookup (pads excluded).")
    out.sample("repro_queries_total", None, s.queries)

    out.family("repro_coalesced_requests_total", "counter",
               "Requests merged into an in-flight duplicate leader.")
    out.sample("repro_coalesced_requests_total", None, s.coalesced_calls)

    out.family("repro_lookups_total", "counter",
               "Cache lookups by request category.")
    for cat, m in sorted(s.per_category.items()):
        out.sample("repro_lookups_total", {"category": cat}, m.lookups)
    out.family("repro_cache_hits_total", "counter",
               "Cache hits by request category.")
    for cat, m in sorted(s.per_category.items()):
        out.sample("repro_cache_hits_total", {"category": cat}, m.hits)
    out.family("repro_positive_hits_total", "counter",
               "Judge-confirmed hits by request category.")
    for cat, m in sorted(s.per_category.items()):
        out.sample("repro_positive_hits_total", {"category": cat},
                   m.positive_hits)

    out.family("repro_cost_usd_total", "counter",
               "LLM spend with the cache in front.")
    out.sample("repro_cost_usd_total", None, s.total_cost_usd)
    out.family("repro_baseline_cost_usd_total", "counter",
               "What 100% backend calls would have cost.")
    out.sample("repro_baseline_cost_usd_total", None, s.baseline_cost_usd)

    # end-to-end latency: histogram (+Inf-terminated cumulative buckets)
    # and p50/p95/p99 quantile gauges per path
    out.family("repro_latency_seconds", "histogram",
               "End-to-end request latency by serve path.")
    _latency_families(out, s.latency_samples, extra_labels={})
    out.family("repro_latency_quantile_seconds", "gauge",
               "End-to-end latency quantiles by serve path.")
    _quantile_rows(out, "repro_latency_quantile_seconds",
                   s.latency_samples, extra_labels={})

    # per-tenant plane (host-side): the labels multi-tenant dashboards cut by
    if s.per_tenant:
        out.family("repro_tenant_lookups_total", "counter",
                   "Lookups by tenant (host-side accounting).")
        for name, t in sorted(s.per_tenant.items()):
            out.sample("repro_tenant_lookups_total", {"tenant": name},
                       t.lookups)
        out.family("repro_tenant_hits_total", "counter",
                   "Cache hits by tenant.")
        for name, t in sorted(s.per_tenant.items()):
            out.sample("repro_tenant_hits_total", {"tenant": name}, t.hits)
        out.family("repro_tenant_coalesced_total", "counter",
                   "Coalesced requests by tenant.")
        for name, t in sorted(s.per_tenant.items()):
            out.sample("repro_tenant_coalesced_total", {"tenant": name},
                       t.coalesced)
        out.family("repro_tenant_latency_quantile_seconds", "gauge",
                   "Latency quantiles by tenant and serve path.")
        for name, t in sorted(s.per_tenant.items()):
            _quantile_rows(out, "repro_tenant_latency_quantile_seconds",
                           t.latency_samples,
                           extra_labels={"tenant": name})

    # context / near planes (only once the engine recorded them)
    if s.context_seen:
        out.family("repro_context_lookups_total", "counter",
                   "Lookups split by context-fused vs single-turn rows.")
        for bucket, m in (("context", s.context),
                          ("single_turn", s.single_turn)):
            out.sample("repro_context_lookups_total", {"bucket": bucket},
                       m.lookups)
        out.family("repro_context_hits_total", "counter",
                   "Hits split by context-fused vs single-turn rows.")
        for bucket, m in (("context", s.context),
                          ("single_turn", s.single_turn)):
            out.sample("repro_context_hits_total", {"bucket": bucket},
                       m.hits)
    if s.near_seen:
        out.family("repro_near_band_total", "counter",
                   "Lookups scoring inside the [tau_lo, tau_hi) band.")
        out.sample("repro_near_band_total", None, s.near.band)
        out.family("repro_near_served_total", "counter",
                   "Band rows the synthesizer converted.")
        out.sample("repro_near_served_total", None, s.near.served)
        out.family("repro_near_precision", "gauge",
                   "Judge-confirmed precision of served near-hits.")
        out.sample("repro_near_precision", None, s.near.precision)

    # resilience plane (§20.5): the retry/breaker/degraded families are
    # contractual (REQUIRED_FAMILIES) — emitted on every scrape, zeros on
    # a fault-free or resilience-less deployment, so dashboards and
    # alerting rules never see a family appear mid-incident
    r = s.resilience
    out.family("repro_backend_retries_total", "counter",
               "Backend retry attempts after a failed call.")
    out.sample("repro_backend_retries_total", None, r.retries)
    out.family("repro_backend_failures_total", "counter",
               "Failed backend calls (including failed retries).")
    out.sample("repro_backend_failures_total", None, r.backend_failures)
    out.family("repro_degraded_served_total", "counter",
               "Misses served from a cached neighbour in degraded mode.")
    out.sample("repro_degraded_served_total", None, r.degraded_served)
    out.family("repro_overload_shed_total", "counter",
               "Requests rejected with Overloaded by the shed policy.")
    out.sample("repro_overload_shed_total", None, r.shed)
    out.family("repro_deadline_exhausted_total", "counter",
               "Miss rows whose deadline budget expired before an answer.")
    out.sample("repro_deadline_exhausted_total", None, r.deadline_exhausted)
    out.family("repro_breaker_transitions_total", "counter",
               "Circuit breaker transitions by kind.")
    out.sample("repro_breaker_transitions_total", {"transition": "trip"},
               0 if breaker is None else breaker.trips)
    out.sample("repro_breaker_transitions_total", {"transition": "recover"},
               0 if breaker is None else breaker.recoveries)
    if breaker is not None:
        out.family("repro_breaker_state", "gauge",
                   "Breaker state: 0 closed, 1 half-open, 2 open.")
        out.sample("repro_breaker_state", None,
                   {"closed": 0, "half_open": 1, "open": 2}[breaker.state])
        out.family("repro_breaker_short_circuits_total", "counter",
                   "Calls refused by the open breaker.")
        out.sample("repro_breaker_short_circuits_total", None,
                   breaker.short_circuits)

    # device-side plane: the compiled step's own counters
    if cache_stats is not None:
        c = cache_stats.host()         # one copy of the five counters
        out.family("repro_slab_lookups_total", "counter",
                   "Device-side lookups (CacheStats).")
        out.sample("repro_slab_lookups_total", None, c["lookups"])
        out.family("repro_slab_hits_total", "counter",
                   "Device-side hits (CacheStats).")
        out.sample("repro_slab_hits_total", None, c["hits"])
        out.family("repro_slab_inserts_total", "counter",
                   "Device-side inserts (CacheStats).")
        out.sample("repro_slab_inserts_total", None, c["inserts"])
        out.family("repro_slab_expired_evictions_total", "counter",
                   "Entries dropped by TTL expiry (CacheStats).")
        out.sample("repro_slab_expired_evictions_total", None,
                   c["expired_evictions"])
    else:
        # the families are contractual (REQUIRED_FAMILIES): emit zeros so
        # a scraper never sees a family appear/disappear between scrapes
        out.family("repro_slab_lookups_total", "counter",
                   "Device-side lookups (CacheStats).")
        out.sample("repro_slab_lookups_total", None, 0)
        out.family("repro_slab_inserts_total", "counter",
                   "Device-side inserts (CacheStats).")
        out.sample("repro_slab_inserts_total", None, 0)
    if capacity is not None:
        out.family("repro_slab_capacity", "gauge", "Slab slot capacity.")
        out.sample("repro_slab_capacity", None, capacity)

    # device-side per-tenant counters (TenancyState via tenant_stats())
    if tenant_stats:
        out.family("repro_tenant_slab_inserts_total", "counter",
                   "Device-side inserts by tenant (TenancyState).")
        for name, row in sorted(tenant_stats.items()):
            out.sample("repro_tenant_slab_inserts_total", {"tenant": name},
                       row["inserts"])
        out.family("repro_tenant_slab_evictions_total", "counter",
                   "Device-side evictions by tenant (TenancyState).")
        for name, row in sorted(tenant_stats.items()):
            out.sample("repro_tenant_slab_evictions_total",
                       {"tenant": name}, row["evictions"])

    # trace plane: retained-trace counters + per-stage decomposition
    if tracer is not None:
        out.family("repro_traces_retained_total", "counter",
                   "Traces retained by the sampling policy.")
        out.sample("repro_traces_retained_total", None, tracer.retained)
        out.family("repro_traces_finished_total", "counter",
                   "Traces finished (retained or dropped).")
        out.sample("repro_traces_finished_total", None, tracer.finished)
        decomp = tracer.stage_decomposition()
        if decomp:
            out.family("repro_trace_stage_seconds", "gauge",
                       "Per-stage latency quantiles over retained traces.")
            for stage, row in decomp.items():
                for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                               ("0.99", "p99_s")):
                    out.sample("repro_trace_stage_seconds",
                               {"stage": stage, "quantile": q}, row[key])

    return out.text()


class MetricsExporter:
    """Bind the exposition to one engine (the `/metrics` route handler)."""

    def __init__(self, engine):
        self.engine = engine

    def render(self) -> str:
        eng = self.engine
        res = getattr(eng, "resilience", None)
        return prometheus_text(
            eng.metrics,
            cache_stats=eng.stats,
            tenant_stats=eng.tenant_stats() if eng.registry is not None
            else None,
            tracer=eng.tracer,
            capacity=eng.cache.config.capacity,
            breaker=None if res is None else res.breaker)
