"""Per-request tracing for the serving stack (DESIGN.md §18.1–§18.2),
PyTorch port of ``repro.obs.trace`` (pure Python, the same code).

The serving metrics answer *rate* questions ("what fraction of lookups
hit?"); they cannot answer *instance* questions ("why did THIS request
miss?", "which stage owns the p99?"). This module adds the missing layer:
a ``RequestTrace`` of timestamped spans threaded through

    AsyncScheduler.submit -> _form_batch -> _serve
    CachedEngine.serve_batch / process
    llm_backend.generate

with the canonical stage names

    queue_wait      admission queue (arrival -> batch formation)
    coalesce_attach waiter attached to an in-flight duplicate leader
    batch_form      deficit-round-robin micro-batch assembly
    embed           host-side query embedding
    device_step     compiled peek lookup (ANN search + threshold decide)
    near_synthesis  host-side band-row synthesis (§17.3)
    backend_call    LLM backend round-trip for the miss set
    insert          fused commit + masked insert (the second jit dispatch)
    respond         detokenize + judge + metrics + response construction

Engine-side spans are *contiguous* by construction (each stage's end is
the next stage's start), so a trace's span sum reconstructs the measured
end-to-end latency — the property the serve-bench obs stage asserts
(span-sum within 10% of e2e at p50/p95).

Sampling (§18.2) is a *retention* policy, decided when a trace finishes:

  * head      — the first ``head`` traces are always kept (startup bugs);
  * rate      — a deterministic fraction ``sample_rate`` of the rest is
                kept (counter-accumulator, no RNG: reproducible runs);
  * slow      — any trace slower than ``slow_threshold_s`` is kept even
                when the rate sampler would drop it (tail outliers are
                exactly the traces worth keeping);
  * tail      — retained traces live in a ring buffer of ``max_traces``,
                so the *most recent* keepers are always available.

When tracing is **off** (``TraceConfig.off()`` / ``tracer=None`` on the
engine) every hook degenerates to a shared ``_NullTrace`` singleton and a
``None`` stage clock: no per-request allocation, no timestamp calls on
the serve path — the hot path is byte-identical in behaviour to the
pre-observability engine.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

#: Canonical stage names, in pipeline order. Exported so benchmarks and
#: the exposition render decompositions in a stable order.
STAGES = ("queue_wait", "coalesce_attach", "batch_form", "embed",
          "device_step", "near_synthesis", "backend_call", "insert",
          "respond")


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Trace collection + retention knobs (§18.2)."""

    sample_rate: float = 1.0        # fraction of traces retained (0..1)
    head: int = 8                   # first N traces always retained
    slow_threshold_s: float | None = None   # retain outliers above this
    max_traces: int = 512           # ring capacity for retained traces

    def __post_init__(self):
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError("sample_rate must be within [0, 1]")
        if self.head < 0 or self.max_traces <= 0:
            raise ValueError("head must be >= 0 and max_traces positive")
        if self.slow_threshold_s is not None and self.slow_threshold_s < 0:
            raise ValueError("slow_threshold_s must be >= 0")

    @staticmethod
    def off() -> "TraceConfig":
        """Collection disabled: the serving hot path allocates nothing."""
        return TraceConfig(sample_rate=0.0, head=0, slow_threshold_s=None)

    @property
    def collecting(self) -> bool:
        return (self.sample_rate > 0.0 or self.head > 0
                or self.slow_threshold_s is not None)


@dataclasses.dataclass
class Span:
    """One timestamped stage. ``t0``/``t1`` are perf_counter seconds on
    this process's clock — only differences are meaningful."""

    name: str
    t0: float
    t1: float

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": round(self.t0, 9),
                "t1": round(self.t1, 9),
                "duration_s": round(self.duration_s, 9)}


class RequestTrace:
    """Spans + attribution for one request's journey through the stack."""

    __slots__ = ("trace_id", "spans", "meta", "e2e_s", "why")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: list[Span] = []
        self.meta: dict = {}
        self.e2e_s: float | None = None    # measured end-to-end (set by the
                                           # owner at resolution time)
        self.why: dict | None = None       # decision attribution (§18.3)

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans.append(Span(name, t0, t1))

    def annotate(self, **fields) -> None:
        self.meta.update(fields)

    @property
    def span_sum_s(self) -> float:
        return sum(s.duration_s for s in self.spans)

    def stage_seconds(self) -> dict:
        """name -> summed seconds (a stage may appear once per batch)."""
        out: dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id,
             "spans": [s.to_dict() for s in self.spans],
             "span_sum_s": round(self.span_sum_s, 9)}
        if self.e2e_s is not None:
            d["e2e_s"] = round(self.e2e_s, 9)
        if self.meta:
            d["meta"] = dict(self.meta)
        if self.why is not None:
            d["why"] = self.why
        return d


class _NullTrace:
    """Shared no-op stand-in when collection is off: every hook is a
    method on ONE module-level singleton — zero per-request allocation."""

    __slots__ = ()
    trace_id = ""
    e2e_s = None
    why = None
    spans: list = []
    meta: dict = {}

    def add(self, name, t0, t1):
        pass

    def annotate(self, **fields):
        pass

    def __bool__(self):
        return False


NULL_TRACE = _NullTrace()


class StageClock:
    """Contiguous stage timing for one batch: ``tick(name)`` closes the
    open stage at ``name`` and opens the next one at the same instant, so
    the recorded spans tile the batch's wall time exactly (no gaps, no
    overlaps — the span-sum invariant)."""

    __slots__ = ("spans", "_t")

    def __init__(self):
        self.spans: list[Span] = []
        self._t = time.perf_counter()

    def tick(self, name: str) -> None:
        t = time.perf_counter()
        self.spans.append(Span(name, self._t, t))
        self._t = t


class Tracer:
    """Owns trace creation, retention sampling and the retained ring."""

    def __init__(self, config: TraceConfig | None = None):
        self.config = config or TraceConfig.off()
        self._seq = itertools.count()
        self._kept_head = 0
        self._acc = 0.0                       # deterministic rate sampler
        self._ring: deque[RequestTrace] = deque(
            maxlen=self.config.max_traces)
        self.started = 0
        self.finished = 0
        self.retained = 0

    @property
    def collecting(self) -> bool:
        return self.config.collecting

    # -- collection ----------------------------------------------------- #
    def start(self, **meta) -> RequestTrace | _NullTrace:
        """New trace, or the shared null trace when collection is off."""
        if not self.config.collecting:
            return NULL_TRACE
        self.started += 1
        t = RequestTrace(f"rt-{next(self._seq):08d}")
        if meta:
            t.meta.update(meta)
        return t

    def stage_clock(self) -> StageClock | None:
        """Per-batch stage clock; None (no timestamp calls) when off."""
        return StageClock() if self.config.collecting else None

    # -- retention ------------------------------------------------------ #
    def _keep(self, trace: RequestTrace) -> bool:
        if self._kept_head < self.config.head:
            self._kept_head += 1
            return True
        slow = self.config.slow_threshold_s
        if slow is not None and (trace.e2e_s or trace.span_sum_s) >= slow:
            return True
        self._acc += self.config.sample_rate
        if self._acc >= 1.0:
            self._acc -= 1.0
            return True
        return False

    def finish(self, trace: RequestTrace | _NullTrace,
               e2e_s: float | None = None) -> None:
        """Close a trace; the retention policy decides whether it lives."""
        if not trace:                          # null trace: off path
            return
        if e2e_s is not None:
            trace.e2e_s = e2e_s
        self.finished += 1
        if self._keep(trace):
            self.retained += 1
            self._ring.append(trace)

    # -- read side ------------------------------------------------------ #
    def traces(self) -> list[RequestTrace]:
        return list(self._ring)

    def drain(self) -> list[dict]:
        """Retained traces as dicts, clearing the ring."""
        out = [t.to_dict() for t in self._ring]
        self._ring.clear()
        return out

    def stage_decomposition(self) -> dict:
        """Per-stage latency decomposition over the retained traces:
        ``{stage: {count, p50_s, p95_s, p99_s, total_s}}`` in pipeline
        order — the per-stage breakdown the serve-bench obs stage and the
        ``/metrics`` exposition report."""
        from repro_torch.serving.metrics import percentiles
        by_stage: dict[str, list[float]] = {}
        for t in self._ring:
            for name, secs in t.stage_seconds().items():
                by_stage.setdefault(name, []).append(secs)
        out = {}
        for name in STAGES:
            if name in by_stage:
                xs = by_stage.pop(name)
                row = percentiles(xs)
                row["total_s"] = round(sum(xs), 6)
                out[name] = row
        for name, xs in sorted(by_stage.items()):   # non-canonical stages
            row = percentiles(xs)
            row["total_s"] = round(sum(xs), 6)
            out[name] = row
        return out
