"""Resilient serving: fault injection, retries, breaker, degraded mode.
PyTorch port of ``repro.serving.resilience`` (host Python, no tensors).

The paper's premise is that the cache shields users from the slow, expensive
LLM API — so the cache is exactly the asset that should keep answering when
the backend browns out. This module is the §20 fault layer (DESIGN.md §20):

``FaultyBackend``
    Deterministic, seedable fault schedules — error / timeout / latency-spike
    / brownout windows — over any backend. Windows are keyed by the wrapped
    backend's *call index* (the Nth ``generate()`` call), not wall-clock, so
    tests, loadgen, and the serve_bench chaos stage replay bit-identically.

``RetryPolicy``
    Exponential backoff with deterministic (hash-derived) jitter, bounded by
    the per-request deadline budget carried on ``Request.deadline_ms`` and
    the TCP wire: a retry whose backoff would overrun the caller's remaining
    SLO is not attempted.

``CircuitBreaker``
    closed → open on consecutive-failure or windowed error-rate trip →
    half-open probes after a cooldown → closed on probe success. While open,
    calls are short-circuited without touching the backend.

``ResilienceConfig``
    The bundle the engine takes (``CachedEngine(resilience=...)``). When the
    breaker is open, the budget is exhausted, or retries are spent, the
    engine re-routes failed miss rows through the band/synthesis machinery
    with a relaxed ``degraded_band_lo`` floor: serve the best cached
    neighbour, flag ``Response.degraded=True``, and never admit the answer
    to the slab (DESIGN.md §20.4).

``Overloaded``
    The explicit load-shed rejection raised by the scheduler when
    ``SchedulerConfig.overload_policy == "shed"`` and the queue is full —
    bounded queues instead of unbounded growth.

Everything here is additive: with ``resilience=None`` and no faults injected
the engine and scheduler serve byte for byte as without this module.
``_hash_fraction`` is the reference's (sha256, no RNG state), so fault and
jitter schedules replay the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Sequence

from repro_torch.serving.llm_backend import (BackendError, BackendResult,
                                             BackendTimeout,
                                             BackendUnavailable)

__all__ = [
    "FaultWindow", "FaultSchedule", "FaultyBackend",
    "RetryPolicy", "CircuitBreaker", "ResilienceConfig",
    "Overloaded", "BackendError", "BackendUnavailable", "BackendTimeout",
]


class Overloaded(RuntimeError):
    """Explicit load-shed rejection: the queue is full and the scheduler's
    ``overload_policy`` is ``"shed"``. The caller should back off; nothing
    was enqueued."""


def _hash_fraction(*parts: object) -> float:
    """Deterministic uniform [0, 1) from the given parts (no RNG state)."""
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

_FAULT_KINDS = ("error", "timeout", "latency_spike", "brownout")


@dataclasses.dataclass(frozen=True)
class FaultWindow:
    """One fault window over backend call indexes ``[start, stop)``.

    Kinds (DESIGN.md §20.1):
      - ``error``: every call in the window raises ``BackendUnavailable``.
      - ``timeout``: every call raises ``BackendTimeout`` (semantically the
        call consumed its budget before failing).
      - ``latency_spike``: calls succeed but carry ``extra_latency_s`` more
        reported (and, for blocking backends, slept) latency.
      - ``brownout``: each call fails with probability ``error_rate`` under
        a per-index deterministic coin — partial outage.
    """
    kind: str
    start: int
    stop: int
    error_rate: float = 1.0
    extra_latency_s: float = 0.0

    def __post_init__(self):
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_FAULT_KINDS}")
        if self.stop <= self.start:
            raise ValueError(f"empty fault window [{self.start}, {self.stop})")
        if not 0.0 <= self.error_rate <= 1.0:
            raise ValueError(f"error_rate must be in [0, 1], got {self.error_rate}")
        if self.extra_latency_s < 0.0:
            raise ValueError("extra_latency_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded set of fault windows over backend call indexes.

    ``fault_at(index)`` returns the window that fires for the given call
    index, or None. Brownout windows flip a per-(seed, index) hash coin, so
    the same schedule replayed over the same call sequence injects exactly
    the same faults — no RNG state, no wall-clock.
    """
    windows: tuple[FaultWindow, ...] = ()
    seed: int = 0

    def __init__(self, windows: Sequence[FaultWindow] = (), seed: int = 0):
        object.__setattr__(self, "windows", tuple(windows))
        object.__setattr__(self, "seed", seed)

    def fault_at(self, index: int) -> FaultWindow | None:
        for w in self.windows:
            if not (w.start <= index < w.stop):
                continue
            if w.kind == "brownout" and w.error_rate < 1.0:
                if _hash_fraction(self.seed, index) >= w.error_rate:
                    continue
            return w
        return None


class FaultyBackend:
    """Wrap any backend with a deterministic fault schedule.

    The wrapper keeps its own ``calls_started`` counter (one per
    ``generate()`` invocation, including ones that fault before reaching the
    inner backend) as the schedule key; every other attribute — including
    ``latency_per_call_s`` / ``cost_per_call_usd`` that the engine's
    per-query accounting probes, and the inner ``calls`` counter — delegates
    to the wrapped backend, so the wrapper is drop-in anywhere a backend is
    accepted.
    """

    def __init__(self, inner, schedule: FaultSchedule):
        self.inner = inner
        self.schedule = schedule
        self.calls_started = 0
        self.faults_injected = 0

    def __getattr__(self, name):
        # only reached for names not set on the wrapper itself
        return getattr(self.inner, name)

    def generate(self, queries: Sequence[str],
                 semantic_keys: Sequence[str] | None = None) -> BackendResult:
        idx = self.calls_started
        self.calls_started += 1
        w = self.schedule.fault_at(idx)
        if w is None or w.kind == "latency_spike":
            result = self.inner.generate(queries, semantic_keys)
            if w is not None:
                if getattr(self.inner, "block", False):
                    time.sleep(w.extra_latency_s)
                result = dataclasses.replace(
                    result, latency_s=result.latency_s + w.extra_latency_s)
            return result
        self.faults_injected += 1
        detail = f"call {idx} in window [{w.start}, {w.stop})"
        if w.kind == "timeout":
            raise BackendTimeout(f"injected timeout: {detail}")
        raise BackendUnavailable(f"injected {w.kind}: {detail}")


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter and deadline budgets.

    ``backoff_s(attempt, key=...)`` is a pure function of (policy, attempt,
    key): base · multiplier^(attempt-1), capped, then jittered by a
    hash-derived factor in [1-jitter, 1+jitter] — no RNG state, so retry
    timing replays exactly. ``allows`` enforces both the attempt cap and the
    deadline budget: a retry is only attempted if the elapsed time *plus the
    next backoff* still fits inside the caller's remaining SLO, so retries
    can never overrun ``Request.deadline_ms`` (DESIGN.md §20.3).
    """
    max_attempts: int = 3
    base_backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")

    def backoff_s(self, attempt: int, key: str = "") -> float:
        base = min(self.base_backoff_s * self.multiplier ** max(attempt - 1, 0),
                   self.max_backoff_s)
        if self.jitter <= 0.0:
            return base
        frac = _hash_fraction(self.seed, key, attempt)      # [0, 1)
        return base * (1.0 + self.jitter * (2.0 * frac - 1.0))

    def allows(self, attempt: int, *, elapsed_s: float,
               next_backoff_s: float, budget_s: float | None = None) -> bool:
        """May attempt ``attempt + 1`` start after sleeping ``next_backoff_s``?"""
        if attempt >= self.max_attempts:
            return False
        if budget_s is not None and elapsed_s + next_backoff_s >= budget_s:
            return False
        return True


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """closed → open → half-open → closed state machine (DESIGN.md §20.3).

    Trips (closed → open) on either ``failure_threshold`` consecutive
    failures or a windowed error rate ≥ ``error_rate_threshold`` over the
    last ``window`` outcomes (only once the window is full, so a single
    early failure cannot trip it). While open, ``allow()`` short-circuits
    until ``cooldown_s`` has elapsed on the injected ``clock``; then the
    breaker goes half-open and admits up to ``half_open_probes`` probe
    calls. All probes succeeding closes the breaker (a recovery); any probe
    failing re-opens it (another trip).
    """

    def __init__(self, *, failure_threshold: int = 5, window: int = 16,
                 error_rate_threshold: float = 0.5, cooldown_s: float = 5.0,
                 half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if window < 1:
            raise ValueError("window must be >= 1")
        if not 0.0 < error_rate_threshold <= 1.0:
            raise ValueError("error_rate_threshold must be in (0, 1]")
        if half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")
        self.failure_threshold = failure_threshold
        self.window = window
        self.error_rate_threshold = error_rate_threshold
        self.cooldown_s = cooldown_s
        self.half_open_probes = half_open_probes
        self.clock = clock
        self.state = "closed"
        self.trips = 0
        self.recoveries = 0
        self.short_circuits = 0
        self._consecutive = 0
        self._recent: list[bool] = []        # True = failure, last `window`
        self._opened_at = 0.0
        self._probes_admitted = 0
        self._probe_successes = 0

    def _trip(self) -> None:
        self.state = "open"
        self.trips += 1
        self._opened_at = self.clock()
        self._consecutive = 0
        self._recent.clear()
        self._probes_admitted = 0
        self._probe_successes = 0

    def allow(self) -> bool:
        """May the caller attempt a backend call right now?"""
        if self.state == "closed":
            return True
        if self.state == "open":
            if self.clock() - self._opened_at >= self.cooldown_s:
                self.state = "half_open"
                self._probes_admitted = 0
                self._probe_successes = 0
            else:
                self.short_circuits += 1
                return False
        # half-open: admit a bounded number of probes
        if self._probes_admitted < self.half_open_probes:
            self._probes_admitted += 1
            return True
        self.short_circuits += 1
        return False

    def record_success(self) -> None:
        if self.state == "half_open":
            self._probe_successes += 1
            if self._probe_successes >= self.half_open_probes:
                self.state = "closed"
                self.recoveries += 1
                self._consecutive = 0
                self._recent.clear()
            return
        if self.state == "closed":
            self._consecutive = 0
            self._recent.append(False)
            del self._recent[:-self.window]

    def record_failure(self) -> None:
        if self.state == "half_open":
            self._trip()
            return
        if self.state != "closed":
            return
        self._consecutive += 1
        self._recent.append(True)
        del self._recent[:-self.window]
        if self._consecutive >= self.failure_threshold:
            self._trip()
        elif (len(self._recent) >= self.window
              and sum(self._recent) / len(self._recent)
              >= self.error_rate_threshold):
            self._trip()


# ---------------------------------------------------------------------------
# Engine-facing bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResilienceConfig:
    """Everything the engine's miss path needs to survive a faulty backend.

    ``degraded_band_lo=None`` defers the degraded floor to the band policy's
    ``degraded_lo`` (if a ``BandPolicy`` with one is installed), else 0.55.
    ``sleep``/``clock`` are injectable so tests and the serve_bench chaos
    stage run retry schedules without real wall-clock sleeps.
    """
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    breaker: CircuitBreaker | None = dataclasses.field(
        default_factory=CircuitBreaker)
    degraded_serving: bool = True
    degraded_band_lo: float | None = None
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.degraded_band_lo is not None and not (
                0.0 <= self.degraded_band_lo <= 1.0):
            raise ValueError("degraded_band_lo must be in [0, 1]")
