"""Resilient serving (DESIGN.md §20), PyTorch port of
``repro.serving.resilience``.

``Overloaded`` is the explicit load-shed rejection raised by the async
scheduler when ``SchedulerConfig.overload_policy == "shed"`` and the queue
is full: bounded queues instead of unbounded growth.

The rest of the reference module (``FaultyBackend``, ``RetryPolicy``,
``CircuitBreaker``, ``ResilienceConfig`` and degraded serving) arrives
with the resilience slice. Until then ``CachedEngine(resilience=...)``
raises, and an engine without one contains a failed backend call to the
rows that needed it (``Response.error``), as the reference engine does.
"""
from __future__ import annotations

__all__ = ["Overloaded"]


class Overloaded(RuntimeError):
    """Explicit load-shed rejection: the queue is full and the scheduler's
    ``overload_policy`` is ``"shed"``. The caller should back off; nothing
    was enqueued."""
