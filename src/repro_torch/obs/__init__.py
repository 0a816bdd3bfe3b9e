"""Observability plane: request tracing, decision attribution, export
(PyTorch port of ``repro.obs``).

Three modules, one per question the aggregate metrics can't answer:

  * :mod:`repro_torch.obs.trace`   — "which stage owns the p99?"
  * :mod:`repro_torch.obs.explain` — "why did THIS request miss?"
  * :mod:`repro_torch.obs.export`  — "what is the stack doing right now?"

See DESIGN.md §18.
"""
from repro_torch.obs.explain import build_why, effective_edges
from repro_torch.obs.export import (EventLog, MetricsExporter,
                                    REQUIRED_FAMILIES, prometheus_text)
from repro_torch.obs.trace import (NULL_TRACE, STAGES, RequestTrace, Span,
                                   StageClock, TraceConfig, Tracer)

__all__ = [
    "NULL_TRACE", "STAGES", "RequestTrace", "Span", "StageClock",
    "TraceConfig", "Tracer", "build_why", "effective_edges", "EventLog",
    "MetricsExporter", "REQUIRED_FAMILIES", "prometheus_text",
]
