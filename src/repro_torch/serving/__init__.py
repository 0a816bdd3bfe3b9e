"""Serving runtime: the paper's cached query-handling system, plus the
async continuous-batching layer in front of it (DESIGN.md §12)."""
from repro_torch.serving.engine import (PAD_REQUEST, Batcher, CachedEngine,
                                        Request, Response)
from repro_torch.serving.llm_backend import (BackendError, BackendResult,
                                             BackendTimeout,
                                             BackendUnavailable,
                                             ModelBackend,
                                             SimulatedLLMBackend)
from repro_torch.serving.loadgen import (LoadResult, availability,
                                         build_multi_tenant_workload,
                                         build_multi_turn_workload,
                                         build_workload, run_closed_loop,
                                         run_open_loop, run_sessions,
                                         run_waves, tenant_rng, turn_levels,
                                         zipf_weights)
from repro_torch.serving.metrics import (CategoryMetrics, ContextMetrics,
                                         NearHitMetrics, ResilienceMetrics,
                                         ServingMetrics, TenantMetrics)
from repro_torch.serving.resilience import (CircuitBreaker, FaultSchedule,
                                            FaultWindow, FaultyBackend,
                                            Overloaded, ResilienceConfig,
                                            RetryPolicy)
from repro_torch.serving.scheduler import (AsyncScheduler, SchedulerConfig,
                                           coalesce_key, normalize_query)
from repro_torch.serving.server import AsyncCacheServer

__all__ = ["PAD_REQUEST", "Batcher", "CachedEngine", "Request", "Response",
           "BackendResult", "BackendError", "BackendTimeout",
           "BackendUnavailable", "ModelBackend", "SimulatedLLMBackend",
           "CategoryMetrics", "ContextMetrics", "NearHitMetrics",
           "ResilienceMetrics", "ServingMetrics", "TenantMetrics",
           "CircuitBreaker", "FaultSchedule", "FaultWindow", "FaultyBackend",
           "Overloaded", "ResilienceConfig", "RetryPolicy",
           "AsyncScheduler", "SchedulerConfig", "coalesce_key",
           "normalize_query", "AsyncCacheServer", "LoadResult",
           "availability", "build_workload", "build_multi_tenant_workload",
           "build_multi_turn_workload", "tenant_rng", "turn_levels",
           "zipf_weights", "run_closed_loop", "run_open_loop",
           "run_sessions", "run_waves"]
