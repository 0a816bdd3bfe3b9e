"""Serving runtime: the paper's cached query-handling system."""
from repro_torch.serving.engine import (PAD_REQUEST, Batcher, CachedEngine,
                                        Request, Response)
from repro_torch.serving.llm_backend import (BackendError, BackendResult,
                                             BackendTimeout,
                                             BackendUnavailable,
                                             ModelBackend,
                                             SimulatedLLMBackend)
from repro_torch.serving.metrics import ServingMetrics

__all__ = ["PAD_REQUEST", "Batcher", "CachedEngine", "Request", "Response",
           "BackendError", "BackendResult", "BackendTimeout",
           "BackendUnavailable", "ModelBackend", "SimulatedLLMBackend",
           "ServingMetrics"]
