"""generate_ms: mean ``backend_call`` stage of the window's batches that
had misses; miss path (``serving/llm_backend.py`` -> ``models/``)."""
from cachebench.metrics._common import stage_mean_ms


def read(view):
    return stage_mean_ms(view.batches, ("backend_call",), only_misses=True)
