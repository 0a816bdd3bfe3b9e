"""embed_ms: mean ``embed`` stage (the engine's stage clock) a served
batch of the window; engine (``serving/engine.py`` ->
``embedding/hash_embedder.py``)."""
from cachebench.metrics._common import stage_mean_ms


def read(view):
    return stage_mean_ms(view.batches, ("embed",))
