"""cache_ms: mean ``device_step`` plus ``insert`` stages a served batch of
the window (each ends in a host copy that waits for the card); cache
(``core/cache.py`` -> ``kernels/ops.py`` -> ``csrc/cosine_topk.cu``)."""
from cachebench.metrics._common import stage_mean_ms


def read(view):
    return stage_mean_ms(view.batches, ("device_step", "insert"))
