"""flash_attn_roofline.qps: ``flash_attn_roofline``, read the same way, in the
cells whose tails spread too widely run to run to take an end-to-end bound (its
``workloads`` in BENCHMARK.json); there it moves ``answered_qps``."""
from cachebench.metrics.flash_attn_roofline import read  # noqa: F401
