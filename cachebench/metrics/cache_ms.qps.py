"""cache_ms.qps: ``cache_ms``, read the same way, in the cells whose tails
spread too widely run to run to take an end-to-end bound (its ``workloads`` in
BENCHMARK.json); there it moves ``answered_qps``."""
from cachebench.metrics.cache_ms import read  # noqa: F401
