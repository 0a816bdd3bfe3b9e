"""generate_ms.qps: ``generate_ms``, read the same way, in the cells whose
tails spread too widely run to run to take an end-to-end bound (its
``workloads`` in BENCHMARK.json); there it moves ``answered_qps``."""
from cachebench.metrics.generate_ms import read  # noqa: F401
