"""step_mfu.qps: ``step_mfu``, read the same way, in the cells whose tails
spread too widely run to run to take an end-to-end bound (its ``workloads`` in
BENCHMARK.json); there it moves ``answered_qps``."""
from cachebench.metrics.step_mfu import read  # noqa: F401
