"""Per-layer metric readers, one module a metric, named as the metric in
``BENCHMARK.json``: ``metrics/<name>.py``, loaded by its path, so a name
may hold a dot (``queue_wait_ms.qps``). Each has ``read(view) -> float |
None`` over a ``harness.TraceView``; ``None`` when it finds nothing to
read, and the harness then leaves the metric out of the line."""
import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str):
    """The reader module of per-layer metric ``name``."""
    mod = f"cachebench.metrics.{name}"
    if mod not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod, HERE / f"{name}.py")
        m = importlib.util.module_from_spec(spec)
        sys.modules[mod] = m
        spec.loader.exec_module(m)
    return sys.modules[mod]
