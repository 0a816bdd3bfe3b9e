"""queue_wait_ms: mean of the scheduler's ``queue_wait`` spans (arrival
to the flush that takes the request) of the requests that arrived in the
window; front end (``serving/server.py``, ``serving/scheduler.py``)."""
from __future__ import annotations

import statistics


def read(view):
    if not view.batches:
        return None
    w0 = min(b.t0 for b in view.batches)
    w1 = max(b.t1 for b in view.batches)
    xs = [s.duration_s for t in view.traces for s in t.spans
          if s.name == "queue_wait" and w0 <= s.t0 < w1]
    return statistics.fmean(xs) * 1e3 if xs else None
