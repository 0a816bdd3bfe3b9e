"""The knee sweep: one process builds the model once, then serves one
window at each of a list of rates, each on a new engine whose cache is
warmed from the corpus and served the warm-up batches as a benchmark run's
is, so that no rate meets the misses an earlier rate inserted. It logs
what each rate sustained. It found the cells' fixed rates once; the
benchmark's own runs never search for a rate.
"""
from __future__ import annotations

import gc
import json
import time

from cachebench import harness, workload


def run(cell, rates, *, seed: int, seconds: float, device, log) -> None:
    backend = harness.build_backend(cell, seed, device)
    for k, rate in enumerate(rates):
        system = harness.build_system(cell, seed, device, tracing=False,
                                      backend=backend)
        stream = workload.build_stream(cell.traffic, system.corpus, rate,
                                       seconds, seed + k)
        got, _ = harness.offer(system, stream, t_start=time.perf_counter(),
                               trace=False)
        m = harness.end_to_end(got, 0.0)
        w0, w1 = got.window
        late = sum(1 for i in harness.in_window(got)
                   if got.answered[i] is None or got.answered[i] >= w1)
        served = [b for b in system.engine.served if w0 <= b.t0 < w1]
        rows = [len(b.batch) for b in served]
        walls = [b.t1 - b.t0 for b in served]
        hits = sum(1 for i in harness.in_window(got)
                   if got.responses[i] is not None
                   and got.responses[i].cached)
        log("sweep " + json.dumps({
            "rate_qps": rate, "answered_qps": m["answered_qps"],
            "resp_p50_ms": m["resp_p50_ms"], "resp_p95_ms": m["resp_p95_ms"],
            "answered_after_window": late, "batches": len(rows),
            "rows_mean": sum(rows) / max(len(rows), 1),
            "rows_max": max(rows, default=0),
            "hit_share": hits / max(len(harness.in_window(got)), 1),
            "batch_wall_ms_mean": 1e3 * sum(walls) / max(len(walls), 1)}))
        del system, got
        gc.collect()
