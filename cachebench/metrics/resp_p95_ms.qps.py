"""resp_p95_ms.qps: the window's p95 response time (``harness.end_to_end``:
every request due in the window, from its due time), as a per-layer
metric in a cell where it spreads too widely run to run to take an
end-to-end bound; it moves ``answered_qps``."""


def read(view):
    return view.end_to_end.get("resp_p95_ms")
