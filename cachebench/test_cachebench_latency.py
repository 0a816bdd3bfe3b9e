"""Response times run from each request's due time: a stall anywhere,
the generator's own included, raises the tail, where timing from the
submit would hide the part of it spent before the submit."""
import asyncio
import time

from cachebench import harness


class _Server:
    """Answers each request after ``service_s``; the ``stall_at``-th
    submit blocks the event loop for ``stall_s`` first."""

    def __init__(self, service_s=0.002, stall_at=None, stall_s=0.0):
        self.n, self.service_s = 0, service_s
        self.stall_at, self.stall_s = stall_at, stall_s

    async def submit_request(self, req):
        self.n += 1
        if self.n == self.stall_at:
            time.sleep(self.stall_s)          # the loop stalls
        await asyncio.sleep(self.service_s)
        return req


def _run(server, n=40, gap=0.01):
    base = time.perf_counter() + 0.02
    due = [base + i * gap for i in range(n)]
    got = asyncio.run(harness._offer(server, list(range(n)), due,
                                     base + 10.0))
    got.window = (base, base + n * gap)
    return got


def test_a_stall_raises_the_tail():
    calm = harness.end_to_end(_run(_Server()), 0.0)
    stalled_got = _run(_Server(stall_at=5, stall_s=0.2))
    stalled = harness.end_to_end(stalled_got, 0.0)
    assert stalled["resp_p95_ms"] > calm["resp_p95_ms"] + 100.0
    # timed from the submit, the requests held back by the stall would
    # look fast: their submits came late
    late = [stalled_got.submitted[i] - stalled_got.due[i]
            for i in range(len(stalled_got.due))]
    assert max(late) > 0.1
    from_submit = sorted((a - s) * 1e3 for a, s in zip(
        stalled_got.answered, stalled_got.submitted))
    assert from_submit[len(from_submit) // 2] < stalled["resp_p50_ms"]


def test_unanswered_counts_as_waiting_to_the_grace():
    got = _run(_Server(), n=10)
    got.responses[3] = None
    got.answered[3] = None
    m = harness.end_to_end(got, 1.5)
    assert m["resp_p95_ms"] >= harness.GRACE_S * 1e3 * 0.5
    assert m["setup_s"] == 1.5
