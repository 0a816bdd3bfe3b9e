"""Reduction of a ``torch.profiler`` trace of the card to what the
per-layer metrics and the breakdown read: the device's operations
(kernels, copies, sets) as intervals, their union (busy time), time by
operation name, and the idle gaps between them, each named by the host
stage that was running when it began.

The profiler stamps events on the wall clock (ns since the epoch); the
host's spans are on ``time.perf_counter``. ``Slice`` keeps the offset
between the two, read at the same instant when profiling starts.

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import time

import torch


class Profiler:
    """The card's activity (kernels, copies, sets) through the profiler's
    own start and stop, without ``torch.profiler.profile``'s parse of
    every event into Python objects, which takes minutes for a few hundred
    thousand kernels. Start and stop it on one thread."""

    def __init__(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        acts = {torch.profiler.ProfilerActivity.CUDA}
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False, _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts)

    @staticmethod
    def stop():
        """The profiler's results (``.events()``)."""
        from torch.autograd import _disable_profiler
        return _disable_profiler()


@dataclasses.dataclass
class Slice:
    """One profiled stretch: its bounds on the host clock, the offset of
    the profiler's clock, and the device intervals in host seconds."""

    t0: float
    t1: float = 0.0
    offset_s: float = 0.0
    ops: list = dataclasses.field(default_factory=list)  # (name, t0, t1)

    @staticmethod
    def begin() -> "Slice":
        wall, perf = time.time_ns(), time.perf_counter_ns()
        return Slice(t0=perf / 1e9, offset_s=(wall - perf) / 1e9)

    def end(self, results) -> None:
        """Keep the device's operations of the profiler's ``results``
        within [t0, t1], clipped to it."""
        for ev in results.events():
            if "CUDA" not in str(ev.device_type()):
                continue
            s = ev.start_ns() / 1e9 - self.offset_s
            e = s + ev.duration_ns() / 1e9
            if e > self.t0 and s < self.t1:
                self.ops.append((ev.name(), max(s, self.t0),
                                 min(e, self.t1)))
        self.ops.sort(key=lambda o: o[1])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, end = 0.0, float("-inf")
        for _, s, e in self.ops:
            if s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy

    def time_of(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(([k[:200], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, host_spans, n: int = 10) -> list:
        """The ``n`` longest idle gaps, each named by the host span
        (name, t0, t1) it began in, else ``between_batches``."""
        gaps, end = [], self.t0
        for _, s, e in self.ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        out = []
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            label = "between_batches"
            for name, h0, h1 in host_spans:
                if h0 <= g0 < h1:
                    label = name
                    break
            out.append([label, g1 - g0])
        return out
