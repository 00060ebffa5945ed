"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
bounded sub-window, read back as plain intervals.

``busy_s`` is the union of the device operations' intervals (kernels,
copies, sets), so operations that overlap count once; ``window_s`` the
host-clock length of the sub-window. The breakdown names the device
operations that took most time and the longest idle gaps by the host
operation that was running across each."""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

Interval = Tuple[str, float, float]      # (name, start_s, end_s)


def _times(ev) -> Tuple[float, float]:
    if hasattr(ev, "start_ns"):
        t0 = ev.start_ns() * 1e-9
        return t0, t0 + ev.duration_ns() * 1e-9
    t0 = ev.start_us() * 1e-6
    return t0, t0 + ev.duration_us() * 1e-6


def merged(intervals: List[Interval]) -> List[Tuple[float, float]]:
    """The union of the intervals, as sorted disjoint (start, end)."""
    out: List[List[float]] = []
    for _, a, b in sorted(intervals, key=lambda iv: iv[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in merged(intervals))


class DeviceTrace:
    """``start()`` / ``stop()`` around the sub-window, between two
    synchronised points of the driver; then ``device`` (the kernels,
    copies and sets), ``host`` (the CPU operations) and ``bounds`` (the
    sub-window on the trace's clock)."""

    START, END = "portbench.trace_start", "portbench.trace_end"

    def __init__(self):
        self.device: List[Interval] = []
        self.host: List[Interval] = []
        self.bounds: Optional[Tuple[float, float]] = None
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def prime(self) -> None:
        """Starts and stops the profiler once, in set-up: its first start
        takes seconds, which would otherwise eat the sub-window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def start(self) -> float:
        """Starts tracing; returns the host clock once it runs (starting
        the profiler takes a while: time the sub-window from here)."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()
        with record_function(self.START):
            pass
        return self._t0

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import record_function
        torch.cuda.synchronize()
        with record_function(self.END):
            pass
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()
        marks = {}
        for ev in self._prof.profiler.kineto_results.events():
            name = ev.name()
            t0, t1 = _times(ev)
            if ev.device_type() == DeviceType.CUDA:
                self.device.append((name, t0, t1))
            elif name in (self.START, self.END):
                marks[name] = t0
            else:
                self.host.append((name, t0, t1))
        self._prof = None
        lo = marks.get(self.START, min((a for _, a, _ in self.device),
                                       default=0.0))
        hi = marks.get(self.END, max((b for _, _, b in self.device),
                                     default=lo))
        self.bounds = (lo, hi)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def busy_s(self) -> float:
        return busy_seconds(self.device)

    def named(self, *words: str) -> List[Interval]:
        """Device operations whose lower-cased name holds one of
        ``words``."""
        return [iv for iv in self.device
                if any(w in iv[0].lower() for w in words)]

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], s] for name, s in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest spans in the sub-window with nothing on the
        device, each named by the innermost host operation that covers
        its middle ("host: none" where none does)."""
        lo, hi = self.bounds
        busy = merged(self.device)
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, min(a, hi)))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            cover = [iv for iv in self.host if iv[1] <= mid <= iv[2]]
            name = (min(cover, key=lambda iv: iv[2] - iv[1])[0]
                    if cover else "host: none")
            out.append([name[:120], b - a])
        return out
