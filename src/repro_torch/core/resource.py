"""Resource-utilization monitor (paper §3.1 "Resource Utilization").

Samples process RSS and CPU time on a background thread during a timed
window; no psutil dependency (reads /proc)."""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError):
        return 0


@dataclass
class ResourceReport:
    duration_s: float
    cpu_time_s: float
    cpu_util: float           # cpu seconds / wall seconds
    rss_peak_bytes: int
    rss_mean_bytes: float
    samples: int


class ResourceMonitor:
    """with ResourceMonitor() as mon: ... ; mon.report"""

    def __init__(self, interval_s: float = 0.05):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._rss: List[int] = []
        self.report: Optional[ResourceReport] = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self._rss.append(_rss_bytes())

    def __enter__(self):
        self._t0 = time.perf_counter()
        t = os.times()
        self._cpu0 = t.user + t.system
        self._rss.append(_rss_bytes())
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=1.0)
        wall = time.perf_counter() - self._t0
        t = os.times()
        cpu = (t.user + t.system) - self._cpu0
        rss = self._rss or [0]
        self.report = ResourceReport(
            duration_s=wall, cpu_time_s=cpu,
            cpu_util=cpu / max(wall, 1e-9),
            rss_peak_bytes=max(rss),
            rss_mean_bytes=sum(rss) / len(rss),
            samples=len(rss))
        return False
