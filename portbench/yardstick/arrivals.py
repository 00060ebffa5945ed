"""Frozen copy of ``repro_torch.workload.arrivals.poisson_arrivals``
(a CPU test holds it to the original's numbers)."""
from __future__ import annotations

import numpy as np


def poisson_arrivals(rate: float, duration_s: float, *,
                     seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` req/s over
    ``[0, duration_s)``."""
    assert rate > 0 and duration_s > 0, (rate, duration_s)
    rng = np.random.default_rng(seed)
    times = []
    t = 0.0
    block = max(16, int(rate * duration_s * 1.2) + 1)
    while t < duration_s:
        gaps = rng.exponential(1.0 / rate, size=block)
        ts = t + np.cumsum(gaps)
        times.append(ts)
        t = float(ts[-1])
    out = np.concatenate(times)
    return out[out < duration_s]
