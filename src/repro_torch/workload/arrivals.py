"""Seeded open-loop arrival processes on the modeled clock.

Every generator here returns a sorted float64 array of arrival times in
``[0, duration_s)`` — the event stream an open-loop driver fires at the
serve stack regardless of completion progress (the regime where
queueing, shedding, and tail latency actually show up; the paper's
closed-loop benchmarks by construction cannot). All randomness comes
from one ``numpy`` Generator seeded by the caller, so a schedule is a
pure function of its parameters: the same seed replays the same
arrivals, which is what makes recorded traces deterministic.

Three processes:

  poisson   homogeneous Poisson at ``rate`` req/s (exponential
            inter-arrivals) — the memoryless baseline.
  bursty    MMPP-style on-off modulation: dwell times in the ON/OFF
            states are exponential (``on_s`` / ``off_s`` means) and
            arrivals are Poisson at ``rate * burst_factor`` while ON,
            ``rate * idle_factor`` while OFF. Mean rate matches
            ``rate`` when the factors are chosen duty-cycle-neutral;
            the point is correlated load, not a different mean.
  diurnal   inhomogeneous Poisson with a sinusoidal rate curve
            ``rate * (1 + depth*sin(2*pi*t/period_s))``, sampled by
            thinning — the day/night load shape scaled down to a
            benchmark window.

This module never reads the wall clock (CI grep gate): times are
coordinates on the modeled timeline, not timestamps.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(seed) -> np.random.Generator:
    return np.random.default_rng(seed)


def poisson_arrivals(rate: float, duration_s: float, *,
                     seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` req/s over
    ``[0, duration_s)``."""
    assert rate > 0 and duration_s > 0, (rate, duration_s)
    rng = _rng(seed)
    # draw in blocks until the horizon is crossed; E[n] = rate*duration
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


def bursty_arrivals(rate: float, duration_s: float, *, seed: int = 0,
                    burst_factor: float = 4.0,
                    idle_factor: float = 0.25,
                    on_s: float = 1.0, off_s: float = 1.0
                    ) -> np.ndarray:
    """MMPP on-off arrivals: Poisson at ``rate*burst_factor`` during
    exponential ON dwells (mean ``on_s``), ``rate*idle_factor`` during
    OFF dwells (mean ``off_s``). Starts ON."""
    assert rate > 0 and duration_s > 0, (rate, duration_s)
    assert burst_factor > 0 and idle_factor >= 0
    assert on_s > 0 and off_s > 0
    rng = _rng(seed)
    times = []
    t, on = 0.0, True
    while t < duration_s:
        dwell = rng.exponential(on_s if on else off_s)
        r = rate * (burst_factor if on else idle_factor)
        if r > 0:
            seg_t = t
            end = min(t + dwell, duration_s)
            while True:
                seg_t += rng.exponential(1.0 / r)
                if seg_t >= end:
                    break
                times.append(seg_t)
        t += dwell
        on = not on
    return np.asarray(times, dtype=np.float64)


def diurnal_arrivals(rate: float, duration_s: float, *, seed: int = 0,
                     period_s: float = 10.0, depth: float = 0.8
                     ) -> np.ndarray:
    """Inhomogeneous Poisson with rate
    ``rate * (1 + depth*sin(2*pi*t/period_s))``, by thinning against
    the peak rate — the diurnal load curve on a modeled timescale."""
    assert rate > 0 and duration_s > 0, (rate, duration_s)
    assert 0.0 <= depth <= 1.0, depth
    assert period_s > 0, period_s
    rng = _rng(seed)
    peak = rate * (1.0 + depth)
    candidates = poisson_arrivals(peak, duration_s,
                                  seed=rng.integers(2**32))
    lam = rate * (1.0 + depth * np.sin(
        2.0 * np.pi * candidates / period_s))
    keep = rng.random(len(candidates)) < lam / peak
    return candidates[keep]


#: arrival-process registry: kind -> generator(rate, duration_s, ...)
ARRIVALS: Dict[str, object] = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


def make_arrivals(kind: str, rate: float, duration_s: float, *,
                  seed: int = 0, **kw) -> np.ndarray:
    """Dispatch on the registry; unknown kinds fail loudly with the
    valid choices (CLI-facing)."""
    if kind not in ARRIVALS:
        raise ValueError(f"unknown arrival process {kind!r}; choose "
                         f"from {tuple(sorted(ARRIVALS))}")
    return ARRIVALS[kind](rate, duration_s, seed=seed, **kw)


__all__ = ["ARRIVALS", "bursty_arrivals", "diurnal_arrivals",
           "make_arrivals", "poisson_arrivals"]
