"""Frozen copy of ``repro_torch.workload.lengths.lognormal_lengths``
(a CPU test holds it to the original's numbers)."""
from __future__ import annotations

import numpy as np


def lognormal_lengths(n: int, *, seed=0, mean: float = 3.0,
                      sigma: float = 0.6, lo: int = 1,
                      hi: int = 256) -> np.ndarray:
    """``n`` int lengths from exp(N(mean, sigma)) clipped to
    ``[lo, hi]``."""
    assert n >= 0 and lo >= 1 and hi >= lo, (n, lo, hi)
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    raw = np.exp(rng.normal(mean, sigma, size=n))
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)
