"""Heavy-tailed request length samplers.

Real serving traffic does not have the neat fixed payload sizes of the
paper's Table 1 micro-benchmark categories: prompt and decode lengths
are heavy-tailed, and the tail is precisely what stresses batching,
KV-block admission, and preemption. This module samples (prompt_len,
max_new_tokens) pairs from seeded distributions, with the paper's
fixed size categories available as the degenerate case so the
micro-benchmark grid and the workload generator share one vocabulary.

  lognormal   int-rounded lognormal clipped to [lo, hi] — the standard
              fit for production prompt-length histograms.
  zipf        bounded Zipf over [lo, hi]: P(k) propto 1/k**alpha.
              Heavier tail, exercises the SJF/starvation trade-off.
  fixed       every request identical — the paper's Table 1 categories
              expressed in the same interface.

All samplers take a numpy Generator (or seed) and return int64 arrays,
never touching the wall clock.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: paper Table 1 payload categories, expressed as token lengths for the
#: serve path (small/medium/large prompt regimes).
SIZE_CATEGORIES: Dict[str, int] = {
    "small": 8,
    "medium": 32,
    "large": 128,
}


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def lognormal_lengths(n: int, *, seed=0, mean: float = 3.0,
                      sigma: float = 0.6, lo: int = 1,
                      hi: int = 256) -> np.ndarray:
    """``n`` int lengths from exp(N(mean, sigma)) clipped to
    ``[lo, hi]``."""
    assert n >= 0 and lo >= 1 and hi >= lo, (n, lo, hi)
    rng = _rng(seed)
    raw = np.exp(rng.normal(mean, sigma, size=n))
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


def zipf_lengths(n: int, *, seed=0, alpha: float = 1.3, lo: int = 1,
                 hi: int = 256) -> np.ndarray:
    """``n`` int lengths from a bounded Zipf over ``[lo, hi]``:
    P(k) propto 1/k**alpha after shifting so ``lo`` maps to rank 1."""
    assert n >= 0 and lo >= 1 and hi >= lo, (n, lo, hi)
    assert alpha > 0, alpha
    rng = _rng(seed)
    ks = np.arange(1, hi - lo + 2, dtype=np.float64)
    p = ks ** -alpha
    p /= p.sum()
    return (lo - 1 + rng.choice(ks, size=n, p=p)).astype(np.int64)


def fixed_lengths(n: int, *, seed=0, value: int = 32) -> np.ndarray:
    """Degenerate sampler: every length is ``value`` (paper Table 1
    categories). ``seed`` is accepted for interface uniformity."""
    assert n >= 0 and value >= 1, (n, value)
    return np.full(n, value, dtype=np.int64)


#: length-sampler registry: kind -> sampler(n, seed=..., **kw)
LENGTHS: Dict[str, object] = {
    "lognormal": lognormal_lengths,
    "zipf": zipf_lengths,
    "fixed": fixed_lengths,
}


def make_lengths(kind: str, n: int, *, seed=0, **kw) -> np.ndarray:
    if kind not in LENGTHS:
        if kind in SIZE_CATEGORIES:  # paper category name as shorthand
            return fixed_lengths(n, seed=seed,
                                 value=SIZE_CATEGORIES[kind])
        raise ValueError(
            f"unknown length sampler {kind!r}; choose from "
            f"{tuple(sorted(LENGTHS))} or a size category "
            f"{tuple(sorted(SIZE_CATEGORIES))}")
    return LENGTHS[kind](n, seed=seed, **kw)


def sample_request_shapes(n: int, *, seed=0,
                          prompt_kind: str = "lognormal",
                          decode_kind: str = "fixed",
                          prompt_kw: dict = None,
                          decode_kw: dict = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``n`` (prompt_len, max_new_tokens) pairs with independent
    substreams so changing one sampler never perturbs the other."""
    root = _rng(seed)
    p_seed, d_seed = root.integers(2**32, size=2)
    prompts = make_lengths(prompt_kind, n, seed=int(p_seed),
                           **(prompt_kw or {}))
    decodes = make_lengths(decode_kind, n, seed=int(d_seed),
                           **(decode_kw or {"value": 4}))
    return prompts, decodes


__all__ = ["LENGTHS", "SIZE_CATEGORIES", "fixed_lengths",
           "lognormal_lengths", "make_lengths",
           "sample_request_shapes", "zipf_lengths"]
