"""Bounded latency telemetry for the RPC fabric.

:class:`BoundedHistogram` replaces the unbounded per-call latency lists
the ``MetricsInterceptor`` used to keep: it stores exact samples up to
``exact_cap`` (so small runs report percentiles byte-identical to
``np.percentile`` over the raw values — the behavior tests pin), then
folds into fixed log-spaced buckets, after which memory stays constant
no matter how many samples a long-running serve loop records.
Percentiles from the bucketed state are bucket upper bounds: monotone
in q and within one bucket's relative resolution (~15% at the default
16 buckets/decade) of the true value.

:class:`HistogramRegistry` is the shared sink: every interceptor (and
the serve engine) records into one registry keyed by metric name, so a
process has ONE bounded copy of each distribution instead of one list
per interceptor instance.

Everything here is measured on the *fabric clock* (see
``RpcFabric.now``) — this module never reads wall time itself, which is
what the CI telemetry-clock gate enforces for all of ``repro_torch.rpc``.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np

#: default exact-sample capacity before folding into buckets
EXACT_CAP = 4096


class BoundedHistogram:
    """Latency histogram with two regimes:

    exact    — up to ``exact_cap`` raw samples; percentiles via
               ``np.percentile`` (identical to the unbounded-list
               behavior this class replaces)
    bucketed — past the cap, samples fold into log-spaced buckets
               covering [lo, hi) at ``buckets_per_decade`` resolution
               (plus one underflow and one overflow bucket); memory is
               O(n_buckets) forever after

    ``count``/``total``/``min``/``max`` stay exact in both regimes.
    """

    def __init__(self, *, exact_cap: int = EXACT_CAP,
                 lo: float = 1e-9, hi: float = 1e4,
                 buckets_per_decade: int = 16):
        assert exact_cap >= 1 and lo > 0 and hi > lo
        assert buckets_per_decade >= 1
        self.exact_cap = exact_cap
        self.lo, self.hi = float(lo), float(hi)
        self.buckets_per_decade = buckets_per_decade
        self._n_buckets = (int(math.ceil(
            math.log10(hi / lo) * buckets_per_decade)) + 2)
        self._exact: Optional[List[float]] = []
        self._counts: Optional[np.ndarray] = None
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def bucketed(self) -> bool:
        return self._exact is None

    def _bucket_index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n_buckets - 1
        return 1 + int(math.log10(v / self.lo) * self.buckets_per_decade)

    def _bucket_upper(self, i: int) -> float:
        """Upper edge of bucket i (the percentile estimate returned in
        the bucketed regime; conservative — never under-reports)."""
        if i == 0:
            return self.lo
        if i >= self._n_buckets - 1:
            return self.max if self.max > 0 else self.hi
        return self.lo * 10.0 ** (i / self.buckets_per_decade)

    def _fold(self) -> None:
        self._counts = np.zeros(self._n_buckets, dtype=np.int64)
        for v in self._exact:
            self._counts[self._bucket_index(v)] += 1
        self._exact = None

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if self._exact is not None:
            self._exact.append(value)
            if len(self._exact) > self.exact_cap:
                self._fold()
        else:
            self._counts[self._bucket_index(value)] += 1

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.record(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]. Exact regime: ``np.percentile`` over the raw
        samples. Bucketed regime: the upper edge of the bucket holding
        the q-th sample (monotone in q; min/max stay exact)."""
        assert 0.0 <= q <= 100.0, q
        if self.count == 0:
            return 0.0
        if self._exact is not None:
            return float(np.percentile(np.asarray(self._exact), q))
        if q == 0.0:
            return self.min
        if q == 100.0:
            return self.max
        rank = q / 100.0 * self.count
        cum = np.cumsum(self._counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        return min(self._bucket_upper(i), self.max)

    def percentiles(self, qs: Iterable[float]) -> List[float]:
        return [self.percentile(q) for q in qs]

    def snapshot(self) -> Dict[str, float]:
        """JSON-ready summary (seconds, like the recorded samples)."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "p999": self.percentile(99.9),
        }


class HistogramRegistry:
    """Named :class:`BoundedHistogram` sink shared across interceptors.

    ``hist(name)`` creates on first use; every histogram in one
    registry shares the construction parameters, so the whole
    registry's memory is bounded by ``n_names * O(n_buckets +
    exact_cap)``.
    """

    def __init__(self, *, exact_cap: int = EXACT_CAP,
                 lo: float = 1e-9, hi: float = 1e4,
                 buckets_per_decade: int = 16):
        self._kw = dict(exact_cap=exact_cap, lo=lo, hi=hi,
                        buckets_per_decade=buckets_per_decade)
        self._hists: Dict[str, BoundedHistogram] = {}

    def hist(self, name: str) -> BoundedHistogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = BoundedHistogram(**self._kw)
        return h

    def get(self, name: str) -> Optional[BoundedHistogram]:
        return self._hists.get(name)

    def names(self) -> List[str]:
        return list(self._hists)

    def remove(self, name: str) -> None:
        self._hists.pop(name, None)

    def clear(self) -> None:
        self._hists.clear()

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: h.snapshot() for name, h in self._hists.items()}


__all__ = ["BoundedHistogram", "HistogramRegistry", "EXACT_CAP"]
