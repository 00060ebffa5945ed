"""The serving path's live regions in a device trace: the profiler ranges
the port opens when it serves with a tracer (``rpc.flush`` around
``sched.step``, around the engine's ``serve.prefill`` / ``serve.rebuild``
/ ``serve.decode`` ops, each ``serve.launch`` then ``serve.to_host``),
found among ``DeviceTrace.host`` and set against the device's busy
intervals. Everything is clipped to the trace's ``bounds``.

A program without these ranges leaves ``ranges`` empty, and every
reader built on it then reports nothing."""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import List, Tuple

from portbench.devtrace import merged

Span = Tuple[float, float]

#: the engine's op regions: one op of one request each
ENGINE = ("serve.prefill", "serve.rebuild", "serve.decode")


def traced(rec):
    """The record's device trace, or None where there is none to read."""
    tr = rec.get("trace")
    if tr is None or tr.bounds is None or tr.window_s <= 0 \
            or not tr.device:
        return None
    return tr


def _clip(tr, a: float, b: float):
    lo, hi = tr.bounds
    a, b = max(a, lo), min(b, hi)
    return (a, b) if b > a else None


def ranges(tr, *names: str) -> List[Span]:
    """The host ranges named one of ``names``, clipped, by start."""
    out = [_clip(tr, a, b) for n, a, b in tr.host if n in names]
    return sorted(iv for iv in out if iv is not None)


def union(spans: List[Span]) -> List[Span]:
    return merged([("", a, b) for a, b in spans])


def busy(tr) -> List[Span]:
    """The device's busy time, as sorted disjoint clipped intervals."""
    out = [_clip(tr, a, b) for a, b in merged(tr.device)]
    return [iv for iv in out if iv is not None]


def covered(spans: List[Span], disjoint: List[Span]) -> List[float]:
    """For each of ``spans`` (sorted by start): the seconds of it that
    the sorted disjoint intervals ``disjoint`` cover."""
    out, j = [], 0
    for a, b in spans:
        while j < len(disjoint) and disjoint[j][1] <= a:
            j += 1
        t, k = 0.0, j
        while k < len(disjoint) and disjoint[k][0] < b:
            t += min(b, disjoint[k][1]) - max(a, disjoint[k][0])
            k += 1
        out.append(t)
    return out


def minus(spans: List[Span], cut: List[Span]) -> List[Span]:
    """Sorted disjoint ``spans`` less sorted disjoint ``cut``."""
    out, j = [], 0
    for a, b in spans:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < b:
            if cut[k][0] > a:
                out.append((a, cut[k][0]))
            a = max(a, cut[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def idle(tr, spans: List[Span]) -> float:
    """Seconds inside sorted disjoint ``spans`` with nothing on the
    device."""
    return sum(b - a for a, b in spans) - sum(covered(spans, busy(tr)))


def nested(inner: List[Span], outer: List[Span]) -> List[Span]:
    """The ``inner`` spans that lie inside one of the sorted disjoint
    ``outer`` spans."""
    starts = [a for a, _ in outer]
    out = []
    for a, b in inner:
        i = bisect_right(starts, a) - 1
        if i >= 0 and b <= outer[i][1]:
            out.append((a, b))
    return out


def starts_inside(tr, spans: List[Span]) -> int:
    """Device operations (kernels, copies, sets) that start inside one
    of the sorted disjoint ``spans``."""
    starts = sorted(a for _, a, _ in tr.device)
    return sum(bisect_left(starts, b) - bisect_left(starts, a)
               for a, b in spans)
