"""Replayable workload traces.

A :class:`Trace` is the frozen artifact between generation and
execution: a schema-versioned, JSON-serialisable list of
:class:`TraceEvent` rows plus optional correlated fault windows. The
split matters for reproducibility — "run Poisson at 40 req/s" is a
recipe, but a trace is the *exact* workload: record one with
``--trace-out``, attach it to a bug report, and ``--trace-in`` replays
the identical arrival times, shapes, and fault schedule on any
machine. Round-tripping through JSON is exact (Python's ``json``
preserves float64 bit patterns), so replayed runs are bit-identical.

Events are stored as compact arrays ``[id, t, prompt_len,
max_new_tokens, rows, worker]`` rather than objects — traces at
realistic rates hold thousands of events and the compact form keeps
them diff-able and small. ``worker`` is the shard hint (-1 = let the
dispatch policy pick). Fault windows are ``[t0, t1, src, dst]`` with
nulls for link wildcards, feeding straight into
``FaultInjectionTransport(burst_windows=...)``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .arrivals import make_arrivals
from .lengths import sample_request_shapes

#: bump when the on-disk layout changes; loaders reject unknown values.
TRACE_SCHEMA = 1


@dataclass(frozen=True)
class TraceEvent:
    """One request in the workload: fire at ``t_s`` on the modeled
    clock with the given shape."""
    id: int
    t_s: float
    prompt_len: int
    max_new_tokens: int
    rows: int = 1
    worker: int = -1  # shard hint; -1 = policy decides

    def to_row(self) -> list:
        return [self.id, self.t_s, self.prompt_len,
                self.max_new_tokens, self.rows, self.worker]

    @classmethod
    def from_row(cls, row: Sequence) -> "TraceEvent":
        i, t, p, m, r, w = row
        return cls(id=int(i), t_s=float(t), prompt_len=int(p),
                   max_new_tokens=int(m), rows=int(r), worker=int(w))


@dataclass
class Trace:
    """An ordered, replayable workload."""
    events: List[TraceEvent]
    seed: int = 0
    meta: Dict[str, object] = field(default_factory=dict)
    #: correlated burst-loss windows (t0, t1, link) where link is a
    #: (src, dst) rank pair or None for all links.
    fault_windows: List[Tuple[float, float,
                              Optional[Tuple[int, int]]]] = \
        field(default_factory=list)

    def __post_init__(self) -> None:
        self.events = sorted(self.events, key=lambda e: (e.t_s, e.id))
        ids = [e.id for e in self.events]
        assert len(ids) == len(set(ids)), "duplicate event ids"

    def __len__(self) -> int:
        return len(self.events)

    @property
    def duration_s(self) -> float:
        return self.events[-1].t_s if self.events else 0.0

    # -- serialisation -------------------------------------------------
    def to_json(self) -> str:
        doc = {
            "schema": TRACE_SCHEMA,
            "seed": self.seed,
            "meta": self.meta,
            "fault_windows": [
                [t0, t1, None if link is None else list(link)]
                for t0, t1, link in self.fault_windows],
            "events": [e.to_row() for e in self.events],
        }
        return json.dumps(doc, indent=None, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        doc = json.loads(text)
        schema = doc.get("schema")
        if schema != TRACE_SCHEMA:
            raise ValueError(
                f"trace schema {schema!r} not supported (this build "
                f"reads schema {TRACE_SCHEMA})")
        windows = [
            (float(t0), float(t1),
             None if link is None else (int(link[0]), int(link[1])))
            for t0, t1, link in doc.get("fault_windows", [])]
        return cls(events=[TraceEvent.from_row(r)
                           for r in doc["events"]],
                   seed=int(doc.get("seed", 0)),
                   meta=doc.get("meta", {}),
                   fault_windows=windows)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls.from_json(f.read())


def synthesize_trace(kind: str, rate: float, duration_s: float, *,
                     seed: int = 0,
                     prompt_kind: str = "lognormal",
                     decode_kind: str = "fixed",
                     prompt_kw: dict = None,
                     decode_kw: dict = None,
                     arrival_kw: dict = None) -> Trace:
    """Generate a trace from an arrival process + length samplers.

    Arrivals and shapes draw from independent substreams of ``seed``,
    so the same seed always yields the same trace regardless of how
    either sampler's internal draw count changes.
    """
    root = np.random.default_rng(seed)
    a_seed, s_seed = (int(x) for x in root.integers(2**32, size=2))
    times = make_arrivals(kind, rate, duration_s, seed=a_seed,
                          **(arrival_kw or {}))
    prompts, decodes = sample_request_shapes(
        len(times), seed=s_seed, prompt_kind=prompt_kind,
        decode_kind=decode_kind, prompt_kw=prompt_kw,
        decode_kw=decode_kw)
    events = [TraceEvent(id=i, t_s=float(t), prompt_len=int(p),
                         max_new_tokens=int(m))
              for i, (t, p, m) in enumerate(zip(times, prompts,
                                                decodes))]
    meta = {"kind": kind, "rate": rate, "duration_s": duration_s,
            "prompt_kind": prompt_kind, "decode_kind": decode_kind}
    return Trace(events=events, seed=seed, meta=meta)


def correlated_burst_windows(trace: Trace, *, n_windows: int = 1,
                             width_s: float = 0.5,
                             link: Optional[Tuple[int, int]] = None,
                             seed: Optional[int] = None
                             ) -> List[Tuple[float, float,
                                             Optional[Tuple[int,
                                                            int]]]]:
    """Attach ``n_windows`` burst-loss windows of ``width_s`` each,
    placed uniformly over the trace's span (seeded off the trace seed
    by default so the fault schedule is as replayable as the
    arrivals). Returns the windows and records them on the trace."""
    assert n_windows >= 1 and width_s > 0, (n_windows, width_s)
    span = max(trace.duration_s, width_s)
    rng = np.random.default_rng(
        trace.seed + 0x5F0 if seed is None else seed)
    starts = np.sort(rng.uniform(0.0, max(span - width_s, 1e-9),
                                 size=n_windows))
    windows = [(float(t0), float(t0 + width_s), link)
               for t0 in starts]
    trace.fault_windows.extend(windows)
    return windows


__all__ = ["TRACE_SCHEMA", "Trace", "TraceEvent",
           "correlated_burst_windows", "synthesize_trace"]
