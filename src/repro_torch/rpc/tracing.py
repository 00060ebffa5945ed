"""Distributed tracing for the RPC fabric (the gRPC census/OpenCensus
analogue).

Every call gets a **trace id**, carried across endpoints in its own
frame-header word (stamped at flight departure next to ``budget_us`` —
see :mod:`repro_torch.rpc.framing`), so a server can attribute its spans to
the originating call without any in-process state sharing. A
:class:`Tracer` attached to a fabric (``RpcFabric(..., tracer=t)``)
records a span tree per call, every timestamp on the **fabric clock**
(``RpcFabric.now``): modeled transports yield deterministic traces,
measured ones wall-clock traces.

Span tree of one call::

    call <method>                      (client endpoint track)
      attempt 1          dst=ps0
        queue | credit_stall | wire | server | reply    <- phases
        wire src->dst                  (per delivered frame)
        server: admit / handler / shed (server endpoint track)
      backoff                          (between attempts, on the root)
      attempt 2          dst=ps1      <- retry after re-route
        ...

*Phases* are special: within one call they are a contiguous,
non-overlapping partition of [start, end] — at every lifecycle event
the fabric closes the open phase and opens the next at the same clock
reading, so per-call phase durations sum exactly to the end-to-end
latency. That is the invariant the hypothesis tier asserts and the
per-phase breakdown ``bench_comm --json`` reports.

Export: :meth:`Tracer.export_chrome` writes Chrome trace-event JSON
(one track per endpoint, loadable at https://ui.perfetto.dev);
:meth:`Tracer.phase_breakdown` aggregates phase totals per method.
This module never reads wall time itself (CI telemetry-clock gate).
"""
from __future__ import annotations

import json
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

#: the client-side phase names, in lifecycle order
PHASES = ("queue", "credit_stall", "wire", "server", "reply", "backoff")

#: trace_id is a uint32 header word (0 = untraced)
MAX_TRACE_ID = 0xFFFFFFFF


@dataclass
class Span:
    """One node of a call's span tree. ``end_s is None`` while open;
    ``category`` is one of call/attempt/phase/wire/server/fault."""
    span_id: int
    trace_id: int
    name: str
    category: str
    start_s: float
    end_s: Optional[float] = None
    parent_id: Optional[int] = None
    endpoint: Optional[int] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return (self.end_s - self.start_s) if self.end_s is not None \
            else 0.0

    @property
    def closed(self) -> bool:
        return self.end_s is not None

    def walk(self) -> Iterator["Span"]:
        """This span and every descendant, depth-first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def phase_spans(self) -> List["Span"]:
        return [s for s in self.walk() if s.category == "phase"]

    def attempt_spans(self) -> List["Span"]:
        return [s for s in self.walk() if s.category == "attempt"]


class _CallState:
    """Live bookkeeping for one in-flight call."""
    __slots__ = ("root", "attempt", "phase")

    def __init__(self, root: Span, attempt: Span, phase: Span):
        self.root = root
        self.attempt = attempt
        self.phase = phase      # the OPEN phase span


class Tracer:
    """Fabric-attached span recorder. Construct, pass to
    ``RpcFabric(..., tracer=tracer)`` (which calls :meth:`bind`), run
    calls, then query ``calls()`` / ``phase_breakdown()`` or
    ``export_chrome(path)``. All hooks are cheap no-ops for calls the
    tracer is not tracking, and tracking stops (``dropped`` counts)
    once ``max_spans`` is reached, so a tracer left attached to a
    long benchmark loop cannot grow without bound."""

    def __init__(self, *, max_spans: int = 200_000):
        assert max_spans >= 1
        self.max_spans = max_spans
        self.dropped = 0
        self._clock = None
        self._ep_name = str
        self._spans: List[Span] = []
        self._by_call: Dict[int, _CallState] = {}
        self._by_trace: Dict[int, _CallState] = {}
        self._next_trace = 1
        self._next_span = 1

    # binding ----------------------------------------------------------
    def bind(self, fabric) -> "Tracer":
        """Adopt the fabric's clock and endpoint naming. Called by
        ``RpcFabric.__init__``; idempotent."""
        self._clock = fabric.now
        namer = getattr(fabric.transport, "endpoint_name", None)
        if callable(namer):
            self._ep_name = namer
        return self

    def now(self) -> float:
        return self._clock() if self._clock is not None else 0.0

    def new_trace_id(self) -> int:
        tid = self._next_trace
        self._next_trace = (self._next_trace % MAX_TRACE_ID) + 1
        return tid

    # span plumbing ----------------------------------------------------
    def _span(self, name: str, category: str, trace_id: int,
              start_s: float, *, parent: Optional[Span] = None,
              endpoint: Optional[int] = None,
              attrs: Optional[Dict[str, Any]] = None) -> Span:
        s = Span(self._next_span, trace_id, name, category, start_s,
                 parent_id=parent.span_id if parent is not None else None,
                 endpoint=endpoint, attrs=attrs or {})
        self._next_span += 1
        self._spans.append(s)
        if parent is not None:
            parent.children.append(s)
        return s

    def _set_phase(self, st: _CallState, name: str, t: float,
                   *, parent: Optional[Span] = None) -> None:
        if st.phase is not None and st.phase.name == name \
                and st.phase.end_s is None:
            return
        if st.phase is not None and st.phase.end_s is None:
            st.phase.end_s = t
        st.phase = self._span(name, "phase", st.root.trace_id, t,
                              parent=parent or st.attempt,
                              endpoint=st.root.endpoint)

    def _state_for_frame(self, frame) -> Optional[_CallState]:
        """Server-side lookup: the propagated trace-id header word
        first (cross-endpoint context), the in-process call id as the
        fallback for frames that never crossed a stamped flight."""
        st = None
        if getattr(frame, "trace_id", 0):
            st = self._by_trace.get(frame.trace_id)
        return st if st is not None else self._by_call.get(frame.call_id)

    # fabric hooks: call lifecycle ------------------------------------
    def on_call_start(self, ctx, src: int) -> None:
        """A new CallContext opened: assign its trace id and open the
        root/attempt/queue spans on the client endpoint's track."""
        ctx.trace_id = self.new_trace_id()
        if len(self._spans) >= self.max_spans:
            self.dropped += 1
            return
        root = self._span(ctx.method, "call", ctx.trace_id, ctx.start_s,
                          endpoint=src,
                          attrs={"call_id": ctx.call_id,
                                 "kind": ctx.kind,
                                 "dst": self._ep_name(ctx.dst)})
        attempt = self._span("attempt 1", "attempt", ctx.trace_id,
                             ctx.start_s, parent=root, endpoint=src,
                             attrs={"dst": self._ep_name(ctx.dst)})
        st = _CallState(root, attempt, None)
        self._set_phase(st, "queue", ctx.start_s)
        self._by_call[ctx.call_id] = st
        self._by_trace[ctx.trace_id] = st

    def on_stall(self, call_id: int) -> None:
        """A frame of this call queued behind a credit window."""
        st = self._by_call.get(call_id)
        if st is not None:
            self._set_phase(st, "credit_stall", self.now())

    def on_admit(self, call_id: int, *, reply: bool = False) -> None:
        """A window-stalled frame was re-admitted to the next flight."""
        st = self._by_call.get(call_id)
        if st is not None and st.phase is not None \
                and st.phase.name == "credit_stall":
            self._set_phase(st, "reply" if reply else "queue", self.now())

    def on_depart(self, call_id: int, t: float) -> None:
        """A request frame of this call left in a flight."""
        st = self._by_call.get(call_id)
        if st is not None:
            self._set_phase(st, "wire", t)

    def on_wire(self, msg, t0: float, t1: float) -> None:
        """One delivered frame: a wire span on the source track."""
        st = self._state_for_frame(msg.frame)
        if st is None:
            return
        # wire spans are records, not phase transitions
        s = self._span(f"wire {self._ep_name(msg.src)}->"
                       f"{self._ep_name(msg.dst)}", "wire",
                       st.root.trace_id, t0, parent=st.attempt,
                       endpoint=msg.src,
                       attrs={"bytes": msg.frame.total_bytes,
                              "seq": msg.frame.seq,
                              "reply": msg.frame.is_reply})
        s.end_s = t1

    def on_fault(self, msg, t: float) -> None:
        """A FaultInjectionTransport lost this frame: instant span."""
        st = self._state_for_frame(msg.frame)
        if st is None:
            return
        s = self._span(f"link_fault {self._ep_name(msg.src)}->"
                       f"{self._ep_name(msg.dst)}", "fault",
                       st.root.trace_id, t, parent=st.attempt,
                       endpoint=msg.dst,
                       attrs={"bytes": msg.frame.total_bytes})
        s.end_s = t

    def on_server(self, call_id: int, t: float) -> None:
        """The call's frame reached its server; dispatch is starting."""
        st = self._by_call.get(call_id)
        if st is not None:
            self._set_phase(st, "server", t)

    def on_dispatched(self, call_id: int, t: float, *,
                      replying: bool) -> None:
        """Dispatch returned: a reply/chunks are in flight (``reply``
        phase) or the client still owes stream chunks (``queue``)."""
        st = self._by_call.get(call_id)
        if st is not None:
            self._set_phase(st, "reply" if replying else "queue", t)

    def server_span(self, frame, endpoint: int, name: str, t0: float,
                    t1: float, **attrs) -> None:
        """A server-side event (admit/shed/handler) on the server
        endpoint's track, attributed via the frame's propagated trace
        id."""
        st = self._state_for_frame(frame)
        if st is None:
            return
        s = self._span(name, "server", st.root.trace_id, t0,
                       parent=st.attempt, endpoint=endpoint,
                       attrs=attrs)
        s.end_s = t1

    def on_retry(self, ctx, old_call_id: int, t_fail: float,
                 t_resume: float) -> None:
        """The failed attempt is over; after ``backoff`` (possibly
        zero-length) a new attempt opens — ``ctx`` already carries the
        new call id and (possibly re-routed) channel."""
        st = self._by_call.pop(old_call_id, None)
        if st is None:
            return
        if st.phase is not None and st.phase.end_s is None:
            st.phase.end_s = t_fail
        st.phase = None
        if st.attempt.end_s is None:
            st.attempt.end_s = t_fail
        if t_resume > t_fail:
            b = self._span("backoff", "phase", st.root.trace_id, t_fail,
                           parent=st.root, endpoint=st.root.endpoint)
            b.end_s = t_resume
        st.attempt = self._span(
            f"attempt {ctx.attempts}", "attempt", st.root.trace_id,
            t_resume, parent=st.root, endpoint=st.root.endpoint,
            attrs={"dst": self._ep_name(ctx.channel.dst)})
        self._set_phase(st, "queue", t_resume)
        self._by_call[ctx.call_id] = st

    def on_terminal(self, ctx, kind: str,
                    error: Optional[str] = None) -> None:
        """The call reached a terminal event: close phase, attempt and
        root at ``ctx.end_s``."""
        st = self._by_call.pop(ctx.call_id, None)
        if st is None:
            return
        self._by_trace.pop(ctx.trace_id, None)
        t = ctx.end_s if ctx.end_s is not None else self.now()
        if st.phase is not None and st.phase.end_s is None:
            st.phase.end_s = t
        if st.attempt.end_s is None:
            st.attempt.end_s = t
        st.root.end_s = t
        st.root.attrs["outcome"] = kind
        st.root.attrs["attempts"] = ctx.attempts
        if error:
            st.root.attrs["error"] = error

    # live regions -----------------------------------------------------
    #: ``name -> context manager``: a profiler range that every region
    #: opens, so that a device trace shows the serving path on its own
    #: clock. The serving side installs one (this module imports no
    #: profiler); without it a region records call spans only.
    range_factory: Any = None

    @contextmanager
    def region(self, name: str, *, frame=None,
               endpoint: Optional[int] = None, span: Optional[str] = None,
               **attrs) -> Iterator[None]:
        """A live region of the path that serves calls (``rpc.flush``,
        ``sched.step``, ``serve.decode``, ...): the range of ``name``
        around the body and, given the ``frame`` of the call it works
        for, a server span ``span`` (default ``name``) in that call's
        tree on ``endpoint``'s track, on the fabric clock. Callers
        without a tracer enter no region at all."""
        f = self.range_factory
        with f(name) if f is not None else nullcontext():
            if frame is None:
                yield
                return
            t0 = self.now()
            yield
            self.server_span(frame, endpoint, span or name, t0,
                             self.now(), **attrs)

    # queries ----------------------------------------------------------
    def spans(self) -> List[Span]:
        return list(self._spans)

    def calls(self) -> List[Span]:
        """Root call spans, in start order."""
        return [s for s in self._spans if s.category == "call"]

    def trace(self, trace_id: int) -> Optional[Span]:
        for s in self._spans:
            if s.category == "call" and s.trace_id == trace_id:
                return s
        return None

    def clear(self) -> None:
        self._spans.clear()
        self._by_call.clear()
        self._by_trace.clear()
        self.dropped = 0

    def phase_breakdown(self) -> Dict[str, Dict[str, Any]]:
        """Per-method phase totals over CLOSED calls. Each entry's
        ``phases`` sum exactly to ``end_to_end_s`` (the partition
        invariant), so a breakdown row attributes every second of
        latency to queue/credit_stall/wire/server/reply/backoff."""
        out: Dict[str, Dict[str, Any]] = {}
        for root in self.calls():
            if not root.closed:
                continue
            row = out.setdefault(root.name, {
                "calls": 0, "end_to_end_s": 0.0,
                "phases": {p: 0.0 for p in PHASES}})
            row["calls"] += 1
            row["end_to_end_s"] += root.duration_s
            for ph in root.phase_spans():
                if ph.closed:
                    row["phases"][ph.name] = \
                        row["phases"].get(ph.name, 0.0) + ph.duration_s
        return out

    # export -----------------------------------------------------------
    def chrome_events(self) -> List[Dict[str, Any]]:
        """Chrome trace-event list: one pid, one tid (track) per
        endpoint, complete ("X") events in microseconds. Open spans are
        skipped."""
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": 0, "tid": 0,
            "args": {"name": "rpc-fabric"}}]
        endpoints = sorted({s.endpoint for s in self._spans
                            if s.endpoint is not None})
        for ep in endpoints:
            events.append({"ph": "M", "name": "thread_name", "pid": 0,
                           "tid": ep,
                           "args": {"name": f"endpoint "
                                            f"{self._ep_name(ep)}"}})
        for s in self._spans:
            if not s.closed:
                continue
            args = dict(s.attrs)
            args["trace_id"] = s.trace_id
            events.append({
                "ph": "X", "name": s.name, "cat": s.category,
                "ts": s.start_s * 1e6, "dur": s.duration_s * 1e6,
                "pid": 0, "tid": s.endpoint if s.endpoint is not None
                else 0,
                "args": args})
        return events

    def export_chrome(self, path) -> None:
        """Write Perfetto-loadable Chrome trace-event JSON to
        ``path`` (str or file-like)."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms"}
        if hasattr(path, "write"):
            json.dump(doc, path)
        else:
            with open(path, "w") as f:
                json.dump(doc, f)


__all__ = ["MAX_TRACE_ID", "PHASES", "Span", "Tracer"]
