"""Client/server interceptor chains for the RPC fabric (the gRPC
interceptor analogue), threaded through the completion queue.

A *client* interceptor observes every call made through a fabric:
``on_start`` when the first frame is submitted, ``on_event`` for every
completion-queue event the call produces, ``on_complete`` once when the
call reaches a terminal state (the chain's ``on_complete`` unwinds
first, then the terminal event itself reaches the cq and ``on_event`` —
uniformly for success, error, and deadline outcomes). The chain nests like gRPC's: for
``fabric.client_interceptors = [outer, inner]`` the start hooks run
outer->inner and the completion hooks unwind inner->outer; an
interceptor that answers ``"retry"`` from ``on_complete`` consumes the
failure — interceptors outer to it never see the failed attempt, only
the final outcome.

A *server* interceptor brackets handler dispatch on every endpoint the
fabric creates after it is installed: ``on_admit`` when a call opens
(outer->inner; the first hook to answer with an error string rejects
the call with a transient ``resource exhausted`` reply before the
handler ever runs), ``on_receive`` before the handler runs
(outer->inner), ``on_done`` after (inner->outer, with the fault carried
when the handler raised), and ``on_shed`` when the server drops a call
whose propagated deadline budget the wire already consumed.

The stock interceptors cover the bookkeeping the paper's §2.2 calls
out as part of the RPC interface layer itself:

  MetricsInterceptor    per-method call counts + latency percentiles
                        (and stream chunk counts), measured on the
                        fabric clock — wall time for measured
                        transports, the transport's modeled clock for
                        simulated ones. Server-side it additionally
                        tracks the per-endpoint queue depth the fabric
                        computed for each flight — the load signal
                        admission control feeds on — plus shed and
                        admission-rejection counts.
  DeadlineInterceptor   applies a default deadline to calls that set
                        none and counts ``deadline_exceeded`` events;
                        the fabric enforces deadlines (cancelling
                        stalled calls and dropping their gated chunks)
                        and propagates the remaining budget to servers
                        in the frame header.
  RetryInterceptor      resubmits calls that failed with a transient
                        error (``TransientError`` on the server, "no
                        server at endpoint", an injected link fault, or
                        an admission rejection): unary calls, and —
                        transparently — server-stream calls iff zero
                        response chunks were delivered. Retries are
                        budget-aware: the original deadline keeps
                        running and a retry that cannot fit in the
                        remaining budget is never attempted.
  AdmissionInterceptor  server-side admission control: rejects a call
                        with ``ResourceExhausted`` when its endpoint is
                        over the configured outstanding-call limit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.rpc import framing
from repro_torch.rpc.completion import Event
from repro_torch.rpc.telemetry import HistogramRegistry


class TransientError(Exception):
    """Raise from a handler to mark the failure retryable: the error
    reply is prefixed ``TRANSIENT:`` and a RetryInterceptor resubmits
    the call."""


class ResourceExhausted(TransientError):
    """The server refused the call because the endpoint is over its
    admission limit (gRPC's RESOURCE_EXHAUSTED). Transient by
    construction: retrying — ideally on another shard, which is what
    ``ShardedServeStub``'s failover does — is the correct response."""


TRANSIENT_PREFIX = "TRANSIENT:"
RESOURCE_EXHAUSTED = "resource exhausted"


@dataclass
class CallContext:
    """Per-call state shared by the fabric and the client chain."""
    call_id: int
    method: str
    kind: str                      # fabric.UNARY/.CLIENT_STREAM/...
    dst: int
    start_s: float                 # fabric clock at submit
    channel: Any = None
    deadline_s: Optional[float] = None   # absolute fabric-clock time
    end_s: Optional[float] = None
    attempts: int = 1
    chunks: int = 0                # response stream chunks delivered
    #: distributed-tracing context (0 = untraced): assigned by the
    #: fabric's Tracer at call start, stamped into the frame header at
    #: flight departure, stable across retries and failover re-routes
    trace_id: int = 0
    # retained for retries (unary + server-stream; bufs caller-owned)
    request: Optional[framing.Frame] = None
    #: sent chunk frames of a client-stream/bidi call, retained (up to
    #: the fabric's ``retry_buffer_chunks``) so a retry can replay the
    #: whole stream; None once the bound is exceeded (sticky
    #: ``meta["buffer_overflow"]`` marks that) or for unary calls
    request_chunks: Optional[List[framing.Frame]] = None
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ServerContext:
    """Per-dispatch state shared by the server chain."""
    endpoint: int
    call_id: int
    method: str
    kind: str
    start_s: float
    #: absolute fabric-clock deadline recovered from the frame's
    #: propagated budget (None when the call carried no deadline)
    deadline_s: Optional[float] = None
    #: the fabric's load signal for this dispatch: request frames that
    #: landed on this endpoint so far in the current flight (including
    #: this one) plus the server's open partial streams
    queue_depth: int = 0
    clock: Optional[Callable[[], float]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    def time_remaining(self) -> Optional[float]:
        """Remaining propagated deadline budget in seconds on the
        fabric clock (None without a deadline, 0.0 once expired) — the
        gRPC ``context.time_remaining()`` analogue handlers and server
        interceptors shed doomed work against."""
        if self.deadline_s is None:
            return None
        now = self.clock() if self.clock is not None else self.start_s
        return max(0.0, self.deadline_s - now)


class ClientInterceptor:
    def on_start(self, ctx: CallContext) -> None:
        pass

    def on_event(self, ctx: CallContext, event: Event) -> None:
        pass

    def on_complete(self, ctx: CallContext, event: Event
                    ) -> Optional[str]:
        """Terminal hook; return ``"retry"`` to consume the failure and
        resubmit (unary calls only)."""
        return None


class ServerInterceptor:
    def on_admit(self, ctx: ServerContext) -> Optional[str]:
        """Admission hook, run outer->inner when a call OPENS at the
        server (unary frames and the first chunk of a stream), before
        the handler. Return an error string to reject the call with a
        transient ``resource exhausted`` reply; None admits."""
        return None

    def on_receive(self, ctx: ServerContext) -> None:
        pass

    def on_done(self, ctx: ServerContext, ok: bool,
                error: Optional[str] = None) -> None:
        pass

    def on_shed(self, ctx: ServerContext) -> None:
        """The server dropped this call before the handler ran: its
        propagated deadline budget was already spent on the wire."""


def is_transient(error: Optional[str]) -> bool:
    """Transient = a server fault raised as TransientError (the reply
    text is prefixed ``TRANSIENT:`` by the fabric's fault path), a
    not-yet-registered endpoint, or an injected link fault. Matched at
    the start only, so a permanent error that merely *quotes* a
    transient one is not retried."""
    return bool(error) and (error.startswith(TRANSIENT_PREFIX)
                            or error.startswith("no server at endpoint"))


def is_resource_exhausted(error: Optional[str]) -> bool:
    """An admission-control rejection (or a handler-raised
    ``ResourceExhausted``): transient, but retrying the SAME endpoint
    is pointless until load drains — the signal ``ShardedServeStub``
    fails over to another PS shard on."""
    return bool(error) and error.startswith(TRANSIENT_PREFIX) \
        and RESOURCE_EXHAUSTED in error


# ---------------------------------------------------------------------------
# stock interceptors
# ---------------------------------------------------------------------------

class MetricsInterceptor(ClientInterceptor, ServerInterceptor):
    """Per-method call counts and latency percentiles, for free on every
    stub call. Client side: one record per call attempt's terminal
    event, latency on the fabric clock. Server side (install in
    ``fabric.server_interceptors``): handler invocation counts under a
    ``server:`` key prefix.

    With ``per_endpoint=True`` every client-side record is additionally
    kept under ``method@src->dst`` (and server dispatches under
    ``server:method@endpoint``), so interleaved calls from several
    client endpoints get separate counts and percentiles — the
    per-endpoint breakdown a cluster run reports. ``endpoint_name``
    labels the endpoints (a cluster transport's ``endpoint_name``
    renders names instead of indices).

    Latency distributions live in a :class:`telemetry.HistogramRegistry`
    (one bounded histogram per method key — exact percentiles for small
    runs, log-bucketed constant memory past
    ``telemetry.EXACT_CAP`` samples, instead of the unbounded per-call
    list this class used to keep). Pass ``registry=`` to share one sink
    across several interceptors; ``histogram(method)`` exposes the full
    distribution (p999 etc.) beyond the 4 percentiles ``snapshot()``
    reports."""

    def __init__(self, *, per_endpoint: bool = False,
                 endpoint_name: Optional[Callable[[int], str]] = None,
                 registry: Optional[HistogramRegistry] = None):
        self.per_endpoint = per_endpoint
        self._ep_name = endpoint_name or str
        self.registry = registry if registry is not None \
            else HistogramRegistry()
        self._recs: Dict[str, Dict[str, Any]] = {}
        # per-endpoint queue depth, refreshed by on_admit each dispatch
        # — the load signal an AdmissionInterceptor installed INNER to
        # this one feeds on
        self._depth: Dict[int, int] = {}
        # live gauge providers merged into snapshot() under their own
        # keys (e.g. a serve scheduler publishing admission counters)
        self._gauges: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def _rec(self, method: str) -> Dict[str, Any]:
        return self._recs.setdefault(method, {
            "calls": 0, "ok": 0, "errors": 0, "deadline_exceeded": 0,
            "retries": 0, "chunks": 0, "shed": 0, "rejected": 0})

    def histogram(self, method: str):
        """The method's full latency distribution (a
        :class:`telemetry.BoundedHistogram`, seconds; None before the
        first completion)."""
        return self.registry.get("latency:" + method)

    def _client_keys(self, ctx: CallContext) -> List[str]:
        keys = [ctx.method]
        if self.per_endpoint and ctx.channel is not None:
            keys.append(f"{ctx.method}@{self._ep_name(ctx.channel.src)}"
                        f"->{self._ep_name(ctx.channel.dst)}")
        return keys

    def reset(self) -> None:
        """Discard everything recorded so far (benchmarks call this
        after warmup so compile/warmup calls don't pollute the
        published percentiles)."""
        for k in self._recs:
            self.registry.remove("latency:" + k)
        self._recs.clear()
        self._depth.clear()

    # client side --------------------------------------------------------
    def on_start(self, ctx: CallContext) -> None:
        for k in self._client_keys(ctx):
            self._rec(k)["calls"] += 1

    def on_event(self, ctx: CallContext, event: Event) -> None:
        for k in self._client_keys(ctx):
            if event.kind == "stream_chunk":
                self._rec(k)["chunks"] += 1
            elif event.kind == "retry":
                self._rec(k)["retries"] += 1
                self._rec(k)["calls"] += 1     # the new attempt

    def on_complete(self, ctx: CallContext, event: Event
                    ) -> Optional[str]:
        for k in self._client_keys(ctx):
            rec = self._rec(k)
            if event.kind == "deadline_exceeded":
                rec["deadline_exceeded"] += 1
            if event.ok:
                rec["ok"] += 1
            else:
                rec["errors"] += 1
            if ctx.end_s is not None:
                self.registry.hist("latency:" + k).record(
                    ctx.end_s - ctx.start_s)
        return None

    # server side --------------------------------------------------------
    def _server_keys(self, ctx: ServerContext) -> List[str]:
        keys = ["server:" + ctx.method]
        if self.per_endpoint:
            keys.append(f"server:{ctx.method}"
                        f"@{self._ep_name(ctx.endpoint)}")
        return keys

    def on_admit(self, ctx: ServerContext) -> Optional[str]:
        self._depth[ctx.endpoint] = ctx.queue_depth
        for k in self._server_keys(ctx):
            rec = self._rec(k)
            rec["queue_peak"] = max(rec.get("queue_peak", 0),
                                    ctx.queue_depth)
        return None

    def server_queue_depth(self, endpoint: int) -> int:
        """The endpoint's load at its most recent dispatch (request
        frames landed this flight + open partial streams) — what an
        AdmissionInterceptor installed inner to this one reads."""
        return self._depth.get(endpoint, 0)

    def record_rejection(self, ctx: ServerContext) -> None:
        for k in self._server_keys(ctx):
            self._rec(k)["rejected"] += 1

    def on_shed(self, ctx: ServerContext) -> None:
        for k in self._server_keys(ctx):
            self._rec(k)["shed"] += 1

    def on_receive(self, ctx: ServerContext) -> None:
        for k in self._server_keys(ctx):
            self._rec(k)["calls"] += 1

    def on_done(self, ctx: ServerContext, ok: bool,
                error: Optional[str] = None) -> None:
        for k in self._server_keys(ctx):
            self._rec(k)["ok" if ok else "errors"] += 1

    def attach_gauges(self, key: str,
                      fn: Callable[[], Dict[str, Any]]) -> None:
        """Register a live gauge provider: ``snapshot(gauges=True)``
        calls ``fn`` and reports its dict under ``key`` alongside the
        per-method records. A serve scheduler attaches its
        admission/preemption counters here so they surface in
        ``rpc_metrics`` output."""
        self._gauges[key] = fn

    def gauges(self) -> Dict[str, Dict[str, Any]]:
        """Live gauge readings alone, keyed by provider."""
        return {key: dict(fn()) for key, fn in self._gauges.items()}

    # reporting ----------------------------------------------------------
    def snapshot(self, *, gauges: bool = False
                 ) -> Dict[str, Dict[str, Any]]:
        """JSON-ready per-method summary with latency percentiles.
        ``gauges=True`` folds in attached gauge providers (whose
        records have their own shapes, not the per-method schema)."""
        out: Dict[str, Dict[str, Any]] = {}
        if gauges:
            out.update(self.gauges())
        for method, rec in self._recs.items():
            row = dict(rec)
            h = self.registry.get("latency:" + method)
            if h is not None and h.count:
                row["latency_us"] = {
                    "mean": h.mean * 1e6,
                    "p50": h.percentile(50) * 1e6,
                    "p95": h.percentile(95) * 1e6,
                    "p99": h.percentile(99) * 1e6,
                }
            out[method] = row
        return out


class DeadlineInterceptor(ClientInterceptor):
    """Applies ``default_deadline_s`` (relative) to calls that set no
    deadline and counts deadline-exceeded completions. Enforcement —
    cancelling the call, failing its handle, dropping its window-stalled
    chunks — lives in the fabric's flush loop, which honors
    ``ctx.deadline_s`` wherever it was set from."""

    def __init__(self, default_deadline_s: Optional[float] = None):
        self.default_deadline_s = default_deadline_s
        self.exceeded = 0

    def on_start(self, ctx: CallContext) -> None:
        if ctx.deadline_s is None and self.default_deadline_s is not None:
            ctx.deadline_s = ctx.start_s + self.default_deadline_s

    def on_complete(self, ctx: CallContext, event: Event
                    ) -> Optional[str]:
        if event.kind == "deadline_exceeded":
            self.exceeded += 1
        return None


class RetryInterceptor(ClientInterceptor):
    """Retries calls that failed transiently, up to ``max_attempts``
    total attempts — the full call-kind matrix:

      unary          always (the request frame is retained)
      server_stream  iff ZERO response chunks have been delivered
                     (re-issuing then cannot duplicate anything the
                     caller observed)
      client_stream  iff the fabric's bounded client-side chunk buffer
                     (``RpcFabric(retry_buffer_chunks=...)``) still
                     holds every sent chunk — the whole stream is
                     replayed under a fresh call id
      bidi           same buffer condition, and additionally zero
                     response chunks delivered (like server_stream)

    A transient failure whose sent-chunk buffer overflowed is NOT
    retried; ``gave_up_buffer`` counts those. The retry consumes the
    failure: interceptors outer to this one see only the final outcome.

    Retries respect the call's ORIGINAL deadline — the budget keeps
    running across attempts, never resets — and back off
    ``backoff_s * backoff_multiplier**(attempt-1)`` seconds on the
    fabric clock between attempts. A retry whose backoff alone would
    outlive the remaining budget is not attempted at all
    (``gave_up_budget`` counts those)."""

    def __init__(self, max_attempts: int = 3,
                 retry_on: Callable[[Optional[str]], bool] = is_transient,
                 *, backoff_s: float = 0.0,
                 backoff_multiplier: float = 2.0):
        assert max_attempts >= 1
        assert backoff_s >= 0.0 and backoff_multiplier >= 1.0
        self.max_attempts = max_attempts
        self.retry_on = retry_on
        self.backoff_s = backoff_s
        self.backoff_multiplier = backoff_multiplier
        self.retries = 0
        self.gave_up_budget = 0
        self.gave_up_buffer = 0

    def on_complete(self, ctx: CallContext, event: Event
                    ) -> Optional[str]:
        if event.kind != "error":
            return None
        if ctx.meta.get("buffer_overflow"):
            # client-stream/bidi whose sent chunks outgrew the bounded
            # retry buffer: a replay is impossible, give up loudly
            if self.retry_on(ctx.meta.get("error")):
                self.gave_up_buffer += 1
            return None
        if ctx.request is None:
            return None
        if ctx.kind in ("server_stream", "bidi") and ctx.chunks > 0:
            return None        # mid-stream: a re-issue would duplicate
        if ctx.attempts >= self.max_attempts \
                or not self.retry_on(ctx.meta.get("error")):
            return None
        delay = self.backoff_s \
            * self.backoff_multiplier ** (ctx.attempts - 1)
        if ctx.deadline_s is not None:
            now = ctx.end_s if ctx.end_s is not None else ctx.start_s
            if now + delay >= ctx.deadline_s:
                self.gave_up_budget += 1
                return None    # doomed: cannot finish inside the budget
        if delay > 0.0:
            ctx.meta["retry_backoff_s"] = delay
        self.retries += 1
        return "retry"


class AdmissionInterceptor(ServerInterceptor):
    """Server-side admission control: reject a call when its endpoint
    is over its outstanding-call limit, with a transient
    ``resource exhausted`` error — clients retry it (later flights see
    a drained queue) or, through ``ShardedServeStub``'s failover, move
    it to another PS shard.

    The load signal is fed by a server-side :class:`MetricsInterceptor`
    installed OUTER to this one (its ``on_admit`` records the queue
    depth the fabric computed before this hook runs); without one the
    interceptor reads the context's own ``queue_depth`` directly.
    ``limit`` is the default per-endpoint cap; ``limits`` overrides it
    per endpoint index (e.g. a ClusterSpec endpoint's advertised
    ``admission_limit``). ``None`` means unlimited."""

    def __init__(self, limit: Optional[int] = None, *,
                 metrics: Optional[MetricsInterceptor] = None,
                 limits: Optional[Dict[int, int]] = None):
        assert limit is None or limit >= 1, limit
        assert all(v >= 1 for v in (limits or {}).values()), limits
        self.limit = limit
        self.metrics = metrics
        self.limits = dict(limits or {})
        self.rejected = 0

    def limit_for(self, endpoint: int) -> Optional[int]:
        return self.limits.get(endpoint, self.limit)

    def on_admit(self, ctx: ServerContext) -> Optional[str]:
        limit = self.limit_for(ctx.endpoint)
        if limit is None:
            return None
        depth = (self.metrics.server_queue_depth(ctx.endpoint)
                 if self.metrics is not None else ctx.queue_depth)
        if depth <= limit:
            return None
        self.rejected += 1
        if self.metrics is not None:
            self.metrics.record_rejection(ctx)
        return (f"{RESOURCE_EXHAUSTED}: endpoint {ctx.endpoint} over "
                f"admission limit ({depth} > {limit})")


__all__ = [
    "AdmissionInterceptor", "CallContext", "ClientInterceptor",
    "DeadlineInterceptor", "MetricsInterceptor", "ResourceExhausted",
    "RetryInterceptor", "RESOURCE_EXHAUSTED", "ServerContext",
    "ServerInterceptor", "TransientError", "TRANSIENT_PREFIX",
    "is_resource_exhausted", "is_transient",
]
