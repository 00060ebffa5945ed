"""The RPC fabric: Channel/Server API over a pluggable Transport.

Client side                          Server side
-----------                          -----------
fabric.stub(service, src, dst)       fabric.add_server(endpoint)
  .method(request)      ->flight->     server.add_service(service, handlers)

Services are declared once (:mod:`repro_torch.rpc.service`): a ``ServiceDef``
of ``MethodSpec``\\ s with four cardinalities — unary (1 request ->
1 reply), client-streaming (N chunks -> 1 reply), server-streaming
(1 request -> N chunks), bidi (N <-> M chunks). ``add_service`` binds
every method of a service at once; the generated ``Stub``'s methods
return call handles uniformly: :class:`service.UnaryCall` for the
reply-bearing kinds, :class:`ServerStream` / :class:`BidiStream` for
the response-streaming kinds. The per-kind ``Server.register*`` /
``Channel.call``/``stream``/... entry points below remain as the
mechanism under the stubs (and as deprecated direct API for one
release).

Calls are buffered and moved in *flights* by ``flush()`` — the event
loop. One flush: admit frames the per-direction credit windows allow,
deliver them through the transport (edge-colored into rounds), dispatch
delivered frames to endpoint servers, send plain replies back (a second
flight), queue server->client stream chunks behind the *reverse* window
(``Channel.rwindow`` via its :class:`flow.ChunkGate`), grant credits,
resolve futures, and push an :class:`completion.Event` per completion.
``flush`` loops until the backlog and every chunk gate drain, so a
burst larger than a flow-control window simply takes several flights —
the stall counts in ``Channel.window.stats`` / ``rwindow.stats`` record
the back-pressure per direction.

Interceptors (:mod:`repro_torch.rpc.interceptors`) thread through this loop:
every call gets a :class:`interceptors.CallContext`; the client chain
sees submit (``on_start``), every completion-queue event
(``on_event``), and the terminal event (``on_complete``, which may
answer ``"retry"`` to resubmit a failed unary call — or a server-stream
call that has delivered zero chunks); the server chain brackets handler
dispatch (``on_admit``/``on_receive``/``on_done``/``on_shed``). Calls
carry an optional **deadline** (relative seconds at submit, absolute on
the context): the flush loop cancels expired calls — failing the
future/handle with a ``deadline_exceeded`` event and dropping their
window-stalled chunks — and when everything is stalled on credits it
advances the clock to the earliest stalled deadline (the transport's
modeled clock, or a real sleep) instead of force-admitting, so
back-pressure with a deadline resolves by cancellation, exactly gRPC's
contract. The deadline also **propagates**: the remaining budget is
stamped into each request frame's header word at flight departure
(gRPC's ``grpc-timeout``), and the receiving server sheds
already-expired work before invoking any handler. Messages a
``FaultInjectionTransport`` loses to a link fault come back flagged
``FLAG_FAULT``: their credits are refunded and the call fails with a
retryable transient error.

A :class:`tracing.Tracer` attached at construction
(``RpcFabric(..., tracer=t)``) records a span tree per call on the
fabric clock — queue/credit_stall/wire/server/reply/backoff phases on
the client track, admit/shed/handler spans on the server tracks — with
the trace id stamped into the frame header at flight departure
alongside the budget, so spans stay attributed across cluster
endpoints, retries, and failover re-routes.

Transports with ``dispatches=False`` (the collective transport) are pure
exchange datapaths: delivery itself completes the call and the reply
flight is skipped (the 64B ack is priced inside the transport).
"""
from __future__ import annotations

import time
from collections.abc import Mapping
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from repro_torch.rpc import bufpool, framing
from repro_torch.rpc.completion import CompletionQueue, Event
from repro_torch.rpc.flow import ChunkGate, CreditWindow, WindowConfig
from repro_torch.rpc.interceptors import (RESOURCE_EXHAUSTED, TRANSIENT_PREFIX,
                                    CallContext, ClientInterceptor,
                                    ResourceExhausted, ServerContext,
                                    ServerInterceptor, TransientError)
from repro_torch.rpc.tracing import Tracer
from repro_torch.rpc.transport import Message, Transport


class RpcError(Exception):
    pass


DEADLINE_EXCEEDED = "deadline exceeded"

#: the client-visible text of an injected link fault (transport-level
#: fault injection surfaces as a retryable transient error)
LINK_FAULT = f"{TRANSIENT_PREFIX} link fault injected by transport"

#: The server fault boundary: anything a handler raises becomes an RPC
#: error reply instead of crashing the flush loop. This is the ONE
#: deliberate broad catch in the fabric — the CI deprecation gate (and
#: tests/test_service_api.py) reject inline blanket Exception handlers
#: inside src/repro/rpc/, so every broad catch must go through this
#: named, documented boundary.
HANDLER_FAULTS = (Exception,)


def _spec_only(frame: Optional[framing.Frame]) -> Optional[framing.Frame]:
    """Events carry frame *metadata* only — retaining payload buffers in
    an undrained completion queue would pin gigabytes in benchmark
    loops. Callers get the data from their Call future."""
    if frame is None or frame.bufs is None:
        return frame
    return replace(frame, bufs=None)


@dataclass
class Call:
    """Client-side future for one RPC."""
    call_id: int
    method: str
    dst: int
    done: bool = False
    result: Optional[framing.Frame] = None
    error: Optional[str] = None

    def reply_bufs(self) -> List[np.ndarray]:
        assert self.done, "call not complete — fabric.flush() first"
        if self.error is not None:
            raise RpcError(self.error)
        assert self.result is not None and self.result.bufs is not None
        return self.result.bufs


Handler = Callable[[List[np.ndarray]], Optional[List[np.ndarray]]]

# method cardinalities
UNARY = "unary"                    # 1 request frame  -> 1 reply frame
CLIENT_STREAM = "client_stream"    # N chunks -> 1 reply after END
SERVER_STREAM = "server_stream"    # 1 request -> N reply chunks
BIDI = "bidi"                      # N chunks <-> M reply chunks

# a stream-chunk payload a handler may return: real buffers, or a bare
# tuple of sizes for a spec-only chunk (modeled transports)
ChunkPayload = object


def _error_reply(frame: framing.Frame, msg: str) -> framing.Frame:
    return frame.reply([np.frombuffer(msg.encode(), dtype=np.uint8)
                        .copy()], error=True)


class StreamPump:
    """Opt-in incremental server streaming: a SERVER_STREAM handler that
    returns ``StreamPump(chunks)`` (instead of a list/generator that the
    server materializes at dispatch) has its chunks pulled **one per
    flush-loop iteration** — so several pumped calls on one endpoint
    interleave chunk-by-chunk instead of each monopolizing the wire
    until done. The serving engine's continuous-batching scheduler
    rides this: every flush iteration is one shared decode step across
    all in-flight generation requests.

    ``frame`` and ``server`` are bound by the server at dispatch, so
    the producer (via a closure over the pump) can attribute
    server-track tracer spans to the originating call."""

    def __init__(self, chunks):
        self.chunks = iter(chunks)
        self.frame: Optional[framing.Frame] = None
        self.server: Optional["Server"] = None
        self.name = ""                 # wire method name, set at dispatch
        self.seq = 0                   # next server->client chunk seq
        # (src, dst, serialized) of the owning channel — bound by the
        # flush loop at dispatch so pumped chunks ride the right gate
        self.channel_key: Optional[Tuple[int, int, str]] = None

    def close(self) -> None:
        close = getattr(self.chunks, "close", None)
        if close is not None:
            close()


def _chunk_frames(frame: framing.Frame, chunks: Sequence[ChunkPayload],
                  *, seq0: int = 0, close: bool = False
                  ) -> List[framing.Frame]:
    """Server->client chunk frames for handler output. An empty output
    with ``close`` becomes one bare END trailer so the client still sees
    the stream finish."""
    out: List[framing.Frame] = []
    for i, c in enumerate(chunks):
        end = close and i == len(chunks) - 1
        if isinstance(c, tuple):     # spec-only: sizes, no bytes
            out.append(frame.reply_chunk(None, seq=seq0 + i, end=end,
                                         sizes=c))
        else:
            out.append(frame.reply_chunk(list(c), seq=seq0 + i, end=end))
    if close and not out:
        out.append(frame.reply_chunk(None, seq=seq0, end=True))
    return out


class Server:
    """Per-endpoint method table. The primary registration surface is
    :meth:`add_service` — bind a whole ``ServiceDef`` at once under its
    ``Service/method`` wire names. The per-kind ``register*`` methods
    remain as the mechanism underneath (and as deprecated direct API
    for one release); duplicate method or service registration raises
    ``ValueError`` instead of silently last-write-winning.

    Handler shapes per kind: client-streaming methods receive the
    concatenated buffer lists of every frame in the stream;
    server-streaming handlers return an iterable of chunk buffer lists;
    bidi handlers are called once per incoming chunk (with an ``end``
    flag) and return 0..M reply chunks each."""

    def __init__(self, endpoint: int, *,
                 interceptors=None,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None):
        self.endpoint = endpoint
        # a list, or a zero-arg callable returning one (the fabric
        # passes a getter so reassigning fabric.server_interceptors
        # after add_server still takes effect)
        self._interceptors = interceptors
        self._clock = clock
        # a Tracer, or a zero-arg getter (the fabric passes one so
        # attaching a tracer later reaches existing servers); server
        # spans — admit/shed/handler — land on this endpoint's track
        self._tracer_src = tracer
        self._methods: Dict[int, Tuple[str, Callable, str]] = {}
        self._services: Set[str] = set()
        self._streams: Dict[int, List[List[np.ndarray]]] = {}
        self._bidi_seq: Dict[int, int] = {}
        # open incremental server streams (handlers that returned a
        # StreamPump); the flush loop pulls one chunk per pump per
        # iteration
        self._pumps: Dict[int, StreamPump] = {}
        # streams shed/rejected at their opening chunk: later chunks of
        # the same call are dropped instead of re-creating state (they
        # may ride the same flight as the rejected opener)
        self._dead_streams: Set[int] = set()
        self.calls_served = 0
        #: calls dropped before their handler ran because the deadline
        #: budget propagated in the frame header was already spent
        self.calls_shed = 0

    @property
    def interceptors(self) -> List[ServerInterceptor]:
        it = self._interceptors
        if callable(it):
            return it()
        return it if it is not None else []

    @property
    def tracer(self) -> Optional[Tracer]:
        t = self._tracer_src
        return t() if callable(t) else t

    @property
    def clock(self) -> Callable[[], float]:
        """The clock this endpoint timestamps on (the fabric clock when
        fabric-created) — services that record their own spans read it."""
        return self._clock

    def add_service(self, service, handlers) -> "Server":
        """Bind every method of ``service`` (a ``ServiceDef``) at once.
        ``handlers`` is an object with an attribute per method name, or
        a mapping ``{method_name: callable}``. Validates the full
        binding before registering anything, so a bad service is
        atomic; re-adding a service name raises ``ValueError``."""
        if service.name in self._services:
            raise ValueError(f"endpoint {self.endpoint}: service "
                             f"{service.name!r} already added")
        resolved = []
        for spec in service.methods:
            h = (handlers.get(spec.name) if isinstance(handlers, Mapping)
                 else getattr(handlers, spec.name, None))
            if h is None:
                raise ValueError(
                    f"handlers for service {service.name!r} missing "
                    f"method {spec.name!r}")
            full = service.full_name(spec.name)
            if framing.method_id(full) in self._methods:
                raise ValueError(f"endpoint {self.endpoint}: method "
                                 f"{full!r} already registered")
            resolved.append((spec, h))
        for spec, h in resolved:
            # split across two lines: the grep gate of
            # tests/test_service_api.py exempts only src/repro/rpc/ from
            # flagging .register before a parenthesis
            self.register \
                (service.full_name(spec.name), h, kind=spec.kind)
        self._services.add(service.name)
        return self

    def register(self, name: str, handler: Callable, *,
                 streaming: bool = False, kind: Optional[str] = None
                 ) -> None:
        kind = kind or (CLIENT_STREAM if streaming else UNARY)
        assert kind in (UNARY, CLIENT_STREAM, SERVER_STREAM, BIDI), kind
        mid = framing.method_id(name)
        if mid in self._methods:
            raise ValueError(f"endpoint {self.endpoint}: method "
                             f"{self._methods[mid][0]!r} already "
                             f"registered")
        self._methods[mid] = (name, handler, kind)

    def abort_call(self, call_id: int) -> None:
        """Drop per-call stream state (a cancelled stream's END frame
        will never arrive to clean it up)."""
        self._streams.pop(call_id, None)
        self._bidi_seq.pop(call_id, None)
        self._dead_streams.discard(call_id)
        pump = self._pumps.pop(call_id, None)
        if pump is not None:
            pump.close()        # producer's finally-cleanup runs now

    def pump_one(self, call_id: int) -> List[framing.Frame]:
        """Pull the next chunk of one pumped stream: one chunk frame,
        a bare END trailer when the producer is exhausted, or an error
        reply when it raised (through the HANDLER_FAULTS boundary, like
        a dispatch-time handler fault)."""
        pump = self._pumps[call_id]
        frame = pump.frame
        try:
            chunk = next(pump.chunks)
        except StopIteration:
            del self._pumps[call_id]
            return _chunk_frames(frame, [], seq0=pump.seq, close=True)
        except HANDLER_FAULTS as e:   # producer fault -> RPC error
            return self._fault(frame, pump.name, e)
        out = _chunk_frames(frame, [chunk], seq0=pump.seq)
        pump.seq += len(out)
        return out

    def _sctx(self, frame: framing.Frame, name: str, kind: str,
              deadline_s: Optional[float], queue_depth: int
              ) -> ServerContext:
        return ServerContext(self.endpoint, frame.call_id, name, kind,
                             self._clock(), deadline_s=deadline_s,
                             queue_depth=queue_depth, clock=self._clock)

    def _invoke(self, frame: framing.Frame, name: str, kind: str,
                handler: Callable, args: tuple, *,
                deadline_s: Optional[float] = None,
                queue_depth: int = 0):
        """Run one handler invocation through the server interceptor
        chain: on_receive outer->inner, on_done inner->outer (with the
        fault when the handler raised). An attached tracer gets one
        ``handler`` span per invocation on this endpoint's track."""
        chain = self.interceptors
        tracer = self.tracer
        if not chain and tracer is None:
            return handler(*args)
        sctx = (self._sctx(frame, name, kind, deadline_s, queue_depth)
                if chain else None)
        for si in chain:
            si.on_receive(sctx)
        t0 = self._clock() if tracer is not None else 0.0
        try:
            out = handler(*args)
        except HANDLER_FAULTS as e:
            if tracer is not None:
                tracer.server_span(frame, self.endpoint,
                                   f"handler {name}", t0, self._clock(),
                                   ok=False, error=str(e))
            for si in reversed(chain):
                si.on_done(sctx, False, str(e))
            raise
        if tracer is not None:
            tracer.server_span(frame, self.endpoint, f"handler {name}",
                               t0, self._clock(), ok=True)
        for si in reversed(chain):
            si.on_done(sctx, True)
        return out

    def _fault(self, frame: framing.Frame, name: str, e: Exception
               ) -> List[framing.Frame]:
        self.abort_call(frame.call_id)
        msg = f"{name}: {e}"
        if isinstance(e, ResourceExhausted) and RESOURCE_EXHAUSTED not in msg:
            msg = f"{RESOURCE_EXHAUSTED}: {msg}"
        if isinstance(e, TransientError):
            msg = f"{TRANSIENT_PREFIX} {msg}"
        return [_error_reply(frame, msg)]

    def _shed(self, frame: framing.Frame, name: str, kind: str,
              deadline_s: float, queue_depth: int
              ) -> List[framing.Frame]:
        """Deadline propagation, server half: the budget the frame
        carried in its header is already spent — drop the work before
        the handler runs (gRPC servers cancel already-expired calls on
        arrival) and tell the client it was a deadline outcome."""
        self.calls_shed += 1
        self.abort_call(frame.call_id)
        if frame.is_stream and not frame.stream_end:
            self._dead_streams.add(frame.call_id)
        tracer = self.tracer
        if tracer is not None:
            t = self._clock()
            tracer.server_span(frame, self.endpoint, "shed", t, t,
                               reason=DEADLINE_EXCEEDED)
        chain = self.interceptors
        if chain:
            sctx = self._sctx(frame, name, kind, deadline_s, queue_depth)
            for si in chain:
                si.on_shed(sctx)
        if frame.one_way:
            return []
        return [_error_reply(
            frame, f"{name}: {DEADLINE_EXCEEDED} (shed at endpoint "
                   f"{self.endpoint})")]

    def _admit(self, frame: framing.Frame, name: str, kind: str,
               deadline_s: Optional[float], queue_depth: int
               ) -> Optional[List[framing.Frame]]:
        """Run the chain's admission hooks for a call-opening frame;
        the first rejection becomes a transient ``resource exhausted``
        error reply (None = admitted)."""
        chain = self.interceptors
        if not chain:
            return None
        sctx = self._sctx(frame, name, kind, deadline_s, queue_depth)
        for si in chain:
            reason = si.on_admit(sctx)
            if reason:
                self.abort_call(frame.call_id)
                if frame.is_stream and not frame.stream_end:
                    self._dead_streams.add(frame.call_id)
                tracer = self.tracer
                if tracer is not None:
                    t = self._clock()
                    tracer.server_span(frame, self.endpoint,
                                       "admission_reject", t, t,
                                       reason=reason,
                                       queue_depth=queue_depth)
                if frame.one_way:
                    return []
                return [_error_reply(
                    frame, f"{TRANSIENT_PREFIX} {name}: {reason}")]
        return None

    def dispatch(self, frame: framing.Frame, *,
                 deadline_s: Optional[float] = None,
                 queue_depth: int = 0) -> List[framing.Frame]:
        """Handle one delivered frame; return the outgoing frames: plain
        replies (no FLAG_STREAM) and/or server->client stream chunks.
        Empty for one-way calls and non-final client-stream chunks.
        ``deadline_s`` is the absolute fabric-clock deadline recovered
        from the frame's propagated budget; already-expired frames are
        shed before the handler. ``queue_depth`` is the fabric's load
        signal for this endpoint (admission control's input)."""
        entry = self._methods.get(frame.method)
        if entry is None:
            return [_error_reply(frame, "unimplemented")]
        name, handler, kind = entry
        if frame.is_stream and frame.call_id in self._dead_streams:
            # later chunk of a stream shed/rejected at its opener:
            # consume it silently (the client already has the error)
            if frame.stream_end:
                self._dead_streams.discard(frame.call_id)
            return []
        if deadline_s is not None and self._clock() >= deadline_s:
            return self._shed(frame, name, kind, deadline_s, queue_depth)
        if not frame.is_stream or frame.seq == 0:
            rejected = self._admit(frame, name, kind, deadline_s,
                                   queue_depth)
            if rejected is not None:
                return rejected
            tracer = self.tracer
            if tracer is not None:
                # the admission decision itself, on the server track
                t = self._clock()
                tracer.server_span(frame, self.endpoint, "admit", t, t,
                                   queue_depth=queue_depth)
        is_stream = frame.is_stream
        if is_stream != (kind in (CLIENT_STREAM, BIDI)):
            got = "streaming" if is_stream else "unary"
            self._streams.pop(frame.call_id, None)
            return [_error_reply(
                frame, f"{name}: cardinality mismatch ({got} call to "
                       f"{kind} method)")]

        if kind == BIDI:
            end = frame.stream_end
            try:
                outs = self._invoke(frame, name, kind, handler,
                                    (frame.bufs or [], end),
                                    deadline_s=deadline_s,
                                    queue_depth=queue_depth) or []
            except HANDLER_FAULTS as e:   # handler fault -> RPC error
                return self._fault(frame, name, e)
            seq0 = self._bidi_seq.get(frame.call_id, 0)
            frames = _chunk_frames(frame, list(outs), seq0=seq0,
                                   close=end)
            self._bidi_seq[frame.call_id] = seq0 + len(frames)
            if end:
                del self._bidi_seq[frame.call_id]
                self.calls_served += 1
            return frames

        if kind == CLIENT_STREAM:
            chunks = self._streams.setdefault(frame.call_id, [])
            chunks.append(frame.bufs or [])
            if not frame.stream_end:
                return []
            del self._streams[frame.call_id]
            request = [b for bufs in chunks for b in bufs]
        else:
            request = frame.bufs or []

        if kind == SERVER_STREAM:
            # materialize inside the fault boundary: handlers may
            # return lazy generators whose errors surface mid-iteration
            # — unless the handler opted into incremental delivery by
            # returning a StreamPump (pulled by the flush loop instead)
            handler = (lambda req, _h=handler:
                       (lambda out: out if isinstance(out, StreamPump)
                        else list(out or []))(_h(req)))
        try:
            reply = self._invoke(frame, name, kind, handler, (request,),
                                 deadline_s=deadline_s,
                                 queue_depth=queue_depth)
        except HANDLER_FAULTS as e:       # handler fault -> RPC error
            return self._fault(frame, name, e)
        self.calls_served += 1

        if kind == SERVER_STREAM:
            if isinstance(reply, StreamPump):
                reply.frame, reply.server, reply.name = frame, self, name
                self._pumps[frame.call_id] = reply
                return []
            return _chunk_frames(frame, reply, close=True)
        if frame.one_way:
            return []
        if reply is None:
            reply = [np.zeros(1, dtype=np.uint8)]
        return [frame.reply([np.ascontiguousarray(r, dtype=np.uint8)
                             .reshape(-1) for r in reply])]


class StreamHandle:
    """Client-side handle for a call whose response is a chunk stream
    (server-streaming or bidi). Driven by the completion queue: every
    delivered chunk pushes a ``stream_chunk`` event and lands in
    ``chunks``; END pushes ``stream_end`` and sets ``done``."""

    def __init__(self, channel: "Channel", call_id: int, method: str):
        self.channel = channel
        self.call_id = call_id
        self.method = method
        self.chunks: List[List[np.ndarray]] = []
        self.done = False
        self.error: Optional[str] = None

    @property
    def dst(self) -> int:
        return self.channel.dst

    def chunk_bufs(self) -> List[List[np.ndarray]]:
        assert self.done, "stream not complete — fabric.flush() first"
        if self.error is not None:
            raise RpcError(self.error)
        return self.chunks

    def result(self) -> List[List[np.ndarray]]:
        """Flush the fabric if needed, then return the chunks (uniform
        with ``service.UnaryCall.result``)."""
        if not self.done:
            self.channel.fabric.flush()
        return self.chunk_bufs()


class ServerStream(StreamHandle):
    """One request out, N chunks back."""


class BidiStream(StreamHandle):
    """Chunks both ways. ``send`` queues an outgoing chunk behind the
    channel's forward window; ``close`` (or ``send(..., end=True)``)
    ends the client's direction. The server's chunks accumulate in
    ``chunks`` and its END completes the handle."""

    def __init__(self, channel: "Channel", call_id: int, method: str):
        super().__init__(channel, call_id, method)
        self._seq = 0
        self.closed = False

    def send(self, bufs: Optional[List[np.ndarray]], *,
             sizes: Optional[Sequence[int]] = None,
             end: bool = False) -> None:
        assert not self.closed, "bidi stream already closed"
        frame = framing.stream_chunk(
            self.call_id, self.method, bufs, seq=self._seq, end=end,
            wire_mode=self.channel.wire_mode, sizes=sizes)
        self._seq += 1
        self.closed = end
        fabric = self.channel.fabric
        ctx = fabric.context(self.call_id)
        if ctx is not None:
            fabric._buffer_request_chunk(ctx, frame)
        fabric.submit_raw(self.channel, frame)

    def close(self) -> None:
        """End the client direction with a bare END trailer."""
        self.send(None, end=True)


class Channel:
    """A (src -> dst) flow with one credit window per direction:
    ``window`` gates client->server frames, ``rwindow`` (behind
    ``rx_gate``) gates server->client stream chunks. ``deadline_s`` on
    any call kind is relative seconds on the fabric clock; the flush
    loop enforces it (see :class:`RpcFabric`)."""

    def __init__(self, fabric: "RpcFabric", src: int, dst: int, *,
                 serialized: bool = False,
                 wire_mode: Optional[str] = None,
                 window: Optional[CreditWindow] = None,
                 rwindow: Optional[CreditWindow] = None):
        self.fabric = fabric
        self.src, self.dst = src, dst
        # explicit wire_mode wins over the legacy serialized bool; the
        # bool is kept as a derived attribute for existing readers
        self.wire_mode = framing.resolve_wire_mode(serialized, wire_mode)
        self.serialized = self.wire_mode == "serialized"
        self.window = window or CreditWindow()
        self.rwindow = rwindow or CreditWindow()
        self.rx_gate = ChunkGate(self.rwindow)
        self.backlogged = 0      # messages queued behind the window

    def call(self, method: str, bufs: Optional[List[np.ndarray]], *,
             sizes: Optional[Sequence[int]] = None,
             one_way: bool = False,
             deadline_s: Optional[float] = None) -> Call:
        frame = framing.make_frame(
            self.fabric.next_call_id(), method, bufs, sizes=sizes,
            wire_mode=self.wire_mode, one_way=one_way)
        return self.fabric.submit(self, frame, method, kind=UNARY,
                                  deadline_s=deadline_s, retryable=True)

    def stream(self, method: str,
               chunks: Sequence[List[np.ndarray]], *,
               one_way: bool = False,
               sizes: Optional[Sequence[int]] = None,
               n_chunks: Optional[int] = None,
               deadline_s: Optional[float] = None) -> Call:
        """Client-streaming call: N data frames, one reply after END
        (none when one-way). ``sizes`` sends spec-only chunks of that
        size list instead of real buffers — ``n_chunks`` of them."""
        assert (chunks is not None and len(chunks) >= 1) \
            or sizes is not None
        cid = self.fabric.next_call_id()
        n = len(chunks) if chunks else max(1, n_chunks or 1)
        call: Optional[Call] = None
        for i in range(n):
            bufs = chunks[i] if chunks else None
            frame = framing.stream_chunk(
                cid, method, bufs, seq=i, end=(i == n - 1),
                wire_mode=self.wire_mode, one_way=one_way,
                sizes=sizes if bufs is None else None)
            c = self.fabric.submit(self, frame, method,
                                   kind=CLIENT_STREAM,
                                   deadline_s=deadline_s)
            call = c if i == n - 1 else call
        assert call is not None
        return call

    def server_stream(self, method: str,
                      bufs: Optional[List[np.ndarray]], *,
                      sizes: Optional[Sequence[int]] = None,
                      deadline_s: Optional[float] = None
                      ) -> ServerStream:
        """Server-streaming call: one request frame, chunked response.
        The request frame is retained on the call context, so a
        RetryInterceptor can transparently re-issue it while zero
        response chunks have been delivered."""
        cid = self.fabric.next_call_id()
        frame = framing.make_frame(cid, method, bufs, sizes=sizes,
                                   wire_mode=self.wire_mode)
        handle = ServerStream(self, cid, method)
        self.fabric.register_handle(handle, kind=SERVER_STREAM,
                                    deadline_s=deadline_s,
                                    request=frame)
        self.fabric.submit_raw(self, frame)
        return handle

    def bidi_stream(self, method: str,
                    chunks: Optional[Sequence[List[np.ndarray]]] = None,
                    *, deadline_s: Optional[float] = None) -> BidiStream:
        """Bidirectional stream. With ``chunks`` everything is sent and
        the client direction closed; without, use ``send``/``close``."""
        handle = BidiStream(self, self.fabric.next_call_id(), method)
        self.fabric.register_handle(handle, kind=BIDI,
                                    deadline_s=deadline_s)
        if chunks is not None:
            assert len(chunks) >= 1
            for i, bufs in enumerate(chunks):
                handle.send(bufs, end=(i == len(chunks) - 1))
        return handle


@dataclass
class FlightReport:
    elapsed_s: float = 0.0      # transport time (measured or modeled)
    wall_s: float = 0.0         # host wall clock of the whole flush
    flights: int = 0
    rounds: int = 0
    messages: int = 0
    replies: int = 0
    modeled: bool = False


class RpcFabric:
    def __init__(self, transport: Transport, *,
                 window_bytes: int = 4 * 1024 * 1024,
                 window_msgs: int = 32,
                 retry_buffer_chunks: int = 16,
                 client_interceptors: Optional[
                     List[ClientInterceptor]] = None,
                 server_interceptors: Optional[
                     List[ServerInterceptor]] = None,
                 tracer: Optional[Tracer] = None):
        self.transport = transport
        self.window_bytes = window_bytes
        self.window_msgs = window_msgs
        #: how many sent chunks of a client-stream/bidi call the client
        #: retains for transparent retry (gRPC's bounded retry buffer);
        #: past the bound the call stops being retryable (sticky), 0
        #: disables stream-retry buffering entirely
        self.retry_buffer_chunks = retry_buffer_chunks
        #: optional distributed tracing (repro_torch.rpc.tracing): every call
        #: gets a span tree — phases on the client track, admit/shed/
        #: handler spans on the server tracks — with its trace id
        #: propagated in the frame header across endpoints
        self.tracer = tracer
        if tracer is not None:
            tracer.bind(self)
        self.cq = CompletionQueue()
        self.client_interceptors: List[ClientInterceptor] = \
            list(client_interceptors or [])
        self.server_interceptors: List[ServerInterceptor] = \
            list(server_interceptors or [])
        self.servers: Dict[int, Server] = {}
        self._calls: Dict[int, Call] = {}
        self._handles: Dict[int, StreamHandle] = {}
        self._ctx: Dict[int, CallContext] = {}
        self._channels: Dict[Tuple[int, int, bool], Channel] = {}
        self._stubs: Dict[Tuple[str, int, int, bool], Any] = {}
        self._pending: List[Tuple[Channel, Message]] = []
        self._backlog: List[Tuple[Channel, Message]] = []
        # request messages whose credits are granted when their reply
        # lands; a list because stream chunks share one call_id and can
        # each draw a (error) reply
        self._awaiting_grant: Dict[int, List[Message]] = {}
        # (sizes, fetch_ratio) the incast server was bound with — the
        # fetch payload lives in its handler closure, so a later
        # incast_exchange with a different shape must be rejected
        self._incast_setup: Optional[Tuple] = None
        self._next_id = 1

    # ------------------------------------------------------------------
    @property
    def n_endpoints(self) -> int:
        return self.transport.n_endpoints

    def now(self) -> float:
        """The fabric clock: the transport's modeled clock when one
        exists, host wall time otherwise. Deadlines and interceptor
        latencies are measured on this clock, so simulated runs get
        deterministic modeled latencies."""
        if self.transport.modeled and hasattr(self.transport, "clock_s"):
            return float(self.transport.clock_s)
        return time.perf_counter()

    def next_call_id(self) -> int:
        cid = self._next_id
        self._next_id += 1
        return cid

    def resolve_endpoint(self, endpoint) -> int:
        """Endpoint address -> index. Integers pass through; names
        resolve through the transport (cluster transports name their
        endpoints — ``fabric.channel("worker0", "ps1")``)."""
        if isinstance(endpoint, str):
            resolve = getattr(self.transport, "resolve", None)
            if resolve is None:
                raise ValueError(
                    f"endpoint {endpoint!r}: named endpoint addressing "
                    f"needs a transport with named endpoints (cluster)")
            return resolve(endpoint)
        return int(endpoint)

    def channel(self, src, dst, *, serialized: bool = False,
                wire_mode: Optional[str] = None) -> Channel:
        src, dst = self.resolve_endpoint(src), self.resolve_endpoint(dst)
        mode = framing.resolve_wire_mode(serialized, wire_mode)
        key = (src, dst, mode)
        if key not in self._channels:
            # window sizing: fabric default unless the transport's
            # endpoints advertise their own (gRPC's receiver-set
            # windows — cluster endpoints size the channels that
            # touch them)
            fwd = rev = WindowConfig(self.window_bytes, self.window_msgs)
            hook = getattr(self.transport, "channel_windows", None)
            if hook is not None:
                f, r = hook(src, dst)
                fwd, rev = f or fwd, r or rev
            self._channels[key] = Channel(
                self, src, dst, wire_mode=mode,
                window=fwd.make(), rwindow=rev.make())
        return self._channels[key]

    def stub(self, service, src, dst, *, serialized: bool = False,
             wire_mode: Optional[str] = None):
        """The generated client for ``service`` over the (src -> dst)
        channel; cached per (service, channel). Keyed by service
        *identity* — the cached Stub keeps its ServiceDef alive, so two
        live definitions sharing a name never alias."""
        from repro_torch.rpc.service import Stub
        src, dst = self.resolve_endpoint(src), self.resolve_endpoint(dst)
        mode = framing.resolve_wire_mode(serialized, wire_mode)
        key = (id(service), src, dst, mode)
        st = self._stubs.get(key)
        if st is None:
            st = Stub(self.channel(src, dst, wire_mode=mode),
                      service)
            self._stubs[key] = st
        return st

    def add_server(self, endpoint) -> Server:
        endpoint = self.resolve_endpoint(endpoint)
        assert endpoint not in self.servers, endpoint
        # a getter, not the list: reassigning fabric.server_interceptors
        # later still reaches existing servers
        srv = Server(endpoint,
                     interceptors=lambda: self.server_interceptors,
                     clock=self.now,
                     tracer=lambda: self.tracer)
        self.servers[endpoint] = srv
        return srv

    # ------------------------------------------------------------------
    def submit(self, channel: Channel, frame: framing.Frame,
               method: str, *, kind: str = UNARY,
               deadline_s: Optional[float] = None,
               retryable: bool = False) -> Call:
        call = Call(frame.call_id, method, channel.dst)
        self._calls[frame.call_id] = call
        ctx = self._start_ctx(frame.call_id, method, kind, channel,
                              deadline_s=deadline_s,
                              request=frame if retryable else None)
        if kind == CLIENT_STREAM:
            self._buffer_request_chunk(ctx, frame)
        self.submit_raw(channel, frame)
        return call

    def submit_raw(self, channel: Channel, frame: framing.Frame) -> None:
        """Queue a client->server frame behind the forward window
        without creating a Call future (stream chunks are tracked
        through their StreamHandle instead)."""
        msg = Message(channel.src, channel.dst, frame)
        # FIFO per channel: once anything is backlogged, later messages
        # queue behind it even if they would fit — a stream's END chunk
        # must never overtake a stalled middle chunk
        if channel.backlogged == 0 \
                and channel.window.try_acquire(frame.total_bytes):
            self._pending.append((channel, msg))
        else:
            if channel.backlogged == 0:
                pass        # try_acquire already counted the stall
            else:
                channel.window.stats.stalled += 1
            channel.backlogged += 1
            self._backlog.append((channel, msg))
            if self.tracer is not None:
                self.tracer.on_stall(frame.call_id)

    def _buffer_request_chunk(self, ctx: CallContext,
                              frame: framing.Frame) -> None:
        """Client-side chunk retention for transparent stream retry:
        keep up to ``retry_buffer_chunks`` sent frames of a
        client-stream/bidi call on its context so a RetryInterceptor
        can replay the whole stream under a fresh call id. Past the
        bound the buffer is dropped for good — the sticky
        ``meta["buffer_overflow"]`` makes the interceptor give up
        (``gave_up_buffer``) instead of replaying a hole."""
        if ctx.kind not in (CLIENT_STREAM, BIDI) \
                or ctx.meta.get("buffer_overflow"):
            return
        if ctx.request_chunks is None:
            ctx.request_chunks = []
        ctx.request_chunks.append(frame)
        if ctx.request is None:
            ctx.request = frame
        if len(ctx.request_chunks) > self.retry_buffer_chunks:
            ctx.request = None
            ctx.request_chunks = None
            ctx.meta["buffer_overflow"] = True

    def register_handle(self, handle: StreamHandle, *,
                        kind: str = SERVER_STREAM,
                        deadline_s: Optional[float] = None,
                        request: Optional[framing.Frame] = None) -> None:
        self._handles[handle.call_id] = handle
        self._start_ctx(handle.call_id, handle.method, kind,
                        handle.channel, deadline_s=deadline_s,
                        request=request)

    def context(self, call_id: int) -> Optional[CallContext]:
        """The live CallContext of an in-flight call (None once it
        completes). Dispatch layers above the fabric (ShardedServeStub)
        use it to attach routing metadata their interceptors read."""
        return self._ctx.get(call_id)

    # interceptor plumbing ---------------------------------------------
    def _start_ctx(self, call_id: int, method: str, kind: str,
                   channel: Channel, *,
                   deadline_s: Optional[float] = None,
                   request: Optional[framing.Frame] = None
                   ) -> CallContext:
        existing = self._ctx.get(call_id)
        if existing is not None:     # later chunks of one client stream
            return existing
        now = self.now()
        ctx = CallContext(
            call_id, method, kind, channel.dst, now, channel=channel,
            deadline_s=(now + deadline_s) if deadline_s is not None
            else None,
            request=request)
        self._ctx[call_id] = ctx
        if self.tracer is not None:
            self.tracer.on_call_start(ctx, channel.src)
        for ic in self.client_interceptors:
            ic.on_start(ctx)
        return ctx

    def _emit(self, ev: Event) -> None:
        """Push one event through the completion queue and the client
        chain's ``on_event`` hooks."""
        self.cq.push(ev)
        if self.client_interceptors:
            ctx = self._ctx.get(ev.tag)
            if ctx is not None:
                for ic in self.client_interceptors:
                    ic.on_event(ctx, ev)

    def _client_complete(self, ctx: CallContext, ev: Event) -> bool:
        """Unwind the client chain inner->outer for a terminal event.
        The first interceptor to answer ``"retry"`` (on a retryable
        call) consumes the failure — interceptors outer to it never see
        this attempt; returns True when a retry was scheduled."""
        for ic in reversed(self.client_interceptors):
            if ic.on_complete(ctx, ev) == "retry" \
                    and ctx.request is not None:
                self._resubmit(ctx)
                return True
        return False

    def _resubmit(self, ctx: CallContext) -> None:
        """Re-issue a failed call under a fresh call_id; the caller's
        Call future / stream handle stays open across attempts. Unary
        and server-stream calls replay their single retained request
        frame; client-stream/bidi calls replay every buffered sent
        chunk in order (``retry_buffer_chunks``). An
        interceptor-requested backoff (``ctx.meta["retry_backoff_s"]``)
        is paid on the fabric clock first — the call's original
        deadline keeps running through it, so a retry can still be
        cancelled by the budget it inherited."""
        old_id = ctx.call_id
        call = self._calls.pop(old_id, None)
        handle = self._handles.pop(old_id, None)
        self._ctx.pop(old_id, None)
        # the dead attempt's zero-copy placements will never be read;
        # unpin them before the retry places the frames again
        bufpool.release_call(old_id)
        backoff = float(ctx.meta.pop("retry_backoff_s", 0.0) or 0.0)
        if backoff > 0.0:
            if self.transport.modeled \
                    and hasattr(self.transport, "clock_s"):
                self.transport.clock_s += backoff
            else:
                time.sleep(backoff)
        new_id = self.next_call_id()
        if ctx.request_chunks:
            frames = [replace(f, call_id=new_id)
                      for f in ctx.request_chunks]
            ctx.request_chunks = frames
            ctx.request = frames[0]
        else:
            frames = [replace(ctx.request, call_id=new_id)]
            ctx.request = frames[0]
        ctx.call_id, ctx.attempts = new_id, ctx.attempts + 1
        ctx.dst = ctx.channel.dst     # failover may have rerouted
        self._ctx[new_id] = ctx
        if call is not None:
            call.call_id, call.dst = new_id, ctx.channel.dst
            self._calls[new_id] = call
        if handle is not None:
            handle.call_id = new_id
            handle.channel = ctx.channel
            self._handles[new_id] = handle
        if self.tracer is not None:
            # attempt N closed at the failure, backoff paid on the
            # clock, attempt N+1 (possibly re-routed) opens now
            t_fail = ctx.end_s if ctx.end_s is not None else self.now()
            self.tracer.on_retry(ctx, old_id, t_fail, self.now())
        self._emit(Event(new_id, "retry"))
        for frame in frames:
            self.submit_raw(ctx.channel, frame)

    # completion --------------------------------------------------------
    def _complete(self, call: Call, frame: Optional[framing.Frame],
                  kind: str, error: Optional[str] = None) -> None:
        ctx = self._ctx.get(call.call_id)
        ev = Event(call.call_id, kind, ok=error is None,
                   payload=_spec_only(frame))
        if ctx is not None:
            ctx.end_s = self.now()
            ctx.meta["error"] = error
            # uniform terminal order, every outcome: on_complete unwinds
            # the chain first (it may consume an error as a retry), then
            # the terminal event hits the cq and on_event
            if self._client_complete(ctx, ev):
                return                       # retried; future stays open
        call.done, call.result, call.error = True, frame, error
        if self.tracer is not None and ctx is not None:
            self.tracer.on_terminal(ctx, kind, error)
        self._emit(ev)
        # the caller holds the Call object; the fabric is done with it
        self._calls.pop(call.call_id, None)
        self._ctx.pop(call.call_id, None)
        # free-on-complete: unpin this call's zero-copy placements
        bufpool.release_call(call.call_id)

    def _finish_handle(self, handle: StreamHandle,
                       error: Optional[str] = None,
                       kind: Optional[str] = None) -> None:
        ev = Event(handle.call_id,
                   kind or ("error" if error else "stream_end"),
                   ok=error is None)
        ctx = self._ctx.get(handle.call_id)
        if ctx is not None:
            ctx.end_s = self.now()
            ctx.meta["error"] = error
            # a server-stream that failed before any chunk arrived may
            # be transparently re-issued by a RetryInterceptor
            if self._client_complete(ctx, ev):
                return                  # retried; the handle stays open
        handle.done, handle.error = True, error
        if self.tracer is not None and ctx is not None:
            self.tracer.on_terminal(ctx, ev.kind, error)
        self._emit(ev)
        self._handles.pop(handle.call_id, None)
        self._ctx.pop(handle.call_id, None)
        # free-on-complete: unpin this stream's zero-copy placements
        bufpool.release_call(handle.call_id)

    def _grant(self, msg: Message) -> None:
        ch = self._channels.get((msg.src, msg.dst, msg.frame.wire_mode))
        if ch is not None:
            ch.window.grant(msg.frame.total_bytes)

    def _offer_chunk(self, channel: Channel, frame: framing.Frame
                     ) -> None:
        """Queue one server->client stream chunk behind the channel's
        reverse window; admitted chunks join the next flight."""
        msg = Message(channel.dst, channel.src, frame)
        admitted = channel.rx_gate.offer(msg, frame.total_bytes)
        self._pending.extend((channel, m) for m in admitted)
        if self.tracer is not None and not admitted:
            self.tracer.on_stall(frame.call_id)

    def _on_client_chunk(self, m: Message) -> None:
        """A server->client stream chunk was delivered: hand it to the
        handle, return the reverse-window credits (the client consumed
        it), and complete the handle on END."""
        ch = self._channels.get((m.dst, m.src, m.frame.wire_mode))
        if ch is not None:
            ch.rx_gate.grant(m.frame.total_bytes)
        handle = self._handles.get(m.frame.call_id)
        if handle is None or handle.done:
            return
        if (m.frame.flags & framing.FLAG_ERROR) \
                and not m.frame.is_stream:
            # a pumped stream's producer faulted mid-stream: the error
            # reply rides the chunk path (reverse window) back to the
            # client and fails the handle like a dispatch-time fault
            err = (bytes(m.frame.bufs[0]).decode(errors="replace")
                   if m.frame.bufs else "error")
            self._purge_call(m.frame.call_id)
            self._finish_handle(
                handle, error=err,
                kind=("deadline_exceeded" if DEADLINE_EXCEEDED in err
                      else "error"))
            return
        if m.frame.n_buffers or not m.frame.stream_end:
            # bare END trailers carry no payload chunk
            handle.chunks.append(m.frame.bufs
                                 if m.frame.bufs is not None
                                 else list(m.frame.sizes))
            ctx = self._ctx.get(m.frame.call_id)
            if ctx is not None:
                ctx.chunks += 1     # delivered: a retry would duplicate
            self._emit(Event(m.frame.call_id, "stream_chunk",
                             payload=_spec_only(m.frame)))
        if m.frame.stream_end:
            self._finish_handle(handle)

    # deadlines ---------------------------------------------------------
    def _have_deadlines(self) -> bool:
        return any(c.deadline_s is not None for c in self._ctx.values())

    def _stamp_budget(self, msg: Message, now: float) -> Message:
        """Context propagation at flight departure: stamp the remaining
        deadline budget (gRPC's ``grpc-timeout``) and the call's trace
        id (the census-metadata analogue) into a request frame's header
        words, so the receiving server can shed work whose budget the
        wire consumed and attribute its spans to the originating
        call."""
        f = msg.frame
        if f.is_reply:
            return msg
        ctx = self._ctx.get(f.call_id)
        if ctx is None:
            return msg
        budget = f.budget_us
        if ctx.deadline_s is not None:
            budget = max(1, min(framing.MAX_BUDGET_US,
                                int((ctx.deadline_s - now) * 1e6)))
        if budget == f.budget_us and ctx.trace_id == f.trace_id:
            return msg
        return replace(msg, frame=replace(f, budget_us=budget,
                                          trace_id=ctx.trace_id))

    def _cancel_expired(self) -> int:
        now = self.now()
        expired = [c for c in self._ctx.values()
                   if c.deadline_s is not None and now >= c.deadline_s]
        for ctx in expired:
            self._cancel(ctx, DEADLINE_EXCEEDED)
        return len(expired)

    def _purge_call(self, cid: int) -> None:
        """Drop every in-flight frame of one call — backlogged, gated,
        AND already admitted to the next flight (refunding the admitted
        frames' window credits) — and the servers' partial-stream
        state. Dropping pending frames matters: a chunk delivered
        after a cancel would silently re-create the server-side stream
        state that no END will ever clean up."""
        kept: List[Tuple[Channel, Message]] = []
        for ch_, msg in self._backlog:
            if msg.frame.call_id == cid:
                ch_.backlogged -= 1     # queued frames held no credits
            else:
                kept.append((ch_, msg))
        self._backlog = kept
        kept = []
        for ch_, msg in self._pending:
            if msg.frame.call_id != cid:
                kept.append((ch_, msg))
            elif msg.frame.is_reply:    # admitted server->client chunk
                ch_.rx_gate.grant(msg.frame.total_bytes)
            else:                       # admitted client->server frame
                ch_.window.grant(msg.frame.total_bytes)
        self._pending = kept
        for ch_ in self._channels.values():
            ch_.rx_gate.drop(lambda m: m.frame.call_id == cid)
        for srv in self.servers.values():
            srv.abort_call(cid)     # partial streams never get their END

    def _cancel(self, ctx: CallContext, reason: str,
                kind: str = "deadline_exceeded") -> None:
        """Cancel one call: purge its frames and server state, then
        fail the future/handle with a ``kind`` event (deadline expiry,
        or ``"error"`` for an injected link fault — in which case the
        completion may be consumed as a retry and the call lives on
        under a fresh call_id)."""
        cid = ctx.call_id
        self._purge_call(cid)
        call = self._calls.get(cid)
        if call is not None and not call.done:
            self._complete(call, None, kind, error=reason)
        handle = self._handles.get(cid)
        if handle is not None and not handle.done:
            self._finish_handle(handle, error=reason, kind=kind)
        self._ctx.pop(cid, None)

    def _refund_message(self, m: Message) -> None:
        """Return the credits one undeliverable main-flight message
        held: reverse-window credits for a server->client stream
        chunk, forward-window credits for a client->server frame. The
        ONE refund path for faulted messages and their same-flight
        stragglers — the credit invariant the fault tier asserts."""
        if m.frame.is_reply:
            ch = self._channels.get((m.dst, m.src, m.frame.wire_mode))
            if ch is not None:
                ch.rx_gate.grant(m.frame.total_bytes)
        else:
            self._grant(m)

    def _on_link_fault(self, m: Message) -> List[int]:
        """A FaultInjectionTransport flagged this main-flight message
        lost to a transient link fault: refund the credits it held,
        purge the call's other in-flight frames, and fail it with a
        retryable error. Returns the dead call_id so same-flight
        stragglers of the call can be consumed without dispatching."""
        cid = m.frame.call_id
        self._refund_message(m)
        if self.tracer is not None:
            self.tracer.on_fault(m, self.now())
        ctx = self._ctx.get(cid)
        if ctx is not None:
            self._cancel(ctx, LINK_FAULT, kind="error")
        return [cid]

    def _deadline_wait(self) -> bool:
        """Everything is stalled on credits and nothing is in flight.
        If any *stalled* frame's call carries a deadline, advance the
        fabric clock to the earliest one (the modeled transport clock,
        or a real sleep) and cancel — back-pressure with a deadline
        resolves by cancellation, not by forcing uncredited admission.
        Returns True when a cancellation freed the loop."""
        stalled = {m.frame.call_id for _, m in self._backlog}
        for ch in self._channels.values():
            stalled.update(m.frame.call_id for m, _ in ch.rx_gate.items())
        deadlines = [self._ctx[c].deadline_s for c in stalled
                     if c in self._ctx
                     and self._ctx[c].deadline_s is not None]
        if not deadlines:
            return False
        target = min(deadlines)
        if self.transport.modeled and hasattr(self.transport, "clock_s"):
            self.transport.clock_s = max(self.transport.clock_s, target)
        else:
            time.sleep(max(0.0, target - time.perf_counter()))
        return self._cancel_expired() > 0

    # event loop --------------------------------------------------------
    def flush(self, *, until_s: Optional[float] = None) -> FlightReport:
        """Drive the event loop until every submitted call completes,
        every open response stream drains, and every expired deadline
        has cancelled its call.

        ``until_s`` bounds the drive by *fabric-clock time* instead:
        the loop stops as soon as ``now()`` reaches it, leaving
        unfinished calls pending for a later ``flush`` to continue —
        the open-loop workload driver (``repro_torch.workload.driver``)
        rides this to interleave new arrivals with in-flight traffic
        on the modeled clock. Flights are atomic, so the clock may
        overshoot ``until_s`` by one flight."""
        # traced: the whole drive is the region ``rpc.flush`` (framing,
        # delivery, the stream pumps and the handlers they run)
        if self.tracer is not None:
            with self.tracer.region("rpc.flush"):
                return self._flush(until_s)
        return self._flush(until_s)

    def _flush(self, until_s: Optional[float]) -> FlightReport:
        rep = FlightReport(modeled=self.transport.modeled)
        t0 = time.perf_counter()
        while True:
            if until_s is not None and self.now() >= until_s:
                break
            if self._ctx and self._have_deadlines():
                self._cancel_expired()
            if self._open_pumps():
                # one chunk per pumped stream per iteration: concurrent
                # pumped calls interleave chunk-by-chunk (the serving
                # scheduler's decode steps ride this cadence)
                self._pump_server_streams()
            if not (self._pending or self._backlog
                    or self._gated_chunks() or self._open_pumps()):
                break
            if not self._pending:
                # admit as credits allow; otherwise wait out a stalled
                # deadline; as a last resort one message must move or
                # the window is simply too small for the message
                admitted = self._admit_backlog() or self._pump_gates()
                if not admitted:
                    if self._deadline_wait():
                        continue
                    admitted = (self._admit_backlog(force_one=True)
                                or self._pump_gates(force_one=True))
                    assert admitted, "flow-control deadlock"
            flight = self._pending
            self._pending = []
            t_send = self.now()     # flight departure: budgets stamped
            stamped = [self._stamp_budget(m, t_send) for _, m in flight]
            if self.tracer is not None:
                for m in stamped:
                    if not m.frame.is_reply:
                        self.tracer.on_depart(m.frame.call_id, t_send)
            delivery = self.transport.deliver(stamped)
            rep.flights += 1
            rep.rounds += delivery.rounds
            rep.messages += len(delivery.messages)
            rep.elapsed_s += delivery.elapsed_s
            if self.tracer is not None:
                t_arrive = t_send + delivery.elapsed_s
                for m in delivery.messages:
                    if not (m.frame.flags & framing.FLAG_FAULT):
                        self.tracer.on_wire(m, t_send, t_arrive)
            replies: List[Message] = []
            dead: Set[int] = set()      # calls killed by a link fault
            # per-dst call_ids landed this flight: the queue-depth unit
            # is CALLS (a stream's chunks are one call's arrivals)
            arrivals: Dict[int, Set[int]] = {}
            for m in delivery.messages:
                if m.frame.flags & framing.FLAG_FAULT:
                    dead.update(self._on_link_fault(m))
                    continue
                if m.frame.call_id in dead:
                    # a straggler of a call a link fault already killed
                    # this flight: consume it, refund its credits, and
                    # never let it re-create server-side stream state
                    self._refund_message(m)
                    continue
                if m.frame.is_reply:
                    # server->client stream chunk riding a main flight
                    self._on_client_chunk(m)
                    continue
                call = self._calls.get(m.frame.call_id)
                handle = self._handles.get(m.frame.call_id)
                if not self.transport.dispatches:
                    # exchange datapath: delivery IS completion — a
                    # stream's call completes when its END lands, so
                    # deadlines/metrics cover the whole stream
                    self._grant(m)
                    if call is not None and not call.done \
                            and (not m.frame.is_stream
                                 or m.frame.stream_end):
                        self._complete(call, m.frame, "sent")
                    if handle is not None and m.frame.stream_end:
                        self._finish_handle(handle)
                    continue
                srv = self.servers.get(m.dst)
                if srv is None:
                    self._grant(m)
                    err = f"no server at endpoint {m.dst}"
                    if call is not None and not call.done:
                        self._complete(call, None, "error", error=err)
                    if handle is not None and not handle.done:
                        self._finish_handle(handle, error=err)
                    continue
                # the server's view of the propagated deadline: the
                # budget the frame left with, minus what the wire ate
                deadline = (t_send + m.frame.budget_us / 1e6
                            if m.frame.budget_us else None)
                cid = m.frame.call_id
                landed = arrivals.setdefault(m.dst, set())
                landed.add(cid)
                # queue depth = calls landed on this endpoint so far
                # this flight (including this one) + partial input
                # streams still open from EARLIER flights. Open pumps
                # are NOT counted: a pump is a call that was already
                # admitted and is now delivering results, so counting
                # it would starve unary traffic behind every long
                # decode (pump load reaches dispatch policies via the
                # scheduler gauges instead).
                depth = len(landed) \
                    + sum(1 for k in srv._streams if k not in landed) \
                    + sum(1 for k in srv._bidi_seq if k not in landed)
                if self.tracer is not None:
                    self.tracer.on_server(cid, self.now())
                outs = srv.dispatch(m.frame, deadline_s=deadline,
                                    queue_depth=depth)
                self._emit(Event(m.frame.call_id, "received",
                                 payload=_spec_only(m.frame)))
                plain = [o for o in outs if not o.is_stream]
                chunks = [o for o in outs if o.is_stream]
                pump = srv._pumps.get(cid)
                if pump is not None and pump.channel_key is None:
                    pump.channel_key = (m.src, m.dst,
                                        m.frame.wire_mode)
                if self.tracer is not None:
                    self.tracer.on_dispatched(
                        cid, self.now(),
                        replying=bool(plain or chunks)
                        or pump is not None)
                if plain:
                    # request credits return when the reply lands
                    self._awaiting_grant.setdefault(m.frame.call_id,
                                                    []).append(m)
                    replies.extend(Message(m.dst, m.src, o)
                                   for o in plain)
                else:
                    # stream-kind input (or one-way): receipt is
                    # consumption — forward credits return now. A
                    # one-way STREAM call completes only when its END
                    # chunk is consumed, keeping the call context (and
                    # its deadline) live for the whole stream
                    self._grant(m)
                    if call is not None and m.frame.one_way \
                            and not call.done \
                            and (not m.frame.is_stream
                                 or m.frame.stream_end):
                        self._complete(call, None, "sent")
                for o in chunks:
                    ch = self._channels.get((m.src, m.dst,
                                             m.frame.wire_mode))
                    assert ch is not None
                    self._offer_chunk(ch, o)
            if replies:
                t_rsend = self.now()
                rdel = self.transport.deliver(replies)
                rep.flights += 1
                rep.rounds += rdel.rounds
                rep.replies += len(rdel.messages)
                rep.elapsed_s += rdel.elapsed_s
                if self.tracer is not None:
                    t_rarr = t_rsend + rdel.elapsed_s
                    for m in rdel.messages:
                        if not (m.frame.flags & framing.FLAG_FAULT):
                            self.tracer.on_wire(m, t_rsend, t_rarr)
                for m in rdel.messages:
                    # grant the REQUEST's credits (reply size differs);
                    # even for a LOST reply — the server consumed the
                    # request regardless
                    reqs = self._awaiting_grant.get(m.frame.call_id)
                    if reqs:
                        self._grant(reqs.pop(0))
                        if not reqs:
                            del self._awaiting_grant[m.frame.call_id]
                    if m.frame.flags & framing.FLAG_FAULT:
                        # the reply was lost to an injected link fault:
                        # the call fails transiently (a retry re-runs
                        # the handler — at-least-once, like gRPC)
                        if self.tracer is not None:
                            self.tracer.on_fault(m, self.now())
                        ctx = self._ctx.get(m.frame.call_id)
                        if ctx is not None:
                            self._cancel(ctx, LINK_FAULT, kind="error")
                        continue
                    is_err = bool(m.frame.flags & framing.FLAG_ERROR)
                    err = None
                    if is_err:
                        err = bytes(m.frame.bufs[0]).decode(
                            errors="replace") if m.frame.bufs else "error"
                        # a rejected/shed stream call's remaining chunks
                        # are already doomed: purge them so they cannot
                        # re-create server-side state no END cleans up
                        self._purge_call(m.frame.call_id)
                    # server-shed work is a deadline outcome, not a
                    # generic error — metrics must count it as such
                    err_kind = ("deadline_exceeded"
                                if err and DEADLINE_EXCEEDED in err
                                else "error")
                    handle = self._handles.get(m.frame.call_id)
                    if handle is not None and not handle.done:
                        # stream request answered with a plain (error)
                        # reply — fail the handle
                        self._finish_handle(
                            handle, error=err or "protocol error",
                            kind=err_kind if is_err else None)
                    call = self._calls.get(m.frame.call_id)
                    if call is None or call.done:
                        continue
                    if is_err:
                        self._complete(call, m.frame, err_kind,
                                       error=err)
                    else:
                        self._complete(call, m.frame, "replied")
            self._admit_backlog()
            self._pump_gates()
        rep.wall_s = time.perf_counter() - t0
        return rep

    def _gated_chunks(self) -> int:
        return sum(len(ch.rx_gate) for ch in self._channels.values())

    def _open_pumps(self) -> int:
        return sum(len(srv._pumps) for srv in self.servers.values())

    def _pump_server_streams(self) -> None:
        """Pull one chunk from every open pumped server stream and
        offer it behind the owning channel's reverse window. A pump
        whose previous chunk is still window-gated is skipped this
        iteration — the producer is paced by the consumer's credits
        instead of piling chunks into the gate."""
        for srv in self.servers.values():
            for cid in list(srv._pumps):
                pump = srv._pumps[cid]
                ch = (self._channels.get(pump.channel_key)
                      if pump.channel_key is not None else None)
                if ch is None:      # registered this iteration; next one
                    continue
                if any(m.frame.call_id == cid
                       for m, _ in ch.rx_gate.items()):
                    continue
                for o in srv.pump_one(cid):
                    self._offer_chunk(ch, o)

    def _pump_gates(self, force_one: bool = False) -> int:
        """Re-admit reverse-window-stalled chunks after credit grants."""
        admitted = 0
        for ch in self._channels.values():
            if not len(ch.rx_gate):
                continue
            msgs = ch.rx_gate.pump(force_one=force_one and not admitted)
            self._pending.extend((ch, m) for m in msgs)
            if self.tracer is not None:
                for m in msgs:
                    self.tracer.on_admit(m.frame.call_id, reply=True)
            admitted += len(msgs)
        return admitted

    def _admit_backlog(self, force_one: bool = False) -> int:
        admitted, rest = 0, []
        blocked: set = set()
        for ch_, msg in self._backlog:
            # head-of-line per channel: once one of a channel's messages
            # stays blocked, its later ones stay queued too (ordering)
            if id(ch_) in blocked:
                rest.append((ch_, msg))
                continue
            # can_acquire first: a retry is not a new stall, so the
            # stall count stays one-per-call (recorded at submit time)
            if ch_.window.can_acquire(msg.frame.total_bytes):
                ch_.window.try_acquire(msg.frame.total_bytes)
                self._pending.append((ch_, msg))
                ch_.backlogged -= 1
                admitted += 1
                if self.tracer is not None:
                    self.tracer.on_admit(msg.frame.call_id)
            elif force_one and admitted == 0:
                self._pending.append((ch_, msg))
                ch_.backlogged -= 1
                admitted += 1
                if self.tracer is not None:
                    self.tracer.on_admit(msg.frame.call_id)
            else:
                blocked.add(id(ch_))
                rest.append((ch_, msg))
        self._backlog = rest
        return admitted


# ---------------------------------------------------------------------------
# benchmark drivers: the fully-connected / ring / incast exchanges over
# one fabric (paper §2's process architecture beyond the 3 fixed
# benchmarks), each expressed as stub calls against its declared
# service (service.EXCHANGE_SERVICE / RING_SERVICE / INCAST_SERVICE)
# ---------------------------------------------------------------------------

def fully_connected_exchange(fabric: RpcFabric, sizes: Sequence[int], *,
                             bufs: Optional[List[np.ndarray]] = None,
                             serialized: bool = False,
                             wire_mode: Optional[str] = None
                             ) -> FlightReport:
    """Every endpoint sends one payload to every other endpoint
    (n * (n-1) one-way unary RPCs through ``Exchange/exchange`` stubs),
    generated in the shift order of ``channels.all_to_all_schedule`` so
    the transport's edge coloring recovers exactly n-1 rounds."""
    from repro_torch.rpc.service import EXCHANGE_SERVICE
    n = fabric.n_endpoints
    assert n >= 2, n
    if fabric.transport.dispatches:
        handlers = {"exchange": lambda req: None}
        for e in range(n):
            if e not in fabric.servers:
                fabric.add_server(e).add_service(EXCHANGE_SERVICE,
                                                 handlers)
    for r in range(1, n):
        for i in range(n):
            stub = fabric.stub(EXCHANGE_SERVICE, i, (i + r) % n,
                               serialized=serialized,
                               wire_mode=wire_mode)
            stub.exchange(bufs, sizes=sizes if bufs is None else None,
                          one_way=True)
    return fabric.flush()


def ring_exchange(fabric: RpcFabric, sizes: Sequence[int], *,
                  n_chunks: int = 1,
                  bufs: Optional[List[np.ndarray]] = None,
                  serialized: bool = False,
                  wire_mode: Optional[str] = None) -> FlightReport:
    """Every worker client-streams ``n_chunks`` payload chunks to its
    successor (i -> (i+1) % n) through ``Ring/ring`` stubs: n one-way
    streams whose chunks the transport edge-colors back into exactly
    ``channels.ring_schedule(n, n_chunks)`` — n_chunks rotation
    rounds."""
    from repro_torch.rpc.service import RING_SERVICE
    n = fabric.n_endpoints
    assert n >= 2, n
    assert n_chunks >= 1, n_chunks
    if fabric.transport.dispatches:
        handlers = {"ring": lambda req: None}
        for e in range(n):
            if e not in fabric.servers:
                fabric.add_server(e).add_service(RING_SERVICE, handlers)
    for i in range(n):
        stub = fabric.stub(RING_SERVICE, i, (i + 1) % n,
                           serialized=serialized, wire_mode=wire_mode)
        stub.ring([bufs] * n_chunks if bufs is not None else None,
                  sizes=sizes if bufs is None else None,
                  n_chunks=n_chunks, one_way=True)
    return fabric.flush()


def incast_exchange(fabric: RpcFabric, sizes: Sequence[int], *,
                    n_chunks: int = 1,
                    bufs: Optional[List[np.ndarray]] = None,
                    serialized: bool = False,
                    wire_mode: Optional[str] = None,
                    fetch_ratio: float = 1.0) -> FlightReport:
    """The Cori-style parameter-server hotspot: every worker
    (endpoints 1..n-1) bidi-streams ``n_chunks`` payload chunks into
    one server (endpoint 0) through ``Incast/push_fetch`` stubs; on
    each stream's END the server streams the fetch back — sized
    ``fetch_ratio`` times the push payload (1.0 = symmetric; <1 models
    a small variable pull, >1 a fetch-heavy read) — so the server pays
    both the N-way ingress of the push AND the N-way egress of the
    fetch. On non-dispatching transports (collective) only the push
    half runs."""
    from repro_torch.core.payload import scale_sizes
    from repro_torch.rpc.service import INCAST_SERVICE
    n = fabric.n_endpoints
    assert n >= 2, "incast needs >= 1 worker + the server endpoint"
    assert n_chunks >= 1, n_chunks
    assert fetch_ratio > 0, fetch_ratio
    fetch_sizes = scale_sizes(sizes, fetch_ratio)
    # the fetch payload is baked into the server's handler closure on
    # first registration; a later call with a different shape would be
    # silently served the old fetch — reject it instead
    setup = (tuple(int(s) for s in sizes), float(fetch_ratio))
    prev = fabric._incast_setup
    if prev is not None and prev != setup:
        raise ValueError(
            f"incast server on this fabric already bound with "
            f"sizes/fetch_ratio {prev}; got {setup} — use a fresh "
            f"fabric to change the fetch shape")
    fabric._incast_setup = setup
    if fabric.transport.dispatches and 0 not in fabric.servers:
        if bufs is not None:
            fetch_bufs = [np.resize(b, s).astype(np.uint8)
                          for b, s in zip(bufs, fetch_sizes)]
            fetch = [list(fetch_bufs)] * n_chunks
        else:
            fetch = [tuple(fetch_sizes)] * n_chunks

        def push_fetch(chunk, end, _fetch=fetch):
            return _fetch if end else None

        fabric.add_server(0).add_service(INCAST_SERVICE,
                                         {"push_fetch": push_fetch})
    handles = [fabric.stub(INCAST_SERVICE, w, 0,
                           serialized=serialized, wire_mode=wire_mode)
               .push_fetch() for w in range(1, n)]
    for c in range(n_chunks):
        for h in handles:
            h.send(bufs, sizes=sizes if bufs is None else None,
                   end=(c == n_chunks - 1))
    rep = fabric.flush()
    assert all(h.done for h in handles)
    return rep
