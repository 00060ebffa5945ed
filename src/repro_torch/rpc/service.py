"""Declarative service API for the RPC fabric (the gRPC service/stub
analogue).

A :class:`ServiceDef` names a set of :class:`MethodSpec`\\ s — method
name, cardinality kind, optional payload codecs. The server side binds
a whole service at once (``Server.add_service(service, handlers)``);
the client side gets a generated :class:`Stub` whose attributes are the
service's methods and whose invocations return call handles uniformly:

    GREETER = ServiceDef("Greeter", (
        MethodSpec("hello", UNARY),
        MethodSpec("stream_hello", SERVER_STREAM),
    ))

    fabric.add_server(1).add_service(GREETER, handlers)
    stub = fabric.stub(GREETER, src=0, dst=1)
    call = stub.hello([buf])                 # -> UnaryCall
    h = stub.stream_hello([buf])             # -> fabric.ServerStream
    fabric.flush(); call.result(); h.chunk_bufs()

Wire method names are ``"Service/method"`` (hashed through
``framing.method_id`` like every method). Each stub method accepts
``deadline_s`` (relative seconds, enforced by the fabric's flush loop)
and validates the invocation against the method's kind — invoking a
unary method as a stream raises a ``method-kind mismatch`` ValueError
on the client, before anything hits the wire.

Codecs are optional ``encode(obj) -> iovec list`` /
``decode(iovecs) -> obj`` pairs; with a request codec the stub method
takes the object, with a response codec ``UnaryCall.result()`` returns
the object. Without codecs everything is raw iovec buffer lists, the
benchmark-friendly path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.rpc.fabric import (BIDI, CLIENT_STREAM, SERVER_STREAM, UNARY,
                              BidiStream, Call, Channel, RpcError,
                              ServerStream)

KINDS = (UNARY, CLIENT_STREAM, SERVER_STREAM, BIDI)


@dataclass(frozen=True)
class Codec:
    """Payload codec: python object <-> iovec buffer list."""
    encode: Callable[[Any], List[np.ndarray]]
    decode: Callable[[List[np.ndarray]], Any]


@dataclass(frozen=True)
class MethodSpec:
    """One method of a service: name, cardinality kind, codecs, and an
    optional default deadline (relative seconds) the stub applies to
    invocations that pass none — the declarative twin of a
    ``DeadlineInterceptor`` default, scoped to one method. The budget
    is propagated to the server in the frame header like any
    deadline."""
    name: str
    kind: str = UNARY
    request_codec: Optional[Codec] = None
    response_codec: Optional[Codec] = None
    deadline_s: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"method {self.name!r}: unknown kind {self.kind!r}; "
                f"choose from {KINDS}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"method {self.name!r}: deadline_s must be > 0, got "
                f"{self.deadline_s}")


@dataclass(frozen=True)
class ServiceDef:
    """A named set of methods; the unit of registration and stubbing."""
    name: str
    methods: Tuple[MethodSpec, ...]

    def __post_init__(self):
        seen = set()
        for m in self.methods:
            if m.name in seen:
                raise ValueError(f"service {self.name!r}: duplicate "
                                 f"method {m.name!r}")
            seen.add(m.name)

    def full_name(self, method: str) -> str:
        """The wire method name, gRPC-style ``Service/method``."""
        return f"{self.name}/{method}"

    def spec(self, method: str) -> MethodSpec:
        for m in self.methods:
            if m.name == method:
                return m
        raise ValueError(f"service {self.name!r} has no method "
                         f"{method!r}; methods: "
                         f"{[m.name for m in self.methods]}")


class UnaryCall:
    """Uniform client handle for unary and client-streaming calls:
    wraps the fabric's :class:`Call` future, decodes through the
    method's response codec, and can drive itself to completion."""

    def __init__(self, call: Call, channel: Channel, spec: MethodSpec):
        self._call = call
        self._channel = channel
        self._spec = spec

    @property
    def call_id(self) -> int:
        return self._call.call_id

    @property
    def done(self) -> bool:
        return self._call.done

    @property
    def error(self) -> Optional[str]:
        return self._call.error

    def result(self) -> Any:
        """Flush the fabric if needed, then return the decoded response
        (or the raw reply iovecs without a response codec). Raises
        :class:`RpcError` on error / deadline-exceeded."""
        if not self._call.done:
            self._channel.fabric.flush()
        bufs = self._call.reply_bufs()
        if self._spec.response_codec is not None:
            return self._spec.response_codec.decode(bufs)
        return bufs

    def reply_bufs(self) -> List[np.ndarray]:
        return self._call.reply_bufs()


class StubMethod:
    """One callable method of a stub. ``__call__`` dispatches on the
    spec's kind; the explicit per-kind invokers raise a
    ``method-kind mismatch`` ValueError when used against a method of
    another kind (the client-side twin of the server's cardinality
    check)."""

    def __init__(self, channel: Channel, service: ServiceDef,
                 spec: MethodSpec):
        self._channel = channel
        self._service = service
        self.spec = spec
        self.full_name = service.full_name(spec.name)

    def __call__(self, request: Any = None, **kw):
        return {UNARY: self.unary, CLIENT_STREAM: self.client_stream,
                SERVER_STREAM: self.server_stream,
                BIDI: self.bidi}[self.spec.kind](request, **kw)

    def _require(self, kind: str) -> None:
        if self.spec.kind != kind:
            raise ValueError(
                f"method-kind mismatch: {self.full_name} is "
                f"{self.spec.kind}, invoked as {kind}")

    def _encode(self, request: Any) -> Optional[List[np.ndarray]]:
        if request is None:
            return None
        if self.spec.request_codec is not None:
            return self.spec.request_codec.encode(request)
        return list(request)

    def _deadline(self, deadline_s: Optional[float]) -> Optional[float]:
        """A per-call deadline wins; otherwise the method's declared
        default (None = no deadline)."""
        return deadline_s if deadline_s is not None \
            else self.spec.deadline_s

    # per-kind invokers --------------------------------------------------
    def unary(self, request: Any = None, *,
              sizes: Optional[Sequence[int]] = None,
              one_way: bool = False,
              deadline_s: Optional[float] = None) -> UnaryCall:
        self._require(UNARY)
        call = self._channel.call(self.full_name, self._encode(request),
                                  sizes=sizes, one_way=one_way,
                                  deadline_s=self._deadline(deadline_s))
        return UnaryCall(call, self._channel, self.spec)

    def client_stream(self, chunks: Any = None, *,
                      sizes: Optional[Sequence[int]] = None,
                      n_chunks: Optional[int] = None,
                      one_way: bool = False,
                      deadline_s: Optional[float] = None) -> UnaryCall:
        """``chunks`` is a sequence of per-chunk requests (each run
        through the request codec); spec-only streams pass
        ``sizes`` + ``n_chunks`` instead."""
        self._require(CLIENT_STREAM)
        enc = ([self._encode(c) for c in chunks]
               if chunks is not None else [])
        call = self._channel.stream(self.full_name, enc, sizes=sizes,
                                    n_chunks=n_chunks, one_way=one_way,
                                    deadline_s=self._deadline(deadline_s))
        return UnaryCall(call, self._channel, self.spec)

    def server_stream(self, request: Any = None, *,
                      sizes: Optional[Sequence[int]] = None,
                      deadline_s: Optional[float] = None) -> ServerStream:
        self._require(SERVER_STREAM)
        return self._channel.server_stream(
            self.full_name, self._encode(request), sizes=sizes,
            deadline_s=self._deadline(deadline_s))

    def bidi(self, chunks: Any = None, *,
             deadline_s: Optional[float] = None) -> BidiStream:
        self._require(BIDI)
        enc = ([self._encode(c) for c in chunks]
               if chunks is not None else None)
        return self._channel.bidi_stream(
            self.full_name, enc, deadline_s=self._deadline(deadline_s))


class Stub:
    """Generated client for one service over one channel: an attribute
    per method, each a :class:`StubMethod`."""

    def __init__(self, channel: Channel, service: ServiceDef):
        self._channel = channel
        self.service = service
        self._methods = {m.name: StubMethod(channel, service, m)
                         for m in service.methods}

    def __getattr__(self, name: str) -> StubMethod:
        # everything below reads via __dict__: this hook must degrade
        # to a plain AttributeError (not recurse) when the instance is
        # unpopulated, e.g. during copy/pickle protocol probes
        methods = self.__dict__.get("_methods")
        if methods is not None and name in methods:
            return methods[name]
        svc = self.__dict__.get("service")
        raise AttributeError(
            f"service {svc.name if svc else '?'!r} has no method "
            f"{name!r}; methods: {sorted(methods or ())}")

    def method(self, name: str) -> StubMethod:
        """Explicit lookup (for computed method names)."""
        return self.__getattr__(name)

    @property
    def channel(self) -> Channel:
        return self._channel


# ---------------------------------------------------------------------------
# benchmark services — the fabric exchange families, declared gRPC-style
# ---------------------------------------------------------------------------

#: fully-connected family: one one-way unary per (src, dst) pair
EXCHANGE_SERVICE = ServiceDef("Exchange", (
    MethodSpec("exchange", UNARY),))

#: ring family: each worker client-streams chunks to its successor
RING_SERVICE = ServiceDef("Ring", (
    MethodSpec("ring", CLIENT_STREAM),))

#: incast family: workers bidi-stream into one server that streams the
#: (possibly asymmetric) fetch back
INCAST_SERVICE = ServiceDef("Incast", (
    MethodSpec("push_fetch", BIDI),))

#: allreduce family: one store-only unary method every collective
#: schedule (ring / tree / reduce-scatter+allgather) sends its per-step
#: chunks through — rpc.collectives drives the flights
ALLREDUCE_SERVICE = ServiceDef("Allreduce", (
    MethodSpec("chunk", UNARY),))

#: transport-conformance service: one method per cardinality kind, so a
#: dispatching transport can be exercised uniformly across endpoints
#: (the fabric conformance test tier drives it against every transport)
CONFORMANCE_SERVICE = ServiceDef("Conformance", (
    MethodSpec("echo", UNARY),              # request back verbatim
    MethodSpec("gather", CLIENT_STREAM),    # total byte count of stream
    MethodSpec("split", SERVER_STREAM),     # request rechunked
    MethodSpec("relay", BIDI),              # each chunk echoed
))


def conformance_handlers(*, chunk_bytes: int = 128):
    """Reference handlers for :data:`CONFORMANCE_SERVICE`: ``echo``
    returns the request buffers, ``gather`` replies with the byte count
    of the concatenated stream (little-endian uint32), ``split``
    streams the concatenated request back in ``chunk_bytes`` pieces,
    ``relay`` echoes every chunk as it arrives."""

    def echo(req):
        return [np.array(b, copy=True) for b in req]

    def gather(req):
        total = int(sum(b.size for b in req))
        return [np.asarray([total], dtype="<u4").view(np.uint8)]

    def split(req):
        data = (np.concatenate([b.reshape(-1) for b in req])
                if req else np.zeros(0, np.uint8))
        if data.size == 0:
            return []
        return [[np.array(data[i:i + chunk_bytes], copy=True)]
                for i in range(0, data.size, chunk_bytes)]

    def relay(chunk, end):
        return [[np.array(b, copy=True) for b in chunk]] if chunk else []

    return {"echo": echo, "gather": gather, "split": split,
            "relay": relay}


__all__ = [
    "ALLREDUCE_SERVICE", "BIDI", "CLIENT_STREAM", "CONFORMANCE_SERVICE",
    "Codec",
    "EXCHANGE_SERVICE", "INCAST_SERVICE", "KINDS", "MethodSpec",
    "RING_SERVICE", "RpcError", "SERVER_STREAM", "ServiceDef", "Stub",
    "StubMethod", "UNARY", "UnaryCall", "conformance_handlers",
]
