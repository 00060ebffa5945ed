"""Message framing for the in-process RPC fabric (gRPC wire analogue).

A call is one :class:`Frame`: a fixed-layout little-endian header plus a
list of iovec payload buffers (uint8). Three wire encodings mirror the
paper's payload modes plus the one-sided-RDMA tier of "RPC Considered
Harmful" (PAPERS.md):

  serialized     — header + every buffer coalesced into ONE contiguous
                   uint8 wire buffer via the ``payload_pack`` Pallas
                   kernel (``backend="kernel"``, the TPU path) or a
                   byte-identical numpy copy (``backend="numpy"``, the
                   fast host path). One wire message per call.
  scatter_gather — header buffer + each payload buffer as a separate
                   wire message (iovec scatter-gather): no coalescing
                   copy, N+1 messages per call. (The config-level name
                   of this mode is ``non_serialized``.)
  zero_copy      — header buffer + ONE descriptor block of
                   ``(pool_id, offset, size)`` ``<u8`` triples; payload
                   bytes never ride the wire. The sender places each
                   buffer into a pre-registered shared
                   :class:`repro_torch.rpc.bufpool.BufferPool` region
                   (sender-managed placement — the one-sided-RDMA-write
                   analogue) and the receiver reads the bytes back out
                   of the pool, byte-identically, as zero-copy views.

Header layout (uint32 words, little-endian), zero-padded to a multiple
of the 128-byte TPU lane so it can itself be a pack-kernel buffer:

  [MAGIC, call_id, method_id, flags, seq, budget_us, trace_id,
   n_buffers, size_0 .. size_{n-1}]

``budget_us`` is the call's remaining deadline budget in microseconds
at the moment the frame left the sender — the wire form of gRPC's
``grpc-timeout`` header (0 = no deadline). The fabric stamps it at
flight departure and the receiving server sheds frames whose budget the
wire already consumed, before invoking any handler.

``trace_id`` is the call's distributed-tracing context (the gRPC
census-metadata analogue, see :mod:`repro_torch.rpc.tracing`): stamped at
flight departure alongside the budget, propagated unchanged into
replies and reply chunks, and stable across retries and failover
re-routes — the receiving endpoint attributes its spans to the
originating call through it (0 = untraced).

``seq`` orders the chunks of one stream (0 for unary frames). Stream
*chunks* (``stream_chunk``) carry FLAG_STREAM and a running seq; the
last chunk of a direction adds FLAG_STREAM_END; server->client chunks
add FLAG_REPLY. Chunks use the same two wire encodings as unary frames
— serialized chunks still coalesce through the payload_pack kernel.

Frames may be *spec-only* (``bufs is None``): the sizes are real but no
bytes are materialized — the simulated transport prices such frames
analytically without ever allocating hundreds of endpoints' payloads.
Zero-length iovec buffers are legal (a stream END trailer is a frame
with no buffers at all); they occupy one zero-filled lane on the
serialized wire and a zero-size message on the non-serialized wire.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.rpc.bufpool import get_pool

# TPU lane width in bytes. Must equal repro_torch.kernels.payload_pack.LANE
# (pinned by tests/test_rpc.py) — not imported from there so that
# importing repro_torch.rpc does not drag in jax/pallas; only the optional
# backend="kernel" paths do.
LANE = 128

#: the three wire modes, in paper order (Ethernet/IPoIB/RDMA analogue).
#: Must equal repro_torch.core.netmodel.WIRE_MODES (pinned by tests) — not
#: imported from there to keep framing free of core dependencies.
WIRE_MODES = ("serialized", "scatter_gather", "zero_copy")


class FramingError(ValueError):
    """A wire buffer that cannot be a frame: truncated header block,
    corrupt ``n_buffers`` word, or descriptors inconsistent with the
    header sizes."""

MAGIC = 0x52504331  # "RPC1"

FLAG_SERIALIZED = 1
FLAG_STREAM = 2
FLAG_STREAM_END = 4
FLAG_REPLY = 8
FLAG_ERROR = 16
FLAG_ONE_WAY = 32
#: set by a FaultInjectionTransport on a message it "lost" to a
#: transient link fault: the fabric refunds the frame's credits and
#: fails the call with a retryable error instead of dispatching it
FLAG_FAULT = 64
#: the frame's payload travels as shared-pool descriptors, not bytes
#: (mutually exclusive with FLAG_SERIALIZED; neither = scatter-gather)
FLAG_ZERO_COPY = 128

#: budget_us is a uint32 header word; longer deadlines saturate (them
#: expiring mid-flight is indistinguishable from no deadline anyway)
MAX_BUDGET_US = 0xFFFFFFFF

#: trace_id is a uint32 header word (0 = untraced)
MAX_TRACE_ID = 0xFFFFFFFF

_WORD = 4


def method_id(name: str) -> int:
    """Stable 32-bit id for a method name (both ends compute it)."""
    return zlib.crc32(name.encode("utf-8")) & 0xFFFFFFFF


def _pad128(n: int) -> int:
    return max(LANE, -(-n // LANE) * LANE)


def _as_u8(b: np.ndarray) -> np.ndarray:
    """Coerce to a flat contiguous uint8 view. Fast path: an array that
    already is one passes through untouched (no copy, no np call) — the
    common case on the flush-loop hot path."""
    if (isinstance(b, np.ndarray) and b.dtype == np.uint8 and b.ndim == 1
            and b.flags.c_contiguous):
        return b
    return np.ascontiguousarray(b, dtype=np.uint8).reshape(-1)


def _mode_flags(serialized: bool, wire_mode: Optional[str]) -> int:
    """Resolve the (legacy bool, explicit mode) pair to header flags."""
    if wire_mode is None:
        return FLAG_SERIALIZED if serialized else 0
    if wire_mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {wire_mode!r}; "
                         f"expected one of {WIRE_MODES}")
    if serialized and wire_mode != "serialized":
        raise ValueError(f"serialized=True conflicts with "
                         f"wire_mode={wire_mode!r}")
    if wire_mode == "serialized":
        return FLAG_SERIALIZED
    if wire_mode == "zero_copy":
        return FLAG_ZERO_COPY
    return 0


def resolve_wire_mode(serialized: bool = False,
                      wire_mode: Optional[str] = None) -> str:
    """Resolve the (legacy ``serialized`` bool, explicit ``wire_mode``)
    pair every fabric entry point accepts to a :data:`WIRE_MODES` name,
    rejecting unknown modes and conflicting combinations."""
    flags = _mode_flags(serialized, wire_mode)
    if flags & FLAG_SERIALIZED:
        return "serialized"
    if flags & FLAG_ZERO_COPY:
        return "zero_copy"
    return "scatter_gather"


@dataclass(frozen=True)
class Frame:
    call_id: int
    method: int                      # method_id(name)
    flags: int
    sizes: Tuple[int, ...]           # true (unpadded) iovec byte counts
    bufs: Optional[List[np.ndarray]] = None   # uint8, len == len(sizes)
    seq: int = 0                     # chunk index within a stream
    budget_us: int = 0               # remaining deadline budget (0=none)
    trace_id: int = 0                # tracing context (0=untraced)

    def __post_init__(self):
        assert 0 <= self.budget_us <= MAX_BUDGET_US, self.budget_us
        assert 0 <= self.trace_id <= MAX_TRACE_ID, self.trace_id
        assert not (self.flags & FLAG_SERIALIZED
                    and self.flags & FLAG_ZERO_COPY), \
            "FLAG_SERIALIZED and FLAG_ZERO_COPY are mutually exclusive"
        if self.bufs is not None:
            assert len(self.bufs) == len(self.sizes)
            for b, s in zip(self.bufs, self.sizes):
                assert b.dtype == np.uint8 and b.size == s, (b.shape, s)

    @property
    def total_bytes(self) -> int:
        return int(sum(self.sizes))

    @property
    def n_buffers(self) -> int:
        return len(self.sizes)

    @property
    def serialized(self) -> bool:
        return bool(self.flags & FLAG_SERIALIZED)

    @property
    def zero_copy(self) -> bool:
        return bool(self.flags & FLAG_ZERO_COPY)

    @property
    def wire_mode(self) -> str:
        if self.flags & FLAG_SERIALIZED:
            return "serialized"
        if self.flags & FLAG_ZERO_COPY:
            return "zero_copy"
        return "scatter_gather"

    @property
    def one_way(self) -> bool:
        return bool(self.flags & FLAG_ONE_WAY)

    @property
    def is_stream(self) -> bool:
        return bool(self.flags & FLAG_STREAM)

    @property
    def is_reply(self) -> bool:
        return bool(self.flags & FLAG_REPLY)

    @property
    def stream_end(self) -> bool:
        return bool(self.flags & FLAG_STREAM_END)

    def reply(self, bufs: Optional[List[np.ndarray]],
              sizes: Optional[Sequence[int]] = None, *,
              error: bool = False) -> "Frame":
        if bufs is not None:
            bufs = [_as_u8(b) for b in bufs]
        if sizes is None:
            assert bufs is not None
            sizes = [int(b.size) for b in bufs]
        flags = (self.flags & (FLAG_SERIALIZED | FLAG_ZERO_COPY)) | FLAG_REPLY
        if error:
            flags |= FLAG_ERROR
        return Frame(self.call_id, self.method, flags,
                     tuple(int(s) for s in sizes), bufs,
                     trace_id=self.trace_id)

    def reply_chunk(self, bufs: Optional[List[np.ndarray]], *, seq: int,
                    end: bool = False,
                    sizes: Optional[Sequence[int]] = None) -> "Frame":
        """A server->client stream chunk answering this frame's call.
        ``bufs=None`` with explicit ``sizes`` builds a spec-only chunk
        (modeled transports); ``bufs=None, sizes=None`` a bare END
        trailer (no payload, still encodable)."""
        if bufs is None and sizes is None:
            bufs = []
        if bufs is not None:
            bufs = [_as_u8(b) for b in bufs]
        if sizes is None:
            sizes = [int(b.size) for b in bufs] if bufs is not None else []
        flags = ((self.flags & (FLAG_SERIALIZED | FLAG_ZERO_COPY))
                 | FLAG_REPLY | FLAG_STREAM
                 | (FLAG_STREAM_END if end else 0))
        return Frame(self.call_id, self.method, flags,
                     tuple(int(s) for s in sizes), bufs, seq=seq,
                     trace_id=self.trace_id)


def make_frame(call_id: int, method: str, bufs: Optional[List[np.ndarray]],
               *, sizes: Optional[Sequence[int]] = None,
               serialized: bool = False, wire_mode: Optional[str] = None,
               one_way: bool = False,
               stream: bool = False, stream_end: bool = False,
               reply: bool = False, seq: int = 0,
               budget_us: int = 0) -> Frame:
    if sizes is None:
        assert bufs is not None, "spec-only frames need explicit sizes"
        sizes = [int(b.size) for b in bufs]
    assert all(s >= 0 for s in sizes), sizes
    bufs = [_as_u8(b) for b in bufs] if bufs is not None else None
    flags = (_mode_flags(serialized, wire_mode)
             | (FLAG_ONE_WAY if one_way else 0)
             | (FLAG_STREAM if stream else 0)
             | (FLAG_STREAM_END if stream_end else 0)
             | (FLAG_REPLY if reply else 0))
    return Frame(call_id, method_id(method), flags, tuple(int(s)
                                                          for s in sizes),
                 bufs, seq=seq, budget_us=budget_us)


def stream_chunk(call_id: int, method: str,
                 bufs: Optional[List[np.ndarray]], *, seq: int,
                 end: bool = False, serialized: bool = False,
                 wire_mode: Optional[str] = None,
                 one_way: bool = False, reply: bool = False,
                 sizes: Optional[Sequence[int]] = None) -> Frame:
    """One chunk of a stream: FLAG_STREAM + running seq; the last chunk
    of a direction carries FLAG_STREAM_END. ``bufs=None`` with no sizes
    is the bare END trailer (a header-only frame)."""
    if bufs is None and sizes is None:
        bufs = []
    return make_frame(call_id, method, bufs, sizes=sizes,
                      serialized=serialized, wire_mode=wire_mode,
                      one_way=one_way, stream=True,
                      stream_end=end, reply=reply, seq=seq)


# ---------------------------------------------------------------------------
# header
# ---------------------------------------------------------------------------

# MAGIC, call_id, method, flags, seq, budget_us, trace_id, n_buffers
_FIXED_WORDS = 8


def header_bytes(frame: Frame) -> np.ndarray:
    """Little-endian uint32 header, zero-padded to a LANE multiple."""
    words = [MAGIC, frame.call_id, frame.method, frame.flags, frame.seq,
             frame.budget_us, frame.trace_id, frame.n_buffers,
             *frame.sizes]
    raw = np.asarray(words, dtype="<u4").view(np.uint8)
    out = np.zeros(_pad128(raw.size), dtype=np.uint8)
    out[:raw.size] = raw
    return out


def parse_header(data: np.ndarray) -> Tuple[Frame, int]:
    """Parse a header prefix -> (spec-only Frame, header length in bytes).

    Raises :class:`FramingError` on a truncated header block or a
    corrupt ``n_buffers`` word that claims more size words than the
    wire buffer holds (previously this silently yielded a short
    ``sizes`` tuple)."""
    if data.size < LANE:
        raise FramingError(
            f"truncated wire buffer: {data.size} bytes, header needs "
            f"at least {LANE}")
    head = np.ascontiguousarray(data[:LANE]).view("<u4")
    assert int(head[0]) == MAGIC, f"bad frame magic {int(head[0]):#x}"
    call_id, method, flags, seq, budget_us, trace_id, n = (
        int(head[1]), int(head[2]), int(head[3]), int(head[4]),
        int(head[5]), int(head[6]), int(head[7]))
    hdr_len = _pad128((_FIXED_WORDS + n) * _WORD)
    if hdr_len > data.size:
        raise FramingError(
            f"corrupt n_buffers={n}: header claims {hdr_len} bytes but "
            f"wire buffer holds only {data.size}")
    if hdr_len <= LANE:        # common case: sizes fit the first lane
        words = head
    else:
        words = np.ascontiguousarray(data[:hdr_len]).view("<u4")
    sizes = tuple(int(s) for s in words[_FIXED_WORDS:_FIXED_WORDS + n])
    return Frame(call_id, method, flags, sizes, None, seq=seq,
                 budget_us=budget_us, trace_id=trace_id), hdr_len


# ---------------------------------------------------------------------------
# wire encode / decode
# ---------------------------------------------------------------------------

def _pack_numpy(bufs: List[np.ndarray]) -> np.ndarray:
    """Byte-identical host-side layout of the pack kernel: each buffer
    zero-padded to the 128-byte lane (a zero-size buffer becomes one
    zero lane), then concatenated. One preallocated output with slice
    copies — no per-buffer ``np.pad``/``np.concatenate`` temporaries."""
    total = 0
    offsets = []
    for b in bufs:
        offsets.append(total)
        total += _pad128(b.size)
    out = np.zeros(total, dtype=np.uint8)
    for b, off in zip(bufs, offsets):
        if b.size:
            out[off:off + b.size] = b
    return out


def _unpack_numpy(wire: np.ndarray, sizes: Sequence[int]
                  ) -> List[np.ndarray]:
    out, off = [], 0
    for s in sizes:
        out.append(np.asarray(wire[off:off + s]))
        off += _pad128(s)
    return out


def _check_backend(backend: str) -> None:
    if backend not in ("numpy", "kernel"):
        raise ValueError(f"unknown framing backend {backend!r}; "
                         f"expected 'numpy' or 'kernel'")


def _encode_descriptors(frame: Frame) -> np.ndarray:
    """Place every payload buffer into the shared pool and return the
    descriptor block: one ``(pool_id, offset, size)`` ``<u8`` triple per
    buffer, viewed as uint8 wire bytes."""
    pool = get_pool()
    desc = np.zeros(3 * len(frame.bufs), dtype="<u8")
    for i, b in enumerate(frame.bufs):
        # pin the slot to the call: the fabric releases it when the
        # call completes (free-on-complete), so a wrap can never tear
        # bytes an in-flight receiver still views
        offset, size = pool.place(b, owner=frame.call_id)
        desc[3 * i] = pool.pool_id
        desc[3 * i + 1] = offset
        desc[3 * i + 2] = size
    return desc.view(np.uint8)


def _decode_descriptors(head: Frame, desc_msg: np.ndarray
                        ) -> List[np.ndarray]:
    """Resolve a descriptor block back to payload views (pool
    read-back). Sizes must match the header's size words."""
    desc = np.ascontiguousarray(desc_msg).view("<u8")
    if desc.size != 3 * head.n_buffers:
        raise FramingError(
            f"descriptor block has {desc.size // 3} triples for "
            f"{head.n_buffers} buffers")
    bufs = []
    for i, want in enumerate(head.sizes):
        pid = int(desc[3 * i])
        offset = int(desc[3 * i + 1])
        size = int(desc[3 * i + 2])
        if size != want:
            raise FramingError(
                f"descriptor {i} size {size} != header size {want}")
        bufs.append(get_pool(pid).read(offset, size))
    return bufs


def encode(frame: Frame, *, backend: str = "numpy") -> List[np.ndarray]:
    """Frame -> wire messages (list of uint8 arrays).

    serialized: one message [header | packed payload]; the coalescing
    copy runs through the payload_pack kernel (backend="kernel") or the
    equivalent numpy path (backend="numpy") — identical bytes either way.
    scatter_gather: [header, buf_0, .., buf_{n-1}] untouched.
    zero_copy: [header, descriptor block]; the payload bytes go into
    the shared pool (sender-managed placement), never onto the wire.
    """
    _check_backend(backend)
    assert frame.bufs is not None, "cannot encode a spec-only frame"
    hdr = header_bytes(frame)
    if frame.zero_copy:
        return [hdr, _encode_descriptors(frame)]
    if not frame.serialized:
        return [hdr] + list(frame.bufs)
    parts = [hdr] + list(frame.bufs)
    # the pack kernel wants non-empty operands; zero-size buffers (legal
    # in stream chunks) take the byte-identical numpy layout instead
    if backend == "kernel" and all(p.size > 0 for p in parts):
        from repro_torch.kernels.payload_pack import pack as kpack, to_card
        packed, _ = kpack(to_card(parts))
        # kernel output is already the lane-padded concatenation
        return [packed.cpu().numpy()]
    return [_pack_numpy(parts)]


def decode(messages: List[np.ndarray], *, backend: str = "numpy") -> Frame:
    """Wire messages -> Frame (byte-identical round trip of encode).
    Zero-copy frames resolve their descriptors to views into the shared
    pool — valid until the sender's placement cursor laps the slot."""
    _check_backend(backend)
    head, hdr_len = parse_header(messages[0])
    if head.zero_copy:
        assert len(messages) == 2, \
            "zero-copy frame is header + descriptor block"
        return replace(head, bufs=_decode_descriptors(head, messages[1]))
    if not head.serialized:
        bufs = [_as_u8(m[:s]) for m, s in zip(messages[1:], head.sizes)]
        return replace(head, bufs=bufs)
    assert len(messages) == 1, "serialized frame is one wire message"
    wire = messages[0]
    sizes = [hdr_len] + list(head.sizes)
    if backend == "kernel" and all(s > 0 for s in sizes):
        from repro_torch.kernels.payload_pack import to_card, unpack as kunpack
        parts = [p.cpu().numpy() for p in kunpack(to_card([wire])[0], sizes)]
    else:
        parts = _unpack_numpy(wire, sizes)
    return replace(head, bufs=parts[1:])
