"""Credit-based flow control (the HTTP/2 / gRPC window analogue).

Each channel holds one :class:`CreditWindow` **per direction**: the
forward window gates client->server frames, the reverse window gates
server->client stream chunks. Issuing a frame consumes byte + message
credits of its direction; completions (replies, chunk delivery, or
transport delivery for one-way calls) grant them back. When credits run
dry the frame queues locally instead of being dropped — the stall is
counted, which is exactly the back-pressure signal the paper's
flow-control discussion (§2.2) says a benchmark suite should expose —
and the stream resumes as soon as grants return credits. Because the
two directions hold independent windows, a bidi stream that is
window-limited both ways still makes progress: each direction drains on
its own credits.

:class:`ChunkGate` is the enforcement mechanism for a chunk stream: a
FIFO of pending chunks in front of one CreditWindow, so a later chunk
can never overtake an earlier stalled one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, List, Tuple


@dataclass
class FlowStats:
    acquired: int = 0           # calls admitted
    stalled: int = 0            # calls that had to wait for credits
    bytes_in_flight_peak: int = 0


@dataclass(frozen=True)
class WindowConfig:
    """Declarative size of one direction's CreditWindow — the shared
    vocabulary between the fabric's defaults and a cluster endpoint's
    advertised window (``rpc.cluster.EndpointSpec.window``)."""
    bytes: int = 4 * 1024 * 1024
    msgs: int = 32

    def make(self) -> "CreditWindow":
        return CreditWindow(self.bytes, self.msgs)


class CreditWindow:
    def __init__(self, window_bytes: int = 4 * 1024 * 1024,
                 window_msgs: int = 32):
        assert window_bytes > 0 and window_msgs > 0
        self.window_bytes = window_bytes
        self.window_msgs = window_msgs
        self.bytes_avail = window_bytes
        self.msgs_avail = window_msgs
        self.stats = FlowStats()

    @property
    def bytes_in_flight(self) -> int:
        return self.window_bytes - self.bytes_avail

    def can_acquire(self, nbytes: int) -> bool:
        # an over-window message is admitted alone (gRPC: a message may
        # exceed the window; it just occupies the whole window)
        fits = (self.bytes_avail >= min(nbytes, self.window_bytes)
                and self.msgs_avail >= 1)
        return fits

    def try_acquire(self, nbytes: int) -> bool:
        if not self.can_acquire(nbytes):
            self.stats.stalled += 1
            return False
        self.bytes_avail -= min(nbytes, self.window_bytes)
        self.msgs_avail -= 1
        self.stats.acquired += 1
        self.stats.bytes_in_flight_peak = max(
            self.stats.bytes_in_flight_peak, self.bytes_in_flight)
        return True

    def grant(self, nbytes: int) -> None:
        self.bytes_avail = min(self.window_bytes,
                               self.bytes_avail + min(nbytes,
                                                      self.window_bytes))
        self.msgs_avail = min(self.window_msgs, self.msgs_avail + 1)


class ChunkGate:
    """FIFO of stream chunks gated by one direction's CreditWindow.

    ``offer`` admits a chunk immediately when the window has credits and
    nothing is already queued (FIFO: a stalled chunk blocks all later
    ones); otherwise the chunk queues and the stall is counted once.
    ``pump`` re-admits queued chunks after ``grant`` returns credits.
    Chunks are never dropped: exhaustion only stalls the stream.
    """

    def __init__(self, window: CreditWindow):
        self.window = window
        self._q: Deque[Tuple[Any, int]] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, item: Any, nbytes: int) -> List[Any]:
        """Submit one chunk; returns the (0- or 1-element) admitted list."""
        if not self._q and self.window.try_acquire(nbytes):
            return [item]
        if self._q:     # try_acquire above already counted a fresh stall
            self.window.stats.stalled += 1
        self._q.append((item, nbytes))
        return []

    def pump(self, force_one: bool = False) -> List[Any]:
        """Admit queued chunks in FIFO order while credits last. With
        ``force_one`` and an empty window, admit the head anyway — an
        over-window chunk must occupy the window alone, not deadlock."""
        out: List[Any] = []
        while self._q:
            item, nbytes = self._q[0]
            # can_acquire first: a retry is not a new stall
            if self.window.can_acquire(nbytes):
                self.window.try_acquire(nbytes)
            elif force_one and not out:
                pass                    # admit uncredited, head-of-line
            else:
                break
            self._q.popleft()
            out.append(item)
        return out

    def grant(self, nbytes: int) -> None:
        self.window.grant(nbytes)

    def items(self) -> List[Tuple[Any, int]]:
        """The queued (item, nbytes) pairs, FIFO order (inspection —
        e.g. the fabric's deadline scan over stalled chunks)."""
        return list(self._q)

    def drop(self, pred) -> List[Tuple[Any, int]]:
        """Remove queued chunks whose item matches ``pred`` (call
        cancellation). Queued chunks hold no credits, so nothing is
        granted back; returns the dropped (item, nbytes) pairs."""
        dropped = [(it, nb) for it, nb in self._q if pred(it)]
        if dropped:
            self._q = deque((it, nb) for it, nb in self._q
                            if not pred(it))
        return dropped
