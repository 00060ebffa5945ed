"""Completion queue — the fabric's event loop primitive (gRPC CQ
analogue). Transports and the fabric push typed events; drivers poll or
drain. Thread-safe so a loopback server thread may complete calls while
the client polls.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, List, Optional


@dataclass(frozen=True)
class Event:
    tag: int                # call_id (or flight id for transport events)
    kind: str               # "sent" | "received" | "replied" | "error"
                            # | "stream_chunk" | "stream_end"
                            # | "deadline_exceeded" | "retry"
    ok: bool = True
    payload: Any = None     # usually a framing.Frame
    elapsed_s: float = 0.0


class CompletionQueue:
    """Bounded: when nobody drains (benchmark loops), the oldest events
    fall off instead of retaining every delivered payload forever;
    ``dropped`` counts them."""

    def __init__(self, maxlen: int = 4096):
        self._q: Deque[Event] = deque(maxlen=maxlen)
        self._cv = threading.Condition()
        self.dropped = 0

    def push(self, ev: Event) -> None:
        with self._cv:
            if self._q.maxlen is not None \
                    and len(self._q) == self._q.maxlen:
                self.dropped += 1
            self._q.append(ev)
            self._cv.notify_all()

    def poll(self, timeout_s: float = 0.0) -> Optional[Event]:
        with self._cv:
            if not self._q and timeout_s > 0:
                self._cv.wait(timeout_s)
            return self._q.popleft() if self._q else None

    def drain(self) -> List[Event]:
        with self._cv:
            out = list(self._q)
            self._q.clear()
            return out

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)
