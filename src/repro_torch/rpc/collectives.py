"""Allreduce collectives as first-class fabric schedules.

Three algorithms reduce one flat float32 gradient across every fabric
endpoint, each expressed as per-step flights of store-only unary RPCs
through :data:`repro_torch.rpc.service.ALLREDUCE_SERVICE` stubs:

  ring    2(n-1) rotation steps over balanced chunks — the
          bandwidth-optimal schedule (each endpoint moves ~2·T/n bytes
          per step, no receiver contention);
  tree    binomial reduce toward endpoint 0 plus the mirrored
          broadcast — 2·ceil(log2 n) full-payload hops, latency-optimal
          at small payloads;
  rsag    reduce-scatter + allgather in two all-to-all flights — the
          fewest flights, but every endpoint ingests n-1 messages per
          flight and pays the quadratic host-copy contention the
          paper's incast measurements isolate.

Every step is one ``fabric.flush()``: all of a step's sends form one
transport flight, so the modeled elapsed time is the closed forms in
``core.netmodel`` (``ring_allreduce_time`` / ``tree_allreduce_time`` /
``rsag_allreduce_time``) and ``rpc.cluster``
(``cluster_*_allreduce_time``) *exactly* — driver and closed form share
the chunk partition (``netmodel.allreduce_chunk_sizes``) and schedule
helpers, so they cannot drift apart.

Handlers are store-only and the reduction arithmetic runs in the
driver between flushes, summing in a fixed worker order: a seeded link
fault that forces a retry never changes the summation order, so a
retried allreduce produces bit-identical gradients
(tests/test_collectives.py holds this). Reduce-scatter messages carry
an int64 source tag (``netmodel.ALLREDUCE_TAG_BYTES``) because their
inbox order is not topology-determined; ring and tree infer the source
from the schedule.

Real data rides any dispatching transport — loopback moves real bytes,
simulated/cluster pass buffers through unencoded while pricing the
spec — so one test can check numerics and modeled time in a single
run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.netmodel import (ALLREDUCE_ALGOS, ALLREDUCE_TAG_BYTES,
                                 allreduce_chunk_sizes,
                                 ring_allreduce_send_chunk,
                                 tree_reduce_rounds)
from repro_torch.rpc.fabric import FlightReport, RpcFabric
from repro_torch.rpc.service import ALLREDUCE_SERVICE

_DTYPE = np.float32
_ITEMSIZE = np.dtype(_DTYPE).itemsize


@dataclass
class CollectiveReport:
    """Aggregate of the per-step :class:`FlightReport`\\ s of one
    collective, plus the reduced per-endpoint vectors when real data
    was supplied (``None`` for spec-only runs)."""
    algo: str = ""
    steps: int = 0
    flights: int = 0
    rounds: int = 0
    messages: int = 0
    replies: int = 0
    elapsed_s: float = 0.0
    wall_s: float = 0.0
    modeled: bool = False
    result: Optional[List[np.ndarray]] = field(default=None, repr=False)

    def merge(self, rep: FlightReport) -> None:
        self.steps += 1
        self.flights += rep.flights
        self.rounds += rep.rounds
        self.messages += rep.messages
        self.replies += rep.replies
        self.elapsed_s += rep.elapsed_s
        self.wall_s += rep.wall_s


def _inboxes(fabric: RpcFabric) -> Optional[dict]:
    """Per-endpoint inboxes behind store-only ``Allreduce/chunk``
    handlers, registered once per fabric (state rides the fabric like
    ``_incast_setup`` does). Non-dispatching transports get ``None`` —
    delivery is completion there and only spec-only runs make sense."""
    if not fabric.transport.dispatches:
        return None
    boxes = getattr(fabric, "_allreduce_inboxes", None)
    if boxes is None:
        boxes = {e: [] for e in range(fabric.n_endpoints)}
        for e in range(fabric.n_endpoints):
            srv = fabric.servers.get(e)
            if srv is None:
                srv = fabric.add_server(e)

            def chunk(req, _box=boxes[e]):
                # copy immediately: zero-copy views point into pool
                # slots that are reclaimed once the call completes
                _box.append([np.asarray(b, dtype=np.uint8).copy()
                             for b in req] if req else None)
                return None

            srv.add_service(ALLREDUCE_SERVICE, {"chunk": chunk})
        fabric._allreduce_inboxes = boxes
    return boxes


def _clear(boxes: Optional[dict]) -> None:
    if boxes:
        for box in boxes.values():
            box.clear()


def _take_one(boxes: dict, endpoint: int) -> List[np.ndarray]:
    box = boxes[endpoint]
    assert len(box) == 1, \
        f"endpoint {endpoint}: expected 1 inbox entry, got {len(box)}"
    entry = box.pop()
    assert entry is not None, "real-data step delivered a spec-only frame"
    return entry


def _prepare(fabric: RpcFabric, total_bytes: Optional[int],
             data: Optional[Sequence[np.ndarray]], itemsize: int):
    """Validate the (spec-only | real-data) call shape; return
    ``(n, work, total_bytes, itemsize)`` with ``work`` the per-endpoint
    float32 working vectors (None for spec-only)."""
    n = fabric.n_endpoints
    if (total_bytes is None) == (data is None):
        raise ValueError("pass exactly one of total_bytes (spec-only) "
                         "or data (real buffers)")
    if data is None:
        total_bytes = int(total_bytes)
        if total_bytes < itemsize:
            raise ValueError(f"total_bytes must be >= itemsize, got "
                             f"{total_bytes}")
        return n, None, total_bytes, itemsize
    if not fabric.transport.dispatches:
        raise ValueError("real-data allreduce needs a dispatching "
                         "transport (loopback/simulated/cluster); "
                         "spec-only runs work everywhere")
    if len(data) != n:
        raise ValueError(f"data must have one vector per endpoint: "
                         f"got {len(data)} for {n} endpoints")
    work = [np.ascontiguousarray(np.asarray(d).ravel(), dtype=_DTYPE)
            .copy() for d in data]
    elems = work[0].size
    if elems == 0 or any(w.size != elems for w in work):
        raise ValueError("data vectors must share one non-empty shape")
    return n, work, elems * _ITEMSIZE, _ITEMSIZE


def _elem_offsets(chunks: Sequence[int], itemsize: int) -> List[int]:
    offs = [0]
    for c in chunks:
        offs.append(offs[-1] + c // itemsize)
    return offs


def _tag(src: int) -> np.ndarray:
    return np.array([src], dtype="<i8").view(np.uint8)


def _read_tagged(entry: List[np.ndarray]):
    src = int(np.frombuffer(entry[0], dtype="<i8")[0])
    return src, np.frombuffer(entry[1], dtype=_DTYPE)


def _stub(fabric, src, dst, serialized, wire_mode):
    return fabric.stub(ALLREDUCE_SERVICE, src, dst,
                       serialized=serialized, wire_mode=wire_mode)


# ---------------------------------------------------------------------------
# the three schedules
# ---------------------------------------------------------------------------

def ring_allreduce(fabric: RpcFabric, total_bytes: Optional[int] = None,
                   *, data: Optional[Sequence[np.ndarray]] = None,
                   itemsize: int = 1, serialized: bool = False,
                   wire_mode: Optional[str] = None) -> CollectiveReport:
    """Ring allreduce: 2(n-1) flights; at step ``s`` worker ``i`` sends
    chunk ``ring_allreduce_send_chunk(i, s, n)`` to ``(i+1) % n`` —
    reduce-scatter rotation, then allgather of the reduced chunks."""
    n, work, total_bytes, itemsize = _prepare(fabric, total_bytes, data,
                                              itemsize)
    rep = CollectiveReport(algo="ring", modeled=fabric.transport.modeled)
    if n < 2:
        rep.result = work
        return rep
    if total_bytes // itemsize < n:
        raise ValueError(f"ring allreduce needs >= 1 element per worker"
                         f": {total_bytes // itemsize} elements for "
                         f"{n} workers")
    boxes = _inboxes(fabric)
    chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
    offs = _elem_offsets(chunks, itemsize)
    for step in range(2 * (n - 1)):
        for i in range(n):
            c = ring_allreduce_send_chunk(i, step, n)
            stub = _stub(fabric, i, (i + 1) % n, serialized, wire_mode)
            if work is None:
                stub.chunk(None, sizes=(chunks[c],), one_way=True)
            else:
                seg = np.ascontiguousarray(work[i][offs[c]:offs[c + 1]])
                stub.chunk([seg.view(np.uint8)], one_way=True)
        rep.merge(fabric.flush())
        if work is None:
            _clear(boxes)
            continue
        for i in range(n):
            rc = ring_allreduce_send_chunk((i - 1) % n, step, n)
            incoming = np.frombuffer(_take_one(boxes, i)[0],
                                     dtype=_DTYPE)
            seg = slice(offs[rc], offs[rc + 1])
            if step < n - 1:
                # predecessor's partial sum + own contribution: the
                # ring's fixed accumulation order
                work[i][seg] = incoming + work[i][seg]
            else:
                work[i][seg] = incoming
    rep.result = work
    return rep


def tree_allreduce(fabric: RpcFabric, total_bytes: Optional[int] = None,
                   *, data: Optional[Sequence[np.ndarray]] = None,
                   serialized: bool = False,
                   wire_mode: Optional[str] = None) -> CollectiveReport:
    """Binomial-tree allreduce: ceil(log2 n) full-payload reduce
    flights toward endpoint 0, then the mirrored broadcast flights."""
    n, work, total_bytes, _ = _prepare(fabric, total_bytes, data, 1)
    rep = CollectiveReport(algo="tree", modeled=fabric.transport.modeled)
    if n < 2:
        rep.result = work
        return rep
    boxes = _inboxes(fabric)
    rounds = tree_reduce_rounds(n)
    sizes = (total_bytes,)
    for pairs in rounds:
        for s, d in pairs:
            stub = _stub(fabric, s, d, serialized, wire_mode)
            if work is None:
                stub.chunk(None, sizes=sizes, one_way=True)
            else:
                stub.chunk([work[s].view(np.uint8)], one_way=True)
        rep.merge(fabric.flush())
        if work is None:
            _clear(boxes)
            continue
        for s, d in pairs:
            incoming = np.frombuffer(_take_one(boxes, d)[0],
                                     dtype=_DTYPE)
            work[d] = incoming + work[d]
    for pairs in reversed(rounds):
        for s, d in pairs:
            stub = _stub(fabric, d, s, serialized, wire_mode)
            if work is None:
                stub.chunk(None, sizes=sizes, one_way=True)
            else:
                stub.chunk([work[d].view(np.uint8)], one_way=True)
        rep.merge(fabric.flush())
        if work is None:
            _clear(boxes)
            continue
        for s, d in pairs:
            work[s] = np.frombuffer(_take_one(boxes, s)[0],
                                    dtype=_DTYPE).copy()
    rep.result = work
    return rep


def rsag_allreduce(fabric: RpcFabric, total_bytes: Optional[int] = None,
                   *, data: Optional[Sequence[np.ndarray]] = None,
                   itemsize: int = 1, serialized: bool = False,
                   wire_mode: Optional[str] = None) -> CollectiveReport:
    """Reduce-scatter + allgather: flight 1 sends chunk ``j`` (with the
    int64 source tag) from every worker to worker ``j``, which reduces
    its chunk in ascending-source order; flight 2 broadcasts every
    reduced chunk."""
    n, work, total_bytes, itemsize = _prepare(fabric, total_bytes, data,
                                              itemsize)
    rep = CollectiveReport(algo="rsag", modeled=fabric.transport.modeled)
    if n < 2:
        rep.result = work
        return rep
    if total_bytes // itemsize < n:
        raise ValueError(f"rsag allreduce needs >= 1 element per worker"
                         f": {total_bytes // itemsize} elements for "
                         f"{n} workers")
    boxes = _inboxes(fabric)
    chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
    offs = _elem_offsets(chunks, itemsize)
    tag = ALLREDUCE_TAG_BYTES
    # flight 1: reduce-scatter (src-major submission order — the closed
    # forms replay the same order)
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            stub = _stub(fabric, i, j, serialized, wire_mode)
            if work is None:
                stub.chunk(None, sizes=(tag, chunks[j]), one_way=True)
            else:
                seg = np.ascontiguousarray(work[i][offs[j]:offs[j + 1]])
                stub.chunk([_tag(i), seg.view(np.uint8)], one_way=True)
    rep.merge(fabric.flush())
    reduced: List[Optional[np.ndarray]] = [None] * n
    if work is None:
        _clear(boxes)
    else:
        for j in range(n):
            got = {}
            for entry in boxes[j]:
                src, vals = _read_tagged(entry)
                got[src] = vals
            boxes[j].clear()
            assert len(got) == n - 1, \
                f"endpoint {j}: got chunks from {sorted(got)}"
            # own contribution first, then ascending source order —
            # fixed regardless of delivery (and retry) order
            acc = work[j][offs[j]:offs[j + 1]].copy()
            for src in sorted(got):
                acc = acc + got[src]
            work[j][offs[j]:offs[j + 1]] = acc
            reduced[j] = acc
    # flight 2: allgather of the reduced chunks (sender-major order)
    for j in range(n):
        for i in range(n):
            if i == j:
                continue
            stub = _stub(fabric, j, i, serialized, wire_mode)
            if work is None:
                stub.chunk(None, sizes=(tag, chunks[j]), one_way=True)
            else:
                stub.chunk([_tag(j),
                            np.ascontiguousarray(reduced[j])
                            .view(np.uint8)], one_way=True)
    rep.merge(fabric.flush())
    if work is None:
        _clear(boxes)
    else:
        for i in range(n):
            for entry in boxes[i]:
                src, vals = _read_tagged(entry)
                work[i][offs[src]:offs[src + 1]] = vals
            boxes[i].clear()
    rep.result = work
    return rep


_DRIVERS = {"ring": ring_allreduce, "tree": tree_allreduce,
            "rsag": rsag_allreduce}


def allreduce(fabric: RpcFabric, algo: str,
              total_bytes: Optional[int] = None, *,
              data: Optional[Sequence[np.ndarray]] = None,
              itemsize: int = 1, serialized: bool = False,
              wire_mode: Optional[str] = None) -> CollectiveReport:
    """Dispatch on the :data:`ALLREDUCE_ALGOS` name."""
    if algo not in _DRIVERS:
        raise ValueError(f"unknown allreduce algo {algo!r}; "
                         f"expected one of {ALLREDUCE_ALGOS}")
    kw = {} if algo == "tree" else {"itemsize": itemsize}
    return _DRIVERS[algo](fabric, total_bytes, data=data,
                          serialized=serialized, wire_mode=wire_mode,
                          **kw)


__all__ = [
    "ALLREDUCE_ALGOS", "CollectiveReport", "allreduce",
    "ring_allreduce", "rsag_allreduce", "tree_allreduce",
]
