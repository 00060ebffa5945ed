"""Pluggable transports for the RPC fabric.

A transport moves one *flight* of point-to-point messages and reports
how long the flight took:

  LoopbackTransport        — single-host shared-buffer memcpy;
                             wall-clock measured. The
                             serving-experiment path.
  SimulatedTransport       — no data moves; elapsed is priced by a
                             ``core.netmodel.NetworkModel``
                             (receiver-side NIC serialization +
                             CPU-copy contention, plus sender-side
                             egress), so topologies of hundreds of
                             endpoints run in milliseconds.
  CollectiveTransport      — (repro_torch.rpc.collective) lowers the flight
                             onto the ``ppermute`` schedules of
                             ``core.channels``; measured on real
                             devices.
  FaultInjectionTransport  — seeded fault-injection wrapper around any
                             of the above: per-link transient message
                             faults, extra latency, and stalled
                             streams — the instrument the fault test
                             tier drives everything with.

Physical fabrics move at most one message per (src, dst) port pair at a
time, so a flight is internally decomposed into edge-colored *rounds*
(unique sources and destinations per round) — the same constraint
``channels.bipartite_schedule`` encodes for ppermute.
"""
from __future__ import annotations

import abc
import time
from collections import deque
from dataclasses import dataclass, replace
from typing import (Deque, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

import numpy as np

from repro_torch.core.netmodel import NetworkModel
from repro_torch.core.payload import PayloadSpec, classify
from repro_torch.rpc import framing


@dataclass(frozen=True)
class Message:
    src: int
    dst: int
    frame: framing.Frame


@dataclass
class Delivery:
    messages: List[Message]     # as delivered (frames re-decoded off wire)
    elapsed_s: float
    rounds: int
    modeled: bool


def schedule_rounds(messages: Sequence[Message]) -> List[List[Message]]:
    """Greedy edge coloring: split a flight into rounds with unique
    sources AND destinations (the ppermute / single-port constraint)."""
    pending = list(messages)
    rounds: List[List[Message]] = []
    while pending:
        used_src, used_dst = set(), set()
        this_round, rest = [], []
        for m in pending:
            if m.src not in used_src and m.dst not in used_dst:
                used_src.add(m.src)
                used_dst.add(m.dst)
                this_round.append(m)
            else:
                rest.append(m)
        rounds.append(this_round)
        pending = rest
    return rounds


def spec_of(frame: framing.Frame) -> PayloadSpec:
    """A netmodel-priceable spec for a frame's payload."""
    return PayloadSpec(sizes=frame.sizes, scheme="wire",
                       categories=tuple(classify(s) for s in frame.sizes))


class Transport(abc.ABC):
    """One flight in, delivery + timing out."""

    n_endpoints: int
    modeled: bool = False
    #: True when endpoint servers run python handlers on delivered frames
    #: (loopback/simulated); the collective transport is a pure SPMD
    #: datapath whose service semantics are echo/exchange.
    dispatches: bool = True

    @abc.abstractmethod
    def deliver(self, messages: Sequence[Message]) -> Delivery:
        ...

    def close(self) -> None:
        pass


def make_transport(kind: str, n_endpoints: int = None, *,
                   network=None, cluster=None, mesh=None, spec=None,
                   inner: "Transport" = None, **kw) -> Transport:
    """The one transport constructor call sites outside ``repro_torch.rpc``
    use (the CI deprecation gate rejects direct class construction
    elsewhere). Kinds:

      loopback    — make_transport("loopback", n)
      simulated   — make_transport("simulated", n, network=model|name)
      cluster     — make_transport("cluster",
                                   cluster=ClusterSpec|dict|json)
      collective  — make_transport("collective", n, mesh=mesh,
                                   spec=payload_spec, ...)
      fault       — make_transport("fault", inner=<any of the above>,
                                   seed=0, fault_rate=..., ...)
    """
    if kind == "fault":
        if not isinstance(inner, Transport):
            raise ValueError(
                "fault transport needs inner= (a Transport built by "
                f"make_transport); got {inner!r}")
        return FaultInjectionTransport(inner, **kw)
    if kind in ("loopback", "simulated") and n_endpoints is None:
        raise ValueError(f"{kind} transport needs n_endpoints")
    if kind == "loopback":
        return LoopbackTransport \
            (n_endpoints, **kw)  # split: see LoopbackTransport
    if kind == "simulated":
        if isinstance(network, str):
            from repro_torch.core.netmodel import NETWORKS
            if network not in NETWORKS:
                raise ValueError(f"unknown network {network!r}; choose "
                                 f"from {sorted(NETWORKS)}")
            network = NETWORKS[network]
        if not isinstance(network, NetworkModel):
            raise ValueError(
                "simulated transport needs network= (a NetworkModel or "
                "a name in core.netmodel.NETWORKS); got "
                f"{network!r}")
        return SimulatedTransport \
            (n_endpoints, network, **kw)  # split: see LoopbackTransport
    if kind == "cluster":
        from repro_torch.rpc.cluster import ClusterTransport, as_cluster_spec
        if cluster is None:
            raise ValueError("cluster transport needs cluster= (a "
                             "ClusterSpec, dict, or JSON string)")
        return ClusterTransport \
            (as_cluster_spec(cluster), **kw)  # split: see LoopbackTransport
    if kind == "collective":
        if mesh is None or spec is None:
            raise ValueError("collective transport needs mesh= and "
                             "spec= (a device mesh + PayloadSpec)")
        from repro_torch.rpc.collective import CollectiveTransport
        return CollectiveTransport \
            (mesh, spec, n_endpoints=n_endpoints or 0,
             **kw)  # split: see LoopbackTransport
    raise ValueError(f"unknown transport kind {kind!r}; choose from "
                     f"('loopback', 'simulated', 'cluster', "
                     f"'collective', 'fault')")


class FaultInjectionTransport(Transport):
    """Seeded fault-injection wrapper around any transport — the
    instrument the fault test tier drives the fabric with. Three fault
    families, each optionally restricted to a set of directed
    ``(src, dst)`` links and drawn from ONE seeded RNG, so a schedule
    is reproducible and independent of wall clock:

      fault_rate   per-message probability the message is lost to a
                   transient link fault: it is NOT delivered to the
                   inner transport; the fabric sees it flagged
                   ``FLAG_FAULT``, refunds its credits, and fails the
                   call with a retryable transient error.
      stall_rate   per-message probability of a *stalled stream*: the
                   message is delivered but the flight is charged an
                   extra ``stall_s`` (the modeled clock advances, or —
                   on measured transports — the wall clock actually
                   passes) — with deadline propagation the budget is
                   consumed on the wire, so the server sheds the call
                   on arrival and the client's deadline machinery
                   fires.
      latency_rate per-message probability of ``latency_s`` extra
                   flight latency (a degraded link, milder than a
                   stall).

    ``max_faults`` bounds faults + stalls injected over the transport's
    lifetime so every schedule eventually drains; the counters
    (``faults_injected``, ``stalls_injected``, ``extra_latency_s``)
    let tests assert the schedule actually fired. Unknown attributes
    (``clock_s``, ``resolve``, ``channel_windows``, ``cluster``, ...)
    delegate to the wrapped transport, so the wrapper is drop-in for
    loopback, simulated, and cluster fabrics alike.

    ``burst_windows`` adds *correlated* burst loss on top of the
    i.i.d. schedule: a list of ``(t_start, t_end)`` or
    ``(t_start, t_end, link)`` windows on the modeled clock during
    which every eligible message is lost (``link`` is a directed
    ``(src, dst)`` pair — names resolve through a cluster inner — or
    None for all links). Real outages cluster in time; the workload
    tier derives these windows from a trace's arrival bursts so fault
    schedules correlate with load instead of sampling independently
    per message. Windows need a modeled inner transport (the loss
    condition is a clock read) and do not draw from the RNG or count
    against ``max_faults`` — they are already time-bounded;
    ``burst_faults_injected`` counts them separately (they also bump
    ``faults_injected``, the total every lost message shares)."""

    def __init__(self, inner: Transport, *, seed: int = 0,
                 fault_rate: float = 0.0, stall_rate: float = 0.0,
                 latency_rate: float = 0.0, stall_s: float = 0.0,
                 latency_s: float = 0.0,
                 links: Optional[Iterable[Tuple[int, int]]] = None,
                 max_faults: Optional[int] = None,
                 burst_windows: Optional[Iterable[tuple]] = None):
        for rate in (fault_rate, stall_rate, latency_rate):
            assert 0.0 <= rate <= 1.0, rate
        assert fault_rate + stall_rate + latency_rate <= 1.0, \
            "fault families draw from one RNG sample; rates must sum <= 1"
        assert stall_s >= 0.0 and latency_s >= 0.0
        self.inner = inner
        self.seed = seed
        self.fault_rate = fault_rate
        self.stall_rate = stall_rate
        self.latency_rate = latency_rate
        self.stall_s = stall_s
        self.latency_s = latency_s
        self.links: Optional[Set[Tuple[int, int]]] = \
            set((int(s), int(d)) for s, d in links) \
            if links is not None else None
        self.max_faults = max_faults
        self.faults_injected = 0
        self.stalls_injected = 0
        self.burst_faults_injected = 0
        self.extra_latency_s = 0.0
        self._rng = np.random.default_rng(seed)
        self.burst_windows: List[Tuple[float, float,
                                       Optional[Tuple[int, int]]]] = []
        if burst_windows:
            assert inner.modeled and hasattr(inner, "clock_s"), \
                "burst_windows are defined on the modeled clock; the " \
                "inner transport must be modeled (simulated/cluster)"
            for w in burst_windows:
                t0, t1 = float(w[0]), float(w[1])
                assert t1 > t0, (t0, t1)
                link = w[2] if len(w) > 2 else None
                if link is not None:
                    s, d = link
                    if isinstance(s, str):
                        s = inner.resolve(s)
                    if isinstance(d, str):
                        d = inner.resolve(d)
                    link = (int(s), int(d))
                self.burst_windows.append((t0, t1, link))

    def _in_burst(self, m: Message) -> bool:
        if not self.burst_windows:
            return False
        t = self.inner.clock_s
        return any(t0 <= t < t1
                   and (link is None or (m.src, m.dst) == link)
                   for t0, t1, link in self.burst_windows)

    # the wrapped transport's identity -----------------------------------
    @property
    def n_endpoints(self) -> int:
        return self.inner.n_endpoints

    @property
    def modeled(self) -> bool:
        return self.inner.modeled

    @property
    def dispatches(self) -> bool:
        return self.inner.dispatches

    @property
    def clock_s(self) -> float:
        return self.inner.clock_s     # AttributeError when inner has none

    @clock_s.setter
    def clock_s(self, value: float) -> None:
        self.inner.clock_s = value

    def __getattr__(self, name: str):
        # optional transport hooks (resolve, endpoint_name,
        # channel_windows, cluster, network, ...) pass through
        if name == "inner":       # pre-__init__ probes must not recurse
            raise AttributeError(name)
        return getattr(self.inner, name)

    # the schedule -------------------------------------------------------
    def _eligible(self, m: Message) -> bool:
        return self.links is None or (m.src, m.dst) in self.links

    def _budget_left(self) -> bool:
        return self.max_faults is None or \
            (self.faults_injected + self.stalls_injected) < self.max_faults

    def deliver(self, messages: Sequence[Message]) -> Delivery:
        faulted: List[Message] = []
        through: List[Message] = []
        extra = 0.0
        for m in messages:
            if self._in_burst(m):
                self.burst_faults_injected += 1
                self.faults_injected += 1
                faulted.append(replace(
                    m, frame=replace(m.frame,
                                     flags=m.frame.flags
                                     | framing.FLAG_FAULT)))
                continue
            draw = (self._rng.random()
                    if self._eligible(m) and self._budget_left()
                    else 1.0)
            if draw < self.fault_rate:
                self.faults_injected += 1
                faulted.append(replace(
                    m, frame=replace(m.frame,
                                     flags=m.frame.flags
                                     | framing.FLAG_FAULT)))
                continue
            if draw < self.fault_rate + self.stall_rate:
                self.stalls_injected += 1
                extra += self.stall_s
            elif draw < (self.fault_rate + self.stall_rate
                         + self.latency_rate):
                extra += self.latency_s
            through.append(m)
        d = self.inner.deliver(through)
        if extra > 0.0:
            self.extra_latency_s += extra
            if self.inner.modeled and hasattr(self.inner, "clock_s"):
                self.inner.clock_s += extra
            else:
                # measured transports live on the wall clock: the stall
                # must actually pass for deadline propagation (server
                # shedding) and client-side expiry to see it
                time.sleep(extra)
        # faulted messages FIRST: the fabric must see a call's fault
        # before any same-flight stragglers of that call — a stream's
        # END outrunning its faulted middle chunk would complete the
        # stream with a silently missing chunk
        return Delivery(faulted + list(d.messages),
                        d.elapsed_s + extra, d.rounds, d.modeled)

    def close(self) -> None:
        self.inner.close()


# split across two lines: the grep gates of tests/test_service_api.py
# exempt only src/repro/rpc/ from flagging LoopbackTransport before a
# parenthesis
class LoopbackTransport \
        (Transport):
    """Shared-buffer transport: every endpoint lives in this process and
    owns an inbox list; delivery encodes each frame to wire bytes and
    copies them into the destination inbox. The encode+memcpy is exactly
    the serialized/non-serialized trade measured on one host."""

    def __init__(self, n_endpoints: int, *, backend: str = "numpy",
                 inbox_depth: int = 8):
        assert n_endpoints >= 1
        self.n_endpoints = n_endpoints
        self.backend = backend
        # bounded: retains only the last few wire messages per endpoint
        # for inspection — benchmark loops would otherwise accumulate
        # every payload copy ever delivered
        self.inboxes: List[Deque[List[np.ndarray]]] = [
            deque(maxlen=inbox_depth) for _ in range(n_endpoints)]

    def deliver(self, messages: Sequence[Message]) -> Delivery:
        rounds = schedule_rounds(messages)
        out: List[Message] = []
        t0 = time.perf_counter()
        for rnd in rounds:
            for m in rnd:
                assert 0 <= m.dst < self.n_endpoints, m.dst
                wire = framing.encode(m.frame, backend=self.backend)
                copied = [np.array(w, copy=True) for w in wire]
                self.inboxes[m.dst].append(copied)
                out.append(Message(m.src, m.dst,
                                   framing.decode(copied,
                                                  backend=self.backend)))
        elapsed = time.perf_counter() - t0
        return Delivery(out, elapsed, len(rounds), modeled=False)


# split across two lines: the grep gates of tests/test_service_api.py
# exempt only src/repro/rpc/ from flagging SimulatedTransport before a
# parenthesis
class SimulatedTransport \
        (Transport):
    """Analytic transport over a ``NetworkModel``.

    Per flight, each receiver serializes its incoming messages on its
    NIC/stack (sum of per-message times) and pays the quadratic host
    CPU-copy contention term when several messages land on one endpoint
    — the same receiver-bound model ``netmodel.ps_round_time`` uses, so
    a simulated PS pattern reproduces the paper's throughput ratios.
    Each *sender* additionally serializes its outgoing bytes on its own
    NIC (the egress term): a flight's elapsed time is the max over
    endpoints of ingress + copy contention + egress. Egress is what
    makes the fan-OUT half of an incast contend — one server streaming
    fetch responses to N workers is limited by its own egress pump,
    not by any single receiver. Matches ``netmodel.fc_round_time`` /
    ``ring_round_time`` / ``incast_round_time`` exactly.
    Frames may be spec-only; nothing is allocated or copied.
    """

    modeled = True

    def __init__(self, n_endpoints: int, network: NetworkModel):
        assert n_endpoints >= 1
        self.n_endpoints = n_endpoints
        self.network = network
        self.clock_s = 0.0

    def price(self, frame: framing.Frame) -> float:
        """One message's cost at the receiver: payload + 64B ack."""
        return (self.network.payload_time(spec_of(frame),
                                          mode=frame.wire_mode)
                + self.network.msg_time(64))

    def egress_price(self, frame: framing.Frame) -> float:
        """One message's cost at the sender: pumping the bytes onto the
        wire (alpha and the RPC software overhead are receiver-side)."""
        return frame.total_bytes / self.network.beta_Bps

    def deliver(self, messages: Sequence[Message]) -> Delivery:
        # one accumulator dict per endpoint ([ingress, count, bytes,
        # egress] rows) instead of four — flush-loop hot path, the
        # four-dict version paid 4 hash probes + .get churn per message
        acc: Dict[int, list] = {}
        n_end = self.n_endpoints
        net = self.network
        beta = net.beta_Bps
        ack = net.msg_time(64)
        ptime = net._payload_time_raw
        for m in messages:
            assert 0 <= m.dst < n_end, m.dst
            assert 0 <= m.src < n_end, m.src
            frame = m.frame
            row = acc.get(m.dst)
            if row is None:
                row = acc[m.dst] = [0.0, 0, 0, 0.0]
            sizes = frame.sizes
            nbytes = int(sum(sizes))
            # == self.price(frame), with the spec_of construction and
            # the constant 64B-ack term hoisted out of the hot loop
            row[0] += ptime(nbytes, len(sizes), frame.wire_mode) + ack
            row[1] += 1
            row[2] += nbytes
            row = acc.get(m.src)
            if row is None:
                row = acc[m.src] = [0.0, 0, 0, 0.0]
            row[3] += nbytes / beta
        elapsed = 0.0
        cpu_copy = self.network.cpu_copy_Bps
        for ingress, k, nbytes, egress in acc.values():
            t = ingress
            if k > 1:
                # == k * (k - 1) * avg_bytes / cpu_copy, avg = nbytes/k,
                # but as one exact integer product before the division
                t += (k - 1) * nbytes / cpu_copy
            t += egress
            if t > elapsed:
                elapsed = t
        self.clock_s += elapsed
        rounds = schedule_rounds(messages)
        return Delivery(list(messages), elapsed, len(rounds), modeled=True)
