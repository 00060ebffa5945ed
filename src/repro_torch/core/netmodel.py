"""Alpha-beta network models (latency-bandwidth) for the interconnects
the paper evaluates, plus the TPU fabrics this framework targets.

The container has no IB/RoCE NICs (and no TPU), so absolute wall-clock
numbers for the paper's clusters come from these models; the paper's
*measured ratios* (its headline claims) are the calibration targets:

  fig8  (A, skew,   latency):    RDMA -59% vs 40GbE, -56% vs IPoIB-EDR
  fig9  (B, skew,   latency):    RDMA -78% vs 10GbE, -69% vs IPoIB-FDR,
                                 IPoIB-FDR -27% vs 10GbE
  fig11 (A, skew,   bandwidth):  RDMA 2.14x IPoIB-EDR
  fig12 (B, skew,   bandwidth):  RDMA 3.2x  IPoIB-FDR
  fig13 (A, uniform,throughput): RDMA 4.1x 40GbE, 3.43x IPoIB-EDR
  fig14 (B, uniform,throughput): RDMA 5.9x 10GbE

Constants below were fitted offline (benchmarks/calibrate.py) to land
within ~12% of every ratio simultaneously; tests/test_netmodel.py holds
that tolerance. Message cost: t = alpha + bytes/beta per message, plus a
per-RPC processing overhead on the receiver (rpc_overhead) — the gRPC
core cost the paper isolates.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

from repro_torch.core.payload import PayloadSpec

#: the three wire modes, in paper order (Ethernet/IPoIB/RDMA analogue).
#: Must equal repro_torch.rpc.framing.WIRE_MODES (pinned by tests) — defined
#: here too so the model layer never imports the rpc fabric.
WIRE_MODES = ("serialized", "scatter_gather", "zero_copy")


#: bytes of the little-endian int64 source tag prepended to every
#: reduce-scatter/allgather message (rsag needs source attribution for
#: a deterministic summation order; ring/tree infer it from topology)
ALLREDUCE_TAG_BYTES = 8

#: the allreduce algorithms, CLI order (``bench_comm --algo``)
ALLREDUCE_ALGOS = ("ring", "tree", "rsag")


def allreduce_chunk_sizes(total_bytes: int, n_workers: int, *,
                          itemsize: int = 1) -> Tuple[int, ...]:
    """Balanced contiguous partition of a ``total_bytes`` gradient into
    ``n_workers`` chunks on element (``itemsize``) boundaries: the first
    ``elems % n`` chunks get one extra element. Shared by the collective
    drivers and the closed forms below — exactness by construction."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    if itemsize < 1:
        raise ValueError(f"itemsize must be >= 1, got {itemsize}")
    if total_bytes < 0 or total_bytes % itemsize:
        raise ValueError(
            f"total_bytes ({total_bytes}) must be a non-negative "
            f"multiple of itemsize ({itemsize})")
    elems = total_bytes // itemsize
    base, rem = divmod(elems, n_workers)
    return tuple((base + (1 if c < rem else 0)) * itemsize
                 for c in range(n_workers))


def ring_allreduce_send_chunk(worker: int, step: int, n_workers: int
                              ) -> int:
    """The chunk index worker ``worker`` sends to its successor at ring
    step ``step``: steps ``0..n-2`` are the reduce-scatter rotation
    (chunk ``(i - s) % n``), steps ``n-1..2n-3`` the allgather rotation
    of the fully reduced chunks (chunk ``(i + 1 - t) % n``)."""
    n = n_workers
    if not 0 <= step < 2 * (n - 1):
        raise ValueError(f"step {step} outside ring schedule "
                         f"0..{2 * (n - 1) - 1}")
    if step < n - 1:
        return (worker - step) % n
    return (worker + 1 - (step - (n - 1))) % n


def tree_reduce_rounds(n_workers: int
                       ) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Binomial-tree reduce schedule: ``ceil(log2 n)`` rounds of
    disjoint (sender, receiver) pairs; round ``r`` pairs ``i + 2^r ->
    i`` for every ``i`` divisible by ``2^(r+1)`` with the sender in
    range. The broadcast half replays these rounds reversed with the
    pairs flipped."""
    rounds = []
    r = 1
    while r < n_workers:
        rounds.append(tuple((i + r, i) for i in range(0, n_workers, 2 * r)
                            if i + r < n_workers))
        r *= 2
    return tuple(rounds)


def resolve_wire_mode(serialized: bool = False,
                      mode: "str | None" = None) -> str:
    """Resolve the (legacy ``serialized`` bool, explicit ``mode``) pair
    every closed form accepts: an explicit mode wins, else the bool
    picks serialized vs scatter-gather."""
    if mode is None:
        return "serialized" if serialized else "scatter_gather"
    if mode not in WIRE_MODES:
        raise ValueError(f"unknown wire mode {mode!r}; "
                         f"expected one of {WIRE_MODES}")
    return mode


@dataclass(frozen=True)
class NetworkModel:
    name: str
    alpha_s: float          # per-message latency (s)
    beta_Bps: float         # effective bandwidth (bytes/s)
    rpc_overhead_s: float   # per-RPC software (gRPC core) overhead (s)
    # host-CPU copy rate for the RPC data path. Kernel-TCP networks copy
    # every byte through the host (and contend when several workers hit
    # one PS); RDMA is zero-copy => effectively infinite rate. This term
    # is what lets one parameter set reproduce BOTH the ~2.4x latency gap
    # and the ~4x PS-throughput gap the paper measures.
    cpu_copy_Bps: float = float("inf")
    serialization_Bps: float = 1.2e9  # protobuf pack rate (CPU-bound)
    # zero-copy mode: one-time registration (pinning) cost of a shared
    # buffer-pool region, amortized over its steady-state reuse — the
    # only copy-path cost a one-sided write pays per transfer
    registration_s: float = 3e-4
    pool_reuse: int = 64

    # ------------------------------------------------------------------
    def msg_time(self, nbytes: int) -> float:
        return self.alpha_s + nbytes / self.beta_Bps

    def copy_cost(self, spec: PayloadSpec, mode: str) -> float:
        """The per-mode copy-path cost of one payload transfer, on top
        of the shared wire term (alpha + bytes/beta + rpc overhead):

        serialized      pack+unpack: every byte through the protobuf
                        serializer at ``serialization_Bps``.
        scatter_gather  per-iovec fixed cost: one extra alpha per
                        4-buffer sendmsg/recvmsg batch beyond the first
                        (measured iovec-batching behaviour).
        zero_copy       registration only: the region pin cost
                        amortized over ``pool_reuse`` placements —
                        steady-state transfers touch no copy path.
        """
        if mode == "serialized":
            return spec.total_bytes / self.serialization_Bps
        if mode == "scatter_gather":
            n_batches = max(1, -(-spec.n_buffers // 4))
            return self.alpha_s * (n_batches - 1)
        if mode == "zero_copy":
            return self.registration_s / self.pool_reuse
        raise ValueError(f"unknown wire mode {mode!r}; "
                         f"expected one of {WIRE_MODES}")

    def _payload_time_raw(self, total_bytes: int, n_buffers: int,
                          mode: str) -> float:
        """:meth:`payload_time` on raw (total, n_buffers, mode) args —
        the transport flush-loop hot path prices every message through
        this, skipping PayloadSpec construction. Must stay arithmetic-
        identical to msg_time + rpc_overhead + copy_cost (the closed
        forms match the simulated transport bit-for-bit)."""
        base = (self.alpha_s + total_bytes / self.beta_Bps
                + self.rpc_overhead_s)
        if mode == "scatter_gather":
            n_batches = max(1, -(-n_buffers // 4))
            return base + self.alpha_s * (n_batches - 1)
        if mode == "serialized":
            return base + total_bytes / self.serialization_Bps
        if mode == "zero_copy":
            return base + self.registration_s / self.pool_reuse
        raise ValueError(f"unknown wire mode {mode!r}; "
                         f"expected one of {WIRE_MODES}")

    def payload_time(self, spec: PayloadSpec, *, serialized: bool = False,
                     mode: "str | None" = None) -> float:
        """One-way transfer time of one payload: the shared wire term
        (one alpha + bytes/beta + rpc overhead) plus the per-mode
        :meth:`copy_cost`. ``mode`` (a :data:`WIRE_MODES` name) wins
        over the legacy ``serialized`` bool."""
        mode = resolve_wire_mode(serialized, mode)
        return self._payload_time_raw(spec.total_bytes, spec.n_buffers,
                                      mode)

    def rtt(self, spec: PayloadSpec, *, serialized: bool = False,
            mode: "str | None" = None) -> float:
        """Echo RTT (paper's P2P latency benchmark: payload both ways)."""
        return 2.0 * self.payload_time(spec, serialized=serialized,
                                       mode=mode)

    def bandwidth(self, spec: PayloadSpec, *, serialized: bool = False,
                  mode: "str | None" = None) -> float:
        """MB/s of the one-way bandwidth benchmark (payload + tiny ack)."""
        t = self.payload_time(spec, serialized=serialized, mode=mode) \
            + self.msg_time(64)
        return spec.total_bytes / t / 1e6

    def ps_round_time(self, spec: PayloadSpec, n_ps: int, n_workers: int,
                      *, serialized: bool = False,
                      mode: "str | None" = None) -> float:
        """One PS round: every worker pushes its update to every PS and
        gets the ack/fetch back. PS ingress is the bottleneck: each PS
        serves n_workers RPCs; PSes work in parallel; per-PS RPCs
        serialize on its NIC/stack, and their host-side copies contend
        on the PS CPU (quadratic queueing term; zero for RDMA)."""
        per_rpc = (self.payload_time(spec, serialized=serialized,
                                     mode=mode)
                   + self.msg_time(64))
        contention = (n_workers * (n_workers - 1)
                      * spec.total_bytes / self.cpu_copy_Bps)
        return per_rpc * n_workers + contention

    def ps_throughput(self, spec: PayloadSpec, n_ps: int, n_workers: int,
                      *, serialized: bool = False,
                      mode: "str | None" = None) -> float:
        """Aggregate RPCs/s (paper fig 13/14)."""
        rpcs = n_ps * n_workers
        return rpcs / self.ps_round_time(spec, n_ps, n_workers,
                                         serialized=serialized, mode=mode)

    def egress_time(self, spec: PayloadSpec) -> float:
        """Sender-side cost of pumping one payload onto the wire (alpha
        and the RPC software overhead are charged at the receiver)."""
        return spec.total_bytes / self.beta_Bps

    def fc_round_time(self, spec: PayloadSpec, n_workers: int, *,
                      serialized: bool = False,
                      mode: "str | None" = None) -> float:
        """One fully-connected exchange: every endpoint sends the
        payload to every other (n*(n-1) RPCs). Receiver-bound like the
        PS round — each endpoint ingests n-1 RPCs serially on its
        NIC/stack, with the same quadratic host-copy contention term
        (zero for RDMA) — plus the endpoint's own n-1 payload egress.
        Matches rpc.SimulatedTransport pricing."""
        per_rpc = (self.payload_time(spec, serialized=serialized,
                                     mode=mode)
                   + self.msg_time(64))
        contention = ((n_workers - 1) * (n_workers - 2)
                      * spec.total_bytes / self.cpu_copy_Bps)
        egress = (n_workers - 1) * self.egress_time(spec)
        return per_rpc * (n_workers - 1) + contention + egress

    def fc_throughput(self, spec: PayloadSpec, n_workers: int, *,
                      serialized: bool = False,
                      mode: "str | None" = None) -> float:
        """Aggregate RPCs/s of the fully-connected exchange."""
        rpcs = n_workers * (n_workers - 1)
        return rpcs / self.fc_round_time(spec, n_workers,
                                         serialized=serialized, mode=mode)

    def ring_round_time(self, spec: PayloadSpec, n_workers: int, *,
                        n_chunks: int = 1,
                        serialized: bool = False,
                        mode: "str | None" = None) -> float:
        """One chunked ring pass: every worker streams n_chunks payload
        chunks to its successor, all workers concurrently. Each node
        ingests n_chunks messages from its predecessor (serial on its
        NIC/stack, quadratic host-copy contention among them) while
        pumping its own n_chunks chunks out — so ring time is
        independent of the worker count, the signature of the pattern.
        Matches rpc.SimulatedTransport pricing of rpc.ring_exchange
        exactly (one flight, chunk-major)."""
        del n_workers  # rings pipeline perfectly; kept for API symmetry
        per_rpc = (self.payload_time(spec, serialized=serialized,
                                     mode=mode)
                   + self.msg_time(64))
        contention = (n_chunks * (n_chunks - 1)
                      * spec.total_bytes / self.cpu_copy_Bps)
        egress = n_chunks * self.egress_time(spec)
        return per_rpc * n_chunks + contention + egress

    def ring_throughput(self, spec: PayloadSpec, n_workers: int, *,
                        n_chunks: int = 1,
                        serialized: bool = False,
                        mode: "str | None" = None) -> float:
        """Aggregate chunk-RPCs/s of the ring pass."""
        rpcs = n_workers * n_chunks
        return rpcs / self.ring_round_time(spec, n_workers,
                                           n_chunks=n_chunks,
                                           serialized=serialized,
                                           mode=mode)

    def incast_round_time(self, spec: PayloadSpec, n_workers: int, *,
                          n_chunks: int = 1,
                          serialized: bool = False,
                          mode: "str | None" = None,
                          fetch_ratio: float = 1.0) -> float:
        """The Cori-style PS hotspot: n_workers stream n_chunks payload
        chunks each into ONE server, which answers every stream with a
        fetch response sized ``fetch_ratio`` times the push payload
        (1.0 = symmetric; <1 a small variable pull against a large
        gradient push; >1 a fetch-heavy read). Push half: the server
        ingests n_workers * n_chunks messages serially with quadratic
        host-copy contention (the classic incast cliff). Fetch half:
        the server's own egress pump (n_workers * n_chunks fetch
        payloads out) races each worker's ingress of its n_chunks
        responses — without the egress term the fan-out half would be
        free no matter how many workers hang off the server. Matches
        rpc.SimulatedTransport pricing of rpc.incast_exchange exactly
        (push flight + fetch flight, asymmetric fetch sizes
        included)."""
        from repro_torch.core.payload import classify, scale_sizes
        per_rpc = (self.payload_time(spec, serialized=serialized,
                                     mode=mode)
                   + self.msg_time(64))
        k = n_workers * n_chunks
        push = (per_rpc * k
                + k * (k - 1) * spec.total_bytes / self.cpu_copy_Bps)
        if fetch_ratio == 1.0:
            fspec = spec
        else:
            fsizes = tuple(scale_sizes(spec.sizes, fetch_ratio))
            fspec = PayloadSpec(sizes=fsizes, scheme=spec.scheme,
                                categories=tuple(classify(s)
                                                 for s in fsizes))
        per_fetch_rpc = (self.payload_time(fspec, serialized=serialized,
                                           mode=mode)
                         + self.msg_time(64))
        per_worker_fetch = (per_fetch_rpc * n_chunks
                            + n_chunks * (n_chunks - 1)
                            * fspec.total_bytes / self.cpu_copy_Bps)
        fetch = max(k * self.egress_time(fspec), per_worker_fetch)
        return push + fetch

    def with_link(self, *, bandwidth_Bps: float = None,
                  latency_s: float = None) -> "NetworkModel":
        """This model with per-link bandwidth/latency overrides — the
        resolved model of one directed cluster link. Only alpha/beta
        change; the host-side rates (cpu_copy, serialization, rpc
        overhead) stay the endpoint's own, which is what lets the
        per-link closed form below split contention into a link term
        and a cross-link host term without double counting."""
        if bandwidth_Bps is None and latency_s is None:
            return self
        return dataclasses.replace(
            self, name=f"{self.name}+link",
            beta_Bps=(bandwidth_Bps if bandwidth_Bps is not None
                      else self.beta_Bps),
            alpha_s=(latency_s if latency_s is not None
                     else self.alpha_s))

    def incast_throughput(self, spec: PayloadSpec, n_workers: int, *,
                          n_chunks: int = 1,
                          serialized: bool = False,
                          mode: "str | None" = None,
                          fetch_ratio: float = 1.0) -> float:
        """Aggregate pushed chunk-RPCs/s of the incast round."""
        rpcs = n_workers * n_chunks
        return rpcs / self.incast_round_time(spec, n_workers,
                                             n_chunks=n_chunks,
                                             serialized=serialized,
                                             mode=mode,
                                             fetch_ratio=fetch_ratio)

    # -- allreduce collectives (rpc.collectives drives these flights) --
    def _flight_elapsed(self, msgs, mode: str) -> float:
        """Elapsed time of one flight of ``(src, dst, sizes)`` messages
        — the exact accumulator arithmetic of
        ``rpc.SimulatedTransport.deliver`` (same per-endpoint rows,
        same accumulation order), so a closed form built on per-step
        message lists matches the transport bit-for-bit."""
        acc: Dict[int, list] = {}
        beta = self.beta_Bps
        ack = self.msg_time(64)
        for src, dst, sizes in msgs:
            row = acc.get(dst)
            if row is None:
                row = acc[dst] = [0.0, 0, 0, 0.0]
            nbytes = int(sum(sizes))
            row[0] += self._payload_time_raw(nbytes, len(sizes),
                                             mode) + ack
            row[1] += 1
            row[2] += nbytes
            row = acc.get(src)
            if row is None:
                row = acc[src] = [0.0, 0, 0, 0.0]
            row[3] += nbytes / beta
        elapsed = 0.0
        cpu_copy = self.cpu_copy_Bps
        for ingress, k, nbytes, egress in acc.values():
            t = ingress
            if k > 1:
                t += (k - 1) * nbytes / cpu_copy
            t += egress
            if t > elapsed:
                elapsed = t
        return elapsed

    def ring_allreduce_time(self, total_bytes: int, n_workers: int, *,
                            itemsize: int = 1, serialized: bool = False,
                            mode: "str | None" = None) -> float:
        """Ring allreduce of a ``total_bytes`` gradient across
        ``n_workers``: 2(n-1) rotation steps (reduce-scatter then
        allgather), each one flight in which every worker sends one
        balanced chunk to its successor. Per step every endpoint
        ingests exactly one chunk (no contention term) while pumping
        its own chunk out. Matches rpc.collectives.ring_allreduce on
        the simulated transport exactly."""
        n = n_workers
        if n < 2:
            return 0.0
        mode = resolve_wire_mode(serialized, mode)
        chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
        total = 0.0
        for step in range(2 * (n - 1)):
            msgs = [(i, (i + 1) % n,
                     (chunks[ring_allreduce_send_chunk(i, step, n)],))
                    for i in range(n)]
            total += self._flight_elapsed(msgs, mode)
        return total

    def tree_allreduce_time(self, total_bytes: int, n_workers: int, *,
                            serialized: bool = False,
                            mode: "str | None" = None) -> float:
        """Binomial-tree allreduce: ``ceil(log2 n)`` reduce rounds
        (each a flight of disjoint full-payload pair sends toward
        worker 0) mirrored by the broadcast rounds back out. Latency-
        optimal at small payloads — 2 log n full-payload hops versus
        the ring's 2(n-1) chunk hops. Matches
        rpc.collectives.tree_allreduce on the simulated transport
        exactly."""
        if n_workers < 2:
            return 0.0
        mode = resolve_wire_mode(serialized, mode)
        rounds = tree_reduce_rounds(n_workers)
        sizes = (int(total_bytes),)
        total = 0.0
        for pairs in rounds:
            total += self._flight_elapsed(
                [(s, d, sizes) for s, d in pairs], mode)
        for pairs in reversed(rounds):
            total += self._flight_elapsed(
                [(d, s, sizes) for s, d in pairs], mode)
        return total

    def rsag_allreduce_time(self, total_bytes: int, n_workers: int, *,
                            itemsize: int = 1, serialized: bool = False,
                            mode: "str | None" = None) -> float:
        """Reduce-scatter + allgather in two all-to-all flights: every
        worker first sends chunk j (plus the int64 source tag) to
        worker j, which ingests n-1 tagged chunks — the quadratic
        host-copy contention the one-shot exchange pays and the ring
        amortizes — then every worker broadcasts its reduced chunk.
        Matches rpc.collectives.rsag_allreduce on the simulated
        transport exactly."""
        n = n_workers
        if n < 2:
            return 0.0
        mode = resolve_wire_mode(serialized, mode)
        chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
        tag = ALLREDUCE_TAG_BYTES
        scatter = [(i, j, (tag, chunks[j]))
                   for i in range(n) for j in range(n) if j != i]
        gather = [(j, i, (tag, chunks[j]))
                  for j in range(n) for i in range(n) if i != j]
        return (self._flight_elapsed(scatter, mode)
                + self._flight_elapsed(gather, mode))

    def allreduce_time(self, algo: str, total_bytes: int,
                       n_workers: int, *, itemsize: int = 1,
                       serialized: bool = False,
                       mode: "str | None" = None) -> float:
        """Dispatch on the :data:`ALLREDUCE_ALGOS` name."""
        if algo == "ring":
            return self.ring_allreduce_time(
                total_bytes, n_workers, itemsize=itemsize,
                serialized=serialized, mode=mode)
        if algo == "tree":
            return self.tree_allreduce_time(
                total_bytes, n_workers, serialized=serialized, mode=mode)
        if algo == "rsag":
            return self.rsag_allreduce_time(
                total_bytes, n_workers, itemsize=itemsize,
                serialized=serialized, mode=mode)
        raise ValueError(f"unknown allreduce algo {algo!r}; "
                         f"expected one of {ALLREDUCE_ALGOS}")

    def allreduce_throughput(self, algo: str, total_bytes: int,
                             n_workers: int, *, itemsize: int = 1,
                             serialized: bool = False,
                             mode: "str | None" = None) -> float:
        """Algorithm bandwidth (reduced bytes/s): ``total_bytes`` over
        the closed-form allreduce time."""
        t = self.allreduce_time(algo, total_bytes, n_workers,
                                itemsize=itemsize, serialized=serialized,
                                mode=mode)
        return total_bytes / t if t > 0 else float("inf")


# ---------------------------------------------------------------------------
# per-link closed form (the cluster-transport analytic counterpart)
# ---------------------------------------------------------------------------
#
# A multi-endpoint cluster prices one *flight* per directed link: the
# messages riding link (src -> dst) serialize on that link's resolved
# model (the dst endpoint's base network with per-link bandwidth/latency
# overrides). Contention splits into two quadratic host-copy terms that
# together recover exactly the single-NIC receiver term of
# ``SimulatedTransport`` when every link into an endpoint shares the
# endpoint's base parameters:
#
#   per-link    k_l (k_l - 1) * avg_l / copy      (messages sharing one
#                                                  link's stack queue)
#   cross-link  [K (K-1) - sum_l k_l (k_l - 1)]   (copies from different
#               * avg / copy                       links contending on
#                                                  the one host CPU)
#
# with K the total cross-endpoint messages into the endpoint. Same-
# endpoint (src == dst) messages are loopback: one host memcpy at the
# cpu_copy rate — no alpha, no rpc overhead, no egress, which is what
# keeps local calls loopback-fast in a cluster-routed flight.
# ``repro_torch.rpc.cluster.ClusterTransport`` must match this closed form
# exactly (held by tests/test_cluster_transport.py).

@dataclass(frozen=True)
class LinkLoad:
    """The messages one flight puts on one directed (src, dst) link.

    ``model`` is the link's *resolved* NetworkModel (dst endpoint base +
    per-link overrides); host-side rates in it are the dst endpoint's
    own. ``serialized``/``mode`` apply to every message of the load —
    split a link's messages into separate loads when modes mix. An
    explicit ``mode`` (a :data:`WIRE_MODES` name) wins over the legacy
    ``serialized`` bool."""
    src: int
    dst: int
    model: NetworkModel
    specs: Tuple[PayloadSpec, ...]
    serialized: bool = False
    mode: "str | None" = None

    @property
    def n_msgs(self) -> int:
        return len(self.specs)

    @property
    def total_bytes(self) -> int:
        return int(sum(s.total_bytes for s in self.specs))


def link_time(load: LinkLoad) -> float:
    """Receiver-side serialization of one link's messages (payload +
    64B ack each) on the link's resolved model."""
    return sum(load.model.payload_time(s, serialized=load.serialized,
                                       mode=load.mode)
               + load.model.msg_time(64) for s in load.specs)


def link_contention(load: LinkLoad) -> float:
    """The per-link quadratic host-copy term: k messages riding one
    link in one flight queue on that link's receiving stack."""
    k = load.n_msgs
    if k < 2:
        return 0.0
    return k * (k - 1) * (load.total_bytes / k) / load.model.cpu_copy_Bps


def cluster_flight_time(loads: Sequence[LinkLoad]) -> float:
    """Closed-form elapsed time of one cluster flight: per endpoint,
    ingress (link serialization + per-link contention + cross-link host
    contention + local memcpys) plus its own egress; the flight takes
    the max over endpoints."""
    ingress: Dict[int, float] = {}
    egress: Dict[int, float] = {}
    cross: Dict[int, list] = {}
    for ld in loads:
        if ld.src == ld.dst:
            # loopback-fast: host memcpy only
            ingress[ld.dst] = (ingress.get(ld.dst, 0.0)
                               + ld.total_bytes / ld.model.cpu_copy_Bps)
            continue
        ingress[ld.dst] = (ingress.get(ld.dst, 0.0)
                           + link_time(ld) + link_contention(ld))
        egress[ld.src] = (egress.get(ld.src, 0.0)
                          + ld.total_bytes / ld.model.beta_Bps)
        cross.setdefault(ld.dst, []).append(ld)
    for dst, lds in cross.items():
        k_tot = sum(ld.n_msgs for ld in lds)
        if k_tot < 2:
            continue
        pairs = (k_tot * (k_tot - 1)
                 - sum(ld.n_msgs * (ld.n_msgs - 1) for ld in lds))
        if pairs <= 0:
            continue
        bytes_tot = sum(ld.total_bytes for ld in lds)
        # host-side copy rate: identical across the endpoint's links
        # (with_link never overrides it), so any load's model serves
        ingress[dst] += (pairs * (bytes_tot / k_tot)
                         / lds[0].model.cpu_copy_Bps)
    return max((ingress.get(e, 0.0) + egress.get(e, 0.0)
                for e in set(ingress) | set(egress)), default=0.0)


# fitted constants (benchmarks/calibrate.py; cluster A max err 2.7%,
# cluster B max err 0.8% across the paper's claims)
NETWORKS: Dict[str, NetworkModel] = {
    # Cluster A (RI2): 40GbE, IPoIB over EDR(100G), RDMA-EDR
    "eth40g":    NetworkModel("eth40g", alpha_s=4.16e-05,
                              beta_Bps=4.705e+09, rpc_overhead_s=9.49e-05,
                              cpu_copy_Bps=9.69e+09),
    "ipoib_edr": NetworkModel("ipoib_edr", alpha_s=1.39e-05,
                              beta_Bps=4.889e+09, rpc_overhead_s=1.55e-04,
                              cpu_copy_Bps=1.27e+10),
    "rdma_edr":  NetworkModel("rdma_edr", alpha_s=1.86e-05,
                              beta_Bps=1.084e+10, rpc_overhead_s=2.69e-05),
    # Cluster B (Comet): 10GbE, IPoIB over FDR(56G), RDMA-FDR
    "eth10g":    NetworkModel("eth10g", alpha_s=5.68e-05,
                              beta_Bps=1.072e+09, rpc_overhead_s=1.35e-04,
                              cpu_copy_Bps=6.21e+09),
    "ipoib_fdr": NetworkModel("ipoib_fdr", alpha_s=3.86e-05,
                              beta_Bps=1.481e+09, rpc_overhead_s=1.34e-04,
                              cpu_copy_Bps=7.57e+09),
    "rdma_fdr":  NetworkModel("rdma_fdr", alpha_s=9.17e-06,
                              beta_Bps=4.619e+09, rpc_overhead_s=9.71e-06),
    # TPU fabrics (v5e targets for this framework)
    "tpu_ici":   NetworkModel("tpu_ici",   alpha_s=1e-6,  beta_Bps=5.0e10,
                              rpc_overhead_s=0.0, serialization_Bps=8e11),
    "tpu_dcn":   NetworkModel("tpu_dcn",   alpha_s=25e-6, beta_Bps=6.25e9,
                              rpc_overhead_s=0.0, serialization_Bps=8e11),
}

CLUSTER_A = ("eth40g", "ipoib_edr", "rdma_edr")
CLUSTER_B = ("eth10g", "ipoib_fdr", "rdma_fdr")


def paper_ratio_report() -> Dict[str, Dict[str, float]]:
    """Model-predicted values for every paper claim, with targets."""
    from repro_torch.configs.tfgrpc_bench import BenchConfig
    from repro_torch.core.payload import generate_spec

    skew = generate_spec(BenchConfig(scheme="skew"))
    uni = generate_spec(BenchConfig(scheme="uniform"))
    n = NETWORKS

    def red(a, b):  # latency reduction of a vs b
        return 1.0 - n[a].rtt(skew) / n[b].rtt(skew)

    out = {
        "fig8_rdma_vs_eth40g":  {"target": 0.59, "model": red("rdma_edr", "eth40g")},
        "fig8_rdma_vs_ipoib":   {"target": 0.56, "model": red("rdma_edr", "ipoib_edr")},
        "fig9_rdma_vs_eth10g":  {"target": 0.78, "model": 1 - n["rdma_fdr"].rtt(skew) / n["eth10g"].rtt(skew)},
        "fig9_rdma_vs_ipoib":   {"target": 0.69, "model": 1 - n["rdma_fdr"].rtt(skew) / n["ipoib_fdr"].rtt(skew)},
        "fig9_ipoib_vs_eth10g": {"target": 0.27, "model": 1 - n["ipoib_fdr"].rtt(skew) / n["eth10g"].rtt(skew)},
        "fig11_bw_rdma_x_ipoib": {"target": 2.14, "model": n["rdma_edr"].bandwidth(skew) / n["ipoib_edr"].bandwidth(skew)},
        "fig12_bw_rdma_x_ipoib": {"target": 3.2, "model": n["rdma_fdr"].bandwidth(skew) / n["ipoib_fdr"].bandwidth(skew)},
        "fig13_tp_rdma_x_eth40g": {"target": 4.1, "model": n["rdma_edr"].ps_throughput(uni, 2, 3) / n["eth40g"].ps_throughput(uni, 2, 3)},
        "fig13_tp_rdma_x_ipoib": {"target": 3.43, "model": n["rdma_edr"].ps_throughput(uni, 2, 3) / n["ipoib_edr"].ps_throughput(uni, 2, 3)},
        "fig14_tp_rdma_x_eth10g": {"target": 5.9, "model": n["rdma_fdr"].ps_throughput(uni, 2, 3) / n["eth10g"].ps_throughput(uni, 2, 3)},
        "fig7_serialization_constant": {
            "target": 1.0,
            "model": ((n["eth40g"].payload_time(uni, serialized=True)
                       - n["eth40g"].payload_time(uni, serialized=False))
                      / (n["rdma_edr"].payload_time(uni, serialized=True)
                         - n["rdma_edr"].payload_time(uni, serialized=False))),
        },
    }
    for v in out.values():
        v["rel_err"] = abs(v["model"] - v["target"]) / abs(v["target"])
    return out
