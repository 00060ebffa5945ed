"""Multi-endpoint cluster transport: N named endpoints on one fabric.

The paper's workload characterization (§3) is built around
parameter-server deployments — many worker processes talking to PS
processes over gRPC. :class:`ClusterSpec` declares such a deployment in
one object: named endpoints grouped into jobs (``ps`` / ``worker``),
each with its own base network model and advertised credit windows,
plus per-directed-link bandwidth/latency overrides.
:class:`ClusterTransport` binds the spec onto one fabric:

* **endpoint-addressed channels** — ``fabric.channel("worker0", "ps1")``
  and ``fabric.add_server("ps1")`` resolve names through the spec;
* **per-link routing** — a flight's messages are grouped per directed
  link and priced on that link's resolved model (dst endpoint base
  network + overrides), with per-link AND cross-link host-copy
  contention, matching ``core.netmodel.cluster_flight_time`` exactly;
* **loopback-fast local calls** — same-endpoint messages cost one host
  memcpy, never link alpha / rpc overhead / egress;
* **per-endpoint credit windows** — an endpoint that advertises a
  window sizes every channel touching it (forward direction by the
  receiver's window, reverse by the client's).

Frames pass through un-copied (like ``SimulatedTransport``), so
dispatching handlers — including a real serving engine — run on the
delivered payloads while elapsed time stays fully modeled: a cluster
serving experiment is deterministic and runs at memcpy speed.

The pattern-level closed forms (``cluster_fc_round_time`` /
``cluster_ring_round_time`` / ``cluster_incast_round_time``) price one
round of each fabric benchmark family on a spec; the transport driving
``rpc.fully_connected_exchange`` / ``ring_exchange`` /
``incast_exchange`` must land on them exactly
(tests/test_cluster_transport.py, incl. by-mutation checks).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.netmodel import (ALLREDUCE_TAG_BYTES, NETWORKS, LinkLoad,
                                 NetworkModel, allreduce_chunk_sizes,
                                 cluster_flight_time,
                                 ring_allreduce_send_chunk,
                                 tree_reduce_rounds)
from repro_torch.core.payload import PayloadSpec, classify, scale_sizes
from repro_torch.rpc.flow import WindowConfig
from repro_torch.rpc.transport import (Delivery, Message, Transport,
                                 schedule_rounds, spec_of)


@dataclass(frozen=True)
class EndpointSpec:
    """One named endpoint: its job, base network, advertised window,
    and (optional) advertised admission limit — the outstanding-call
    cap an ``AdmissionInterceptor`` enforces for this endpoint (calls
    beyond it are rejected with a transient ``resource exhausted``
    error clients retry or fail over)."""
    name: str
    job: str = "worker"
    network: str = "eth40g"           # key into core.netmodel.NETWORKS
    window: Optional[WindowConfig] = None
    admission_limit: Optional[int] = None

    def model(self) -> NetworkModel:
        return NETWORKS[self.network]


@dataclass(frozen=True)
class LinkSpec:
    """Overrides for one *directed* link (src -> dst by endpoint name).
    Unset fields inherit from the dst endpoint's base network."""
    src: str
    dst: str
    bandwidth_Bps: Optional[float] = None
    latency_s: Optional[float] = None


@dataclass(frozen=True)
class ClusterSpec:
    """A PS-style deployment: named endpoints + per-link overrides."""
    endpoints: Tuple[EndpointSpec, ...]
    links: Tuple[LinkSpec, ...] = ()

    def __post_init__(self):
        if not self.endpoints:
            raise ValueError("ClusterSpec needs at least one endpoint")
        seen = set()
        for ep in self.endpoints:
            if ep.name in seen:
                raise ValueError(f"duplicate endpoint name {ep.name!r}")
            seen.add(ep.name)
            if ep.network not in NETWORKS:
                raise ValueError(
                    f"endpoint {ep.name!r}: unknown network "
                    f"{ep.network!r}; choose from {sorted(NETWORKS)}")
            if ep.admission_limit is not None and ep.admission_limit < 1:
                raise ValueError(
                    f"endpoint {ep.name!r}: admission_limit must be "
                    f">= 1, got {ep.admission_limit}")
        pairs = set()
        for ln in self.links:
            for end in (ln.src, ln.dst):
                if end not in seen:
                    raise ValueError(
                        f"link {ln.src!r}->{ln.dst!r}: unknown endpoint "
                        f"{end!r}")
            if ln.src == ln.dst:
                # same-endpoint traffic is a host memcpy — a self-link
                # override would be silently dead config
                raise ValueError(
                    f"self-link {ln.src!r}->{ln.dst!r}: same-endpoint "
                    f"calls are loopback memcpys, link parameters "
                    f"never apply to them")
            if (ln.src, ln.dst) in pairs:
                raise ValueError(
                    f"duplicate link {ln.src!r}->{ln.dst!r}")
            pairs.add((ln.src, ln.dst))

    # addressing -------------------------------------------------------
    @property
    def n_endpoints(self) -> int:
        return len(self.endpoints)

    def index(self, name: str) -> int:
        for i, ep in enumerate(self.endpoints):
            if ep.name == name:
                return i
        raise ValueError(
            f"unknown endpoint {name!r}; endpoints: "
            f"{[ep.name for ep in self.endpoints]}")

    def name_of(self, endpoint: int) -> str:
        return self.endpoints[endpoint].name

    def job_endpoints(self, job: str) -> Tuple[str, ...]:
        """Endpoint names of one job, in spec order (the PS/worker
        job -> endpoint mapping)."""
        return tuple(ep.name for ep in self.endpoints if ep.job == job)

    @property
    def jobs(self) -> Dict[str, Tuple[str, ...]]:
        out: Dict[str, Tuple[str, ...]] = {}
        for ep in self.endpoints:
            out[ep.job] = out.get(ep.job, ()) + (ep.name,)
        return out

    def admission_limits(self) -> Dict[int, int]:
        """endpoint index -> advertised admission limit, for every
        endpoint that declares one — the ``limits`` mapping an
        ``AdmissionInterceptor`` takes (``serve_cluster`` wires this
        automatically)."""
        return {i: ep.admission_limit
                for i, ep in enumerate(self.endpoints)
                if ep.admission_limit is not None}

    # link resolution --------------------------------------------------
    def base_model(self, endpoint: int) -> NetworkModel:
        return self.endpoints[endpoint].model()

    def link_model(self, src: int, dst: int) -> NetworkModel:
        """The resolved model of one directed link: the dst endpoint's
        base network with this link's bandwidth/latency overrides."""
        base = self.base_model(dst)
        sname, dname = self.name_of(src), self.name_of(dst)
        for ln in self.links:
            if ln.src == sname and ln.dst == dname:
                return base.with_link(bandwidth_Bps=ln.bandwidth_Bps,
                                      latency_s=ln.latency_s)
        return base

    # serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "endpoints": [
                {"name": ep.name, "job": ep.job, "network": ep.network,
                 **({"window": {"bytes": ep.window.bytes,
                                "msgs": ep.window.msgs}}
                    if ep.window is not None else {}),
                 **({"admission_limit": ep.admission_limit}
                    if ep.admission_limit is not None else {})}
                for ep in self.endpoints],
            "links": [
                {"src": ln.src, "dst": ln.dst,
                 **({"bandwidth_Bps": ln.bandwidth_Bps}
                    if ln.bandwidth_Bps is not None else {}),
                 **({"latency_s": ln.latency_s}
                    if ln.latency_s is not None else {})}
                for ln in self.links],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ClusterSpec":
        eps = []
        for e in d.get("endpoints", ()):
            w = e.get("window")
            eps.append(EndpointSpec(
                name=e["name"], job=e.get("job", "worker"),
                network=e.get("network", "eth40g"),
                window=(WindowConfig(int(w["bytes"]), int(w["msgs"]))
                        if w is not None else None),
                admission_limit=(int(e["admission_limit"])
                                 if e.get("admission_limit") is not None
                                 else None)))
        links = tuple(LinkSpec(
            src=ln["src"], dst=ln["dst"],
            bandwidth_Bps=(float(ln["bandwidth_Bps"])
                           if ln.get("bandwidth_Bps") is not None
                           else None),
            latency_s=(float(ln["latency_s"])
                       if ln.get("latency_s") is not None else None))
            for ln in d.get("links", ()))
        return cls(endpoints=tuple(eps), links=links)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, text: str) -> "ClusterSpec":
        return cls.from_dict(json.loads(text))


def homogeneous(n: int, network: str = "eth40g", *, job: str = "worker",
                prefix: str = "ep",
                window: Optional[WindowConfig] = None) -> ClusterSpec:
    """n identical endpoints on one network — the degenerate cluster a
    plain ``--transport cluster`` run (no ``--cluster-spec``) gets; it
    reproduces ``SimulatedTransport`` pricing exactly."""
    return ClusterSpec(endpoints=tuple(
        EndpointSpec(f"{prefix}{i}", job=job, network=network,
                     window=window) for i in range(n)))


def ps_worker_cluster(n_ps: int, n_workers: int, *,
                      ps_network: str = "eth40g",
                      worker_network: str = "eth40g",
                      links: Sequence[LinkSpec] = ()) -> ClusterSpec:
    """The paper's deployment shape: ``ps0..`` endpoints first (so the
    incast server, endpoint 0, is a PS), then ``worker0..``."""
    eps = tuple(EndpointSpec(f"ps{i}", job="ps", network=ps_network)
                for i in range(n_ps))
    eps += tuple(EndpointSpec(f"worker{i}", job="worker",
                              network=worker_network)
                 for i in range(n_workers))
    return ClusterSpec(endpoints=eps, links=tuple(links))


def as_cluster_spec(obj: Union[ClusterSpec, dict, str]) -> ClusterSpec:
    """Coerce a ClusterSpec | dict | JSON string into a ClusterSpec."""
    if isinstance(obj, ClusterSpec):
        return obj
    if isinstance(obj, dict):
        return ClusterSpec.from_dict(obj)
    if isinstance(obj, str):
        return ClusterSpec.from_json(obj)
    raise TypeError(f"cannot build a ClusterSpec from {type(obj)!r}")


def load_cluster_spec(text: str) -> ClusterSpec:
    """The CLIs' ``--cluster-spec`` value: inline JSON (starts with
    ``{``) or a path to a JSON file."""
    if text.lstrip().startswith("{"):
        return ClusterSpec.from_json(text)
    with open(text) as f:
        return ClusterSpec.from_json(f.read())


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

# split across two lines: the grep gates of tests/test_service_api.py
# exempt only src/repro/rpc/ from flagging ClusterTransport before a
# parenthesis
class ClusterTransport \
        (Transport):
    """Analytic multi-endpoint transport over a :class:`ClusterSpec`.

    Per flight, messages are routed onto their directed links; each
    link's messages serialize on the link's resolved model and pay the
    per-link quadratic host-copy term; messages from *different* links
    landing on one endpoint additionally pay the cross-link host-copy
    term; each sender pays egress per link. Same-endpoint messages are
    loopback memcpys. Matches ``netmodel.cluster_flight_time`` exactly.

    Frames pass through with their buffers intact, so handlers (and a
    real serving engine) run on a fully modeled clock.
    """

    modeled = True

    def __init__(self, cluster: ClusterSpec):
        self.cluster = cluster
        self.n_endpoints = cluster.n_endpoints
        self.clock_s = 0.0
        self._models: Dict[Tuple[int, int], NetworkModel] = {}

    # endpoint addressing (the fabric resolves names through these) ----
    def resolve(self, name: str) -> int:
        return self.cluster.index(name)

    def endpoint_name(self, endpoint: int) -> str:
        return self.cluster.name_of(endpoint)

    def channel_windows(self, src: int, dst: int
                        ) -> Tuple[Optional[WindowConfig],
                                   Optional[WindowConfig]]:
        """(forward, reverse) window overrides for a (src -> dst)
        channel: gRPC-style receiver-advertised flow control — the
        forward direction is sized by the dst endpoint's window, the
        reverse by the src's. None keeps the fabric default."""
        return (self.cluster.endpoints[dst].window,
                self.cluster.endpoints[src].window)

    def link_model(self, src: int, dst: int) -> NetworkModel:
        key = (src, dst)
        m = self._models.get(key)
        if m is None:
            m = self.cluster.link_model(src, dst)
            self._models[key] = m
        return m

    # pricing ----------------------------------------------------------
    @staticmethod
    def price(model: NetworkModel, frame) -> float:
        """One message at the link's receiver: payload + 64B ack."""
        return (model.payload_time(spec_of(frame),
                                   mode=frame.wire_mode)
                + model.msg_time(64))

    @staticmethod
    def _link_contention(model: NetworkModel, n_msgs: int,
                         total_bytes: int) -> float:
        """The per-link quadratic copy term (the mutation target of the
        conformance cross-checks: zeroing it must break the match)."""
        if n_msgs < 2:
            return 0.0
        return (n_msgs * (n_msgs - 1) * (total_bytes / n_msgs)
                / model.cpu_copy_Bps)

    def deliver(self, messages: Sequence[Message]) -> Delivery:
        # route the flight onto its directed links
        per_link: Dict[Tuple[int, int], List] = {}
        for m in messages:
            assert 0 <= m.src < self.n_endpoints, m.src
            assert 0 <= m.dst < self.n_endpoints, m.dst
            per_link.setdefault((m.src, m.dst), []).append(m.frame)
        ingress: Dict[int, float] = {}
        egress: Dict[int, float] = {}
        cross: Dict[int, List[Tuple[NetworkModel, int, int]]] = {}
        for (src, dst), frames in per_link.items():
            model = self.link_model(src, dst)
            nbytes = sum(f.total_bytes for f in frames)
            if src == dst:
                # loopback-fast: one host memcpy per message
                ingress[dst] = (ingress.get(dst, 0.0)
                                + nbytes / model.cpu_copy_Bps)
                continue
            t = sum(self.price(model, f) for f in frames)
            t += self._link_contention(model, len(frames), nbytes)
            ingress[dst] = ingress.get(dst, 0.0) + t
            egress[src] = (egress.get(src, 0.0)
                           + nbytes / model.beta_Bps)
            cross.setdefault(dst, []).append((model, len(frames),
                                              nbytes))
        # cross-link host-copy contention at each receiving endpoint
        for dst, lds in cross.items():
            k_tot = sum(k for _, k, _ in lds)
            if k_tot < 2:
                continue
            pairs = k_tot * (k_tot - 1) - sum(k * (k - 1)
                                              for _, k, _ in lds)
            if pairs <= 0:
                continue
            bytes_tot = sum(b for _, _, b in lds)
            ingress[dst] += (pairs * (bytes_tot / k_tot)
                             / lds[0][0].cpu_copy_Bps)
        elapsed = max((ingress.get(e, 0.0) + egress.get(e, 0.0)
                       for e in set(ingress) | set(egress)),
                      default=0.0)
        self.clock_s += elapsed
        rounds = schedule_rounds(messages)
        return Delivery(list(messages), elapsed, len(rounds),
                        modeled=True)


# ---------------------------------------------------------------------------
# pattern-level closed forms (one round of each fabric benchmark family
# on a ClusterSpec; built on netmodel.cluster_flight_time)
# ---------------------------------------------------------------------------

def _payload_spec(sizes: Sequence[int]) -> PayloadSpec:
    return PayloadSpec(sizes=tuple(int(s) for s in sizes), scheme="wire",
                       categories=tuple(classify(int(s)) for s in sizes))


def _load(cluster: ClusterSpec, src: int, dst: int, spec: PayloadSpec,
          n_msgs: int, serialized: bool,
          mode: Optional[str] = None) -> LinkLoad:
    return LinkLoad(src, dst, cluster.link_model(src, dst),
                    (spec,) * n_msgs, serialized=serialized, mode=mode)


def cluster_fc_round_time(cluster: ClusterSpec, sizes: Sequence[int], *,
                          serialized: bool = False,
                          mode: Optional[str] = None) -> float:
    """One fully-connected exchange on the cluster: every endpoint one
    payload to every other, all in one flight."""
    n = cluster.n_endpoints
    assert n >= 2, n
    spec = _payload_spec(sizes)
    loads = [_load(cluster, i, j, spec, 1, serialized, mode)
             for i in range(n) for j in range(n) if i != j]
    return cluster_flight_time(loads)


def cluster_ring_round_time(cluster: ClusterSpec, sizes: Sequence[int],
                            *, n_chunks: int = 1,
                            serialized: bool = False,
                            mode: Optional[str] = None) -> float:
    """One chunked ring pass: every endpoint streams n_chunks to its
    successor (i -> (i+1) % n), one flight."""
    n = cluster.n_endpoints
    assert n >= 2, n
    spec = _payload_spec(sizes)
    loads = [_load(cluster, i, (i + 1) % n, spec, n_chunks, serialized,
                   mode)
             for i in range(n)]
    return cluster_flight_time(loads)


def cluster_incast_round_time(cluster: ClusterSpec,
                              sizes: Sequence[int], *,
                              n_chunks: int = 1,
                              serialized: bool = False,
                              mode: Optional[str] = None,
                              fetch_ratio: float = 1.0,
                              server: int = 0) -> float:
    """One incast round: every non-server endpoint streams n_chunks
    into the server (the push flight), which streams the fetch back
    sized ``fetch_ratio`` times the push (the fetch flight)."""
    n = cluster.n_endpoints
    assert n >= 2, n
    spec = _payload_spec(sizes)
    fspec = _payload_spec(scale_sizes(sizes, fetch_ratio))
    workers = [w for w in range(n) if w != server]
    push = [_load(cluster, w, server, spec, n_chunks, serialized, mode)
            for w in workers]
    fetch = [_load(cluster, server, w, fspec, n_chunks, serialized,
                   mode)
             for w in workers]
    return cluster_flight_time(push) + cluster_flight_time(fetch)


def cluster_ring_allreduce_time(cluster: ClusterSpec, total_bytes: int,
                                *, itemsize: int = 1,
                                serialized: bool = False,
                                mode: Optional[str] = None) -> float:
    """Ring allreduce on the cluster: 2(n-1) rotation flights, each
    worker sending one balanced chunk to its successor — per-step link
    loads summed through ``cluster_flight_time``, matching
    ``rpc.collectives.ring_allreduce`` over a ClusterTransport."""
    n = cluster.n_endpoints
    if n < 2:
        return 0.0
    chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
    total = 0.0
    for step in range(2 * (n - 1)):
        loads = [_load(cluster, i, (i + 1) % n,
                       _payload_spec(
                           (chunks[ring_allreduce_send_chunk(i, step,
                                                             n)],)),
                       1, serialized, mode)
                 for i in range(n)]
        total += cluster_flight_time(loads)
    return total


def cluster_tree_allreduce_time(cluster: ClusterSpec, total_bytes: int,
                                *, serialized: bool = False,
                                mode: Optional[str] = None) -> float:
    """Binomial-tree allreduce on the cluster: ceil(log2 n) reduce
    flights toward endpoint 0, mirrored broadcast flights back out,
    full payload per pair send."""
    n = cluster.n_endpoints
    if n < 2:
        return 0.0
    spec = _payload_spec((int(total_bytes),))
    rounds = tree_reduce_rounds(n)
    total = 0.0
    for pairs in rounds:
        total += cluster_flight_time(
            [_load(cluster, s, d, spec, 1, serialized, mode)
             for s, d in pairs])
    for pairs in reversed(rounds):
        total += cluster_flight_time(
            [_load(cluster, d, s, spec, 1, serialized, mode)
             for s, d in pairs])
    return total


def cluster_rsag_allreduce_time(cluster: ClusterSpec, total_bytes: int,
                                *, itemsize: int = 1,
                                serialized: bool = False,
                                mode: Optional[str] = None) -> float:
    """Reduce-scatter + allgather on the cluster: two all-to-all
    flights of source-tagged chunks (every endpoint ingests n-1
    messages per flight — the cross-link contention case)."""
    n = cluster.n_endpoints
    if n < 2:
        return 0.0
    chunks = allreduce_chunk_sizes(total_bytes, n, itemsize=itemsize)
    tag = ALLREDUCE_TAG_BYTES
    scatter = [_load(cluster, i, j, _payload_spec((tag, chunks[j])), 1,
                     serialized, mode)
               for i in range(n) for j in range(n) if j != i]
    gather = [_load(cluster, j, i, _payload_spec((tag, chunks[j])), 1,
                    serialized, mode)
              for j in range(n) for i in range(n) if i != j]
    return cluster_flight_time(scatter) + cluster_flight_time(gather)


def cluster_allreduce_time(cluster: ClusterSpec, algo: str,
                           total_bytes: int, *, itemsize: int = 1,
                           serialized: bool = False,
                           mode: Optional[str] = None) -> float:
    """Dispatch on the ``netmodel.ALLREDUCE_ALGOS`` name."""
    forms = {"ring": cluster_ring_allreduce_time,
             "tree": cluster_tree_allreduce_time,
             "rsag": cluster_rsag_allreduce_time}
    if algo not in forms:
        raise ValueError(f"unknown allreduce algo {algo!r}; "
                         f"expected one of {tuple(forms)}")
    kw = {} if algo == "tree" else {"itemsize": itemsize}
    return forms[algo](cluster, total_bytes, serialized=serialized,
                       mode=mode, **kw)


__all__ = [
    "ClusterSpec", "ClusterTransport", "EndpointSpec", "LinkSpec",
    "as_cluster_spec", "cluster_allreduce_time",
    "cluster_fc_round_time", "cluster_incast_round_time",
    "cluster_ring_allreduce_time", "cluster_ring_round_time",
    "cluster_rsag_allreduce_time", "cluster_tree_allreduce_time",
    "homogeneous", "load_cluster_spec", "ps_worker_cluster",
]
