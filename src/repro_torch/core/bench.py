"""The TF-gRPC-Bench micro-benchmarks (paper §3.2) plus the rpc-fabric
families, run over repro_torch.core.channels and repro_torch.rpc,
with the paper's warmup/duration protocol and the netmodel projection
alongside the measured numbers.

The endpoints are the rows of tensors on ``device`` (``run(cfg,
device=...)``, default ``"cuda"``; ``"cpu"`` runs the plain path). Every
timed iteration of a paper family ends in ``torch.cuda.synchronize`` on
the card, so its time covers the device work.

  TF-gRPC-P2P-Latency    -> p2p_latency()
  TF-gRPC-P2P-Bandwidth  -> p2p_bandwidth()
  TF-gRPC-PS-Throughput  -> ps_throughput()
  fully_connected        -> fully_connected()   (rpc fabric; transport =
  ring                   -> ring()               collective | loopback |
  incast                 -> incast()             simulated)
  allreduce              -> allreduce()          (cfg.algo schedule)
  train_step             -> train_step()         (cfg.train_mode layout)

ring/incast are streaming families: each worker moves
``cfg.stream_chunks`` chunk frames per stream (ring: to its successor;
incast: bidi into one server that streams the fetch back). allreduce
runs one ``rpc.collectives`` schedule (ring | tree | rsag) over the
payload; train_step runs one ``train.fabric_train.FabricTrainStep``
data-parallel SGD step, either through sharded parameter servers
(``cfg.train_mode = "ps"``) or a cfg.algo allreduce — sweeping workers
across the two train modes locates the PS -> allreduce crossover.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.tfgrpc_bench import BenchConfig
from repro_torch.core import channels as ch
from repro_torch.core.netmodel import ALLREDUCE_ALGOS, NETWORKS, WIRE_MODES
from repro_torch.core.payload import PayloadSpec, generate_spec
from repro_torch.core.resource import ResourceMonitor, ResourceReport


@dataclass
class BenchStats:
    name: str
    config: BenchConfig
    spec: PayloadSpec
    n_iters: int
    mean_s: float
    p50_s: float
    p95_s: float
    min_s: float
    max_s: float
    derived: Dict[str, float] = field(default_factory=dict)
    resources: Optional[ResourceReport] = None
    model_projection: Dict[str, float] = field(default_factory=dict)
    # per-method interceptor metrics (fabric families): call counts +
    # latency percentiles from the MetricsInterceptor on the fabric
    rpc_metrics: Dict[str, dict] = field(default_factory=dict)
    # per-method phase-level latency breakdown (fabric families, from
    # the fabric Tracer): {method: {calls, end_to_end_s, phases: {...}}}
    rpc_phases: Dict[str, dict] = field(default_factory=dict)
    # the rpc.Tracer the run recorded into (None when untraced) — holds
    # the span trees; export_chrome() writes the Perfetto-loadable JSON
    tracer: Optional[object] = None

    def row(self) -> str:
        d = ",".join(f"{k}={v:.6g}" for k, v in self.derived.items())
        return (f"{self.name},{self.mean_s*1e6:.2f},{d}")


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (the reference's
    ``jax.block_until_ready``); CPU tensors are done on return."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_loop(fn: Callable, args, warmup_s: float, duration_s: float,
                min_iters: int = 5) -> List[float]:
    """Paper protocol: warm up for warmup_s, then measure for duration_s.
    The first call (which builds the kernels on the card) comes before
    the warm-up clock starts."""
    device = args[0].device
    fn(*args)
    _sync(device)
    t_end = time.perf_counter() + warmup_s
    while time.perf_counter() < t_end:
        fn(*args)
        _sync(device)
    times: List[float] = []
    t_stop = time.perf_counter() + duration_s
    while time.perf_counter() < t_stop or len(times) < min_iters:
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times


def _stats(name, cfg, spec, times, derived, res=None) -> BenchStats:
    a = np.asarray(times)
    st = BenchStats(
        name=name, config=cfg, spec=spec, n_iters=len(a),
        mean_s=float(a.mean()), p50_s=float(np.percentile(a, 50)),
        p95_s=float(np.percentile(a, 95)), min_s=float(a.min()),
        max_s=float(a.max()), derived=derived, resources=res)
    for net_name, net in NETWORKS.items():
        mode = cfg.resolved_wire_mode
        if name == "p2p_latency":
            st.model_projection[net_name] = net.rtt(spec, mode=mode)
        elif name == "p2p_bandwidth":
            st.model_projection[net_name] = net.bandwidth(
                spec, mode=mode)
        elif name == "fully_connected":
            st.model_projection[net_name] = net.fc_throughput(
                spec, cfg.num_workers, mode=mode)
        elif name == "ring":
            st.model_projection[net_name] = net.ring_throughput(
                spec, cfg.num_workers, n_chunks=cfg.stream_chunks,
                mode=mode)
        elif name == "incast":
            st.model_projection[net_name] = net.incast_throughput(
                spec, cfg.num_workers, n_chunks=cfg.stream_chunks,
                mode=mode, fetch_ratio=cfg.fetch_ratio)
        elif name == "allreduce":
            t = net.allreduce_time(cfg.algo, spec.total_bytes,
                                   cfg.num_workers, mode=mode)
            st.model_projection[net_name] = \
                allreduce_rpcs_per_round(cfg.algo, cfg.num_workers) / t
        elif name == "train_step":
            from repro_torch.train.fabric_train import train_step_time
            st.model_projection[net_name] = 1.0 / train_step_time(
                net, cfg.train_mode, _grad_params(cfg, spec) * 4,
                cfg.num_workers, n_ps=cfg.num_ps, algo=cfg.algo,
                mode=mode)
        else:
            st.model_projection[net_name] = net.ps_throughput(
                spec, cfg.num_ps, cfg.num_workers, mode=mode)
    return st


def _check_collective_mode(cfg: BenchConfig) -> None:
    """The collective transport lowers frames onto device ppermute
    schedules — there is no shared host buffer pool to point descriptors
    at, so the zero-copy tier is undefined there. Loud error (a SKIPPED
    sweep cell) instead of silently pricing it as scatter-gather."""
    if cfg.resolved_wire_mode == "zero_copy":
        raise RuntimeError(
            "wire_mode=zero_copy is not supported on the collective "
            "transport; use --transport loopback|simulated|cluster")


def _prep(cfg: BenchConfig, need: int, device):
    _check_collective_mode(cfg)
    mesh = ch.make_net_mesh(device=device)
    n = mesh.shape[ch.AXIS]
    if n < need:
        raise RuntimeError(
            f"{cfg.benchmark} needs >= {need} endpoints, have {n} "
            f"(the rows of the {ch.DEFAULT_ENDPOINTS}-endpoint mesh)")
    spec = generate_spec(cfg)
    bufs = ch.device_payload(mesh, spec, seed=cfg.seed)
    return mesh, spec, bufs


def p2p_latency(cfg: BenchConfig, device="cuda") -> BenchStats:
    mesh, spec, bufs = _prep(cfg, 2, device)
    fn = ch.p2p_echo_fn(mesh, spec.n_buffers,
                        serialized=(cfg.mode == "serialized"))
    with ResourceMonitor() as mon:
        times = _timed_loop(fn, bufs, cfg.warmup_s, cfg.duration_s)
    return _stats("p2p_latency", cfg, spec, times,
                  {"rtt_us": float(np.mean(times)) * 1e6}, mon.report)


def p2p_bandwidth(cfg: BenchConfig, device="cuda") -> BenchStats:
    mesh, spec, bufs = _prep(cfg, 2, device)
    fn = ch.p2p_send_fn(mesh, spec.n_buffers,
                        serialized=(cfg.mode == "serialized"))
    with ResourceMonitor() as mon:
        times = _timed_loop(fn, bufs, cfg.warmup_s, cfg.duration_s)
    mbps = spec.total_bytes / np.mean(times) / 1e6
    return _stats("p2p_bandwidth", cfg, spec, times,
                  {"MBps": float(mbps)}, mon.report)


def ps_throughput(cfg: BenchConfig, device="cuda") -> BenchStats:
    need = cfg.num_ps + cfg.num_workers
    mesh, spec, bufs = _prep(cfg, need, device)
    fn = ch.ps_round_fn(mesh, spec.n_buffers, cfg.num_ps, cfg.num_workers,
                        serialized=(cfg.mode == "serialized"))
    with ResourceMonitor() as mon:
        times = _timed_loop(fn, bufs, cfg.warmup_s, cfg.duration_s)
    rpcs = ch.rpcs_per_round(cfg.num_ps, cfg.num_workers)
    return _stats("ps_throughput", cfg, spec, times,
                  {"rpcs_per_s": rpcs / float(np.mean(times))}, mon.report)


def _resolve_cluster(cfg: BenchConfig, n_endpoints: int, family: str):
    """The ClusterSpec a ``--transport cluster`` run binds: the given
    spec (which must cover the benchmark's endpoint count), or a
    synthesized homogeneous cluster on cfg.network."""
    from repro_torch.rpc.cluster import as_cluster_spec, homogeneous
    if cfg.cluster_spec is None:
        return homogeneous(n_endpoints, cfg.network or "eth40g")
    cluster = as_cluster_spec(cfg.cluster_spec)
    if cluster.n_endpoints != n_endpoints:
        # the exchanges span every fabric endpoint, so a mismatched
        # spec would silently benchmark a different topology
        raise RuntimeError(
            f"{family}/cluster needs exactly {n_endpoints} endpoints "
            f"(incl. the server for incast), the cluster spec has "
            f"{cluster.n_endpoints}")
    return cluster


def _make_fabric(cfg: BenchConfig, spec: PayloadSpec, n_endpoints: int,
                 family: str, device="cuda"):
    """Build the rpc fabric (+ materialized bufs where the transport
    moves real bytes, + the MetricsInterceptor every fabric benchmark
    reports from) for one fabric-family benchmark under cfg.transport.
    Windows are sized so a whole stream (cfg.stream_chunks payloads,
    fetch asymmetry included) fits in flight per channel — the
    benchmark measures the traffic pattern, not an arbitrarily small
    default window; shrink RpcFabric windows directly to study
    back-pressure."""
    from repro_torch import rpc as rpclib
    from repro_torch.core.payload import materialize

    serialized = cfg.resolved_wire_mode == "serialized"
    bufs = None
    per_endpoint = False
    endpoint_name = None
    if cfg.transport == "collective":
        _check_collective_mode(cfg)
        mesh = ch.make_net_mesh(device=device)
        if mesh.shape[ch.AXIS] < n_endpoints:
            raise RuntimeError(
                f"{family}/collective needs >= {n_endpoints} endpoints, "
                f"have {mesh.shape[ch.AXIS]} (the rows of the "
                f"{ch.DEFAULT_ENDPOINTS}-endpoint mesh)")
        transport = rpclib.make_transport(
            "collective", n_endpoints, mesh=mesh, spec=spec,
            serialized=serialized, seed=cfg.seed)
    elif cfg.transport == "loopback":
        transport = rpclib.make_transport("loopback", n_endpoints)
        bufs = materialize(spec, seed=cfg.seed)
    elif cfg.transport == "simulated":
        # unknown names raise inside make_transport
        transport = rpclib.make_transport(
            "simulated", n_endpoints, network=cfg.network or "eth40g")
    elif cfg.transport == "cluster":
        cluster = _resolve_cluster(cfg, n_endpoints, family)
        transport = rpclib.make_transport("cluster", cluster=cluster)
        # cluster rows report metrics broken down per endpoint pair
        per_endpoint, endpoint_name = True, transport.endpoint_name
    else:
        raise ValueError(f"unknown transport {cfg.transport!r}")
    chunks = max(1, cfg.stream_chunks)
    per_chunk = int(spec.total_bytes * max(1.0, cfg.fetch_ratio))
    metrics = rpclib.MetricsInterceptor(per_endpoint=per_endpoint,
                                        endpoint_name=endpoint_name)
    # failure-semantics axes: --deadline-s installs a default deadline
    # (propagated to servers, which shed expired work — a terminal
    # deadline outcome, never retried, surfacing as shed /
    # deadline_exceeded counts); --admission-limit installs server-side
    # admission control fed by the same metrics, plus a
    # RetryInterceptor so its transient rejections re-try on later
    # (drained) flights. Either axis puts the metrics in the server
    # chain so shed/rejected counts land in rpc_metrics.
    client_ics = [metrics]
    server_ics = []
    if cfg.deadline_s is not None:
        client_ics.append(rpclib.DeadlineInterceptor(cfg.deadline_s))
        server_ics = [metrics]
    if cfg.admission_limit is not None:
        server_ics = [metrics,
                      rpclib.AdmissionInterceptor(cfg.admission_limit,
                                                  metrics=metrics)]
        client_ics.append(rpclib.RetryInterceptor(max_attempts=4))
    # modeled transports always carry a Tracer (spans cost nothing on
    # the modeled clock and feed the --json phase breakdown); measured
    # transports only trace when asked, so the hot loop stays clean
    tracer = None
    if cfg.trace or getattr(transport, "modeled", False):
        tracer = rpclib.Tracer()
    fabric = rpclib.RpcFabric(
        transport,
        window_bytes=max(4 * 1024 * 1024, (chunks + 1) * per_chunk),
        window_msgs=max(32, chunks + 1),
        client_interceptors=client_ics,
        server_interceptors=server_ics,
        tracer=tracer)
    return fabric, bufs, metrics


def _cluster_projection(st: BenchStats, cfg: BenchConfig, fabric,
                        spec: PayloadSpec, n_chunks: int = 1) -> None:
    """Attach the per-link closed-form throughput of the bound cluster
    (the analytic number a ``--transport cluster`` run must match) as
    the ``cluster`` model projection."""
    if cfg.transport != "cluster":
        return
    from repro_torch.rpc import cluster as cluster_lib
    cl = fabric.transport.cluster
    if any(ep.window is not None for ep in cl.endpoints):
        # endpoint-advertised windows split streams across flights, so
        # the one-flight closed form no longer applies — publish no
        # number rather than one the run is not expected to match
        return
    mode = cfg.resolved_wire_mode
    sizes = list(spec.sizes)
    if st.name == "fully_connected":
        t = cluster_lib.cluster_fc_round_time(cl, sizes, mode=mode)
    elif st.name == "ring":
        t = cluster_lib.cluster_ring_round_time(
            cl, sizes, n_chunks=n_chunks, mode=mode)
    elif st.name == "allreduce":
        t = cluster_lib.cluster_allreduce_time(cl, cfg.algo,
                                               spec.total_bytes,
                                               mode=mode)
    elif st.name == "train_step":
        if cfg.train_mode != "allreduce":
            # no per-link closed form for the sharded-PS step yet —
            # publish no number rather than one the run won't match
            return
        t = cluster_lib.cluster_allreduce_time(
            cl, cfg.algo, _grad_params(cfg, spec) * 4, itemsize=4,
            mode=mode)
        st.model_projection["cluster"] = 1.0 / t
        return
    else:
        t = cluster_lib.cluster_incast_round_time(
            cl, sizes, n_chunks=n_chunks, mode=mode,
            fetch_ratio=cfg.fetch_ratio)
    st.model_projection["cluster"] = st.derived["rpcs_per_round"] / t


def _attach_trace(st: BenchStats, fabric) -> None:
    """Publish the fabric Tracer's per-phase latency breakdown (and the
    tracer itself, for Chrome export) on the stats row."""
    tracer = getattr(fabric, "tracer", None)
    if tracer is None:
        return
    st.tracer = tracer
    st.rpc_phases = tracer.phase_breakdown()


def _fabric_bench(cfg: BenchConfig, exchange, fabric,
                  metrics=None) -> List[float]:
    """Measured-vs-modeled timing protocol shared by the fabric
    families: modeled transports are exact (no warmup loop needed).
    ``metrics`` (the fabric's MetricsInterceptor) is reset after
    warmup so the published percentiles cover only measured
    iterations — never the compile/touch call."""
    if fabric.transport.modeled:
        return [exchange().elapsed_s for _ in range(3)]
    exchange()                                       # compile/touch
    t_end = time.perf_counter() + cfg.warmup_s
    while time.perf_counter() < t_end:
        exchange()
    if metrics is not None:
        metrics.reset()
    times, t_stop = [], time.perf_counter() + cfg.duration_s
    while time.perf_counter() < t_stop or len(times) < 5:
        times.append(exchange().elapsed_s)
    return times


def fully_connected(cfg: BenchConfig, device="cuda") -> BenchStats:
    """Every worker exchanges the payload with every other worker
    through the rpc fabric (paper §2's process architecture, the
    pattern the original three benchmarks never covered)."""
    if cfg.num_workers < 2:
        raise RuntimeError("fully_connected needs --num-workers >= 2")
    from repro_torch import rpc as rpclib
    spec = generate_spec(cfg)
    fabric, bufs, metrics = _make_fabric(cfg, spec, cfg.num_workers,
                                         "fully_connected", device)
    wire_mode = cfg.resolved_wire_mode

    def exchange():
        return rpclib.fully_connected_exchange(
            fabric, list(spec.sizes), bufs=bufs, wire_mode=wire_mode)

    rpcs = ch.fc_rpcs_per_round(cfg.num_workers)
    with ResourceMonitor() as mon:
        times = _fabric_bench(cfg, exchange, fabric, metrics)
    st = _stats("fully_connected", cfg, spec, times,
                {"rpcs_per_s": rpcs / float(np.mean(times)),
                 "rpcs_per_round": float(rpcs)}, mon.report)
    st.rpc_metrics = metrics.snapshot()
    _attach_trace(st, fabric)
    _cluster_projection(st, cfg, fabric, spec)
    return st


def ring(cfg: BenchConfig, device="cuda") -> BenchStats:
    """Every worker streams cfg.stream_chunks payload chunks to its
    successor on the ring — the rotation schedule of
    channels.ring_schedule, all workers concurrently."""
    if cfg.num_workers < 2:
        raise RuntimeError("ring needs --num-workers >= 2")
    from repro_torch import rpc as rpclib
    spec = generate_spec(cfg)
    n_chunks = max(1, cfg.stream_chunks)
    fabric, bufs, metrics = _make_fabric(cfg, spec, cfg.num_workers,
                                         "ring", device)
    wire_mode = cfg.resolved_wire_mode

    def exchange():
        return rpclib.ring_exchange(fabric, list(spec.sizes),
                                    n_chunks=n_chunks, bufs=bufs,
                                    wire_mode=wire_mode)

    rpcs = ch.ring_rpcs_per_round(cfg.num_workers, n_chunks)
    with ResourceMonitor() as mon:
        times = _fabric_bench(cfg, exchange, fabric, metrics)
    st = _stats("ring", cfg, spec, times,
                {"rpcs_per_s": rpcs / float(np.mean(times)),
                 "rpcs_per_round": float(rpcs),
                 "chunks_per_stream": float(n_chunks)}, mon.report)
    st.rpc_metrics = metrics.snapshot()
    _attach_trace(st, fabric)
    _cluster_projection(st, cfg, fabric, spec, n_chunks=n_chunks)
    return st


def incast(cfg: BenchConfig, device="cuda") -> BenchStats:
    """cfg.num_workers workers stream cfg.stream_chunks payload chunks
    each into ONE server endpoint, which streams a fetch sized
    ``cfg.fetch_ratio`` of the push payload back per stream (the
    Cori-style parameter-server hotspot: N-way ingress + N-way fetch
    egress on one node, push/fetch asymmetry configurable)."""
    if cfg.num_workers < 1:
        raise RuntimeError("incast needs --num-workers >= 1")
    if cfg.fetch_ratio <= 0:
        raise RuntimeError("incast needs --fetch-ratio > 0")
    from repro_torch import rpc as rpclib
    spec = generate_spec(cfg)
    n_chunks = max(1, cfg.stream_chunks)
    # endpoint 0 is the server; workers are 1..num_workers
    fabric, bufs, metrics = _make_fabric(cfg, spec, cfg.num_workers + 1,
                                         "incast", device)
    wire_mode = cfg.resolved_wire_mode

    def exchange():
        return rpclib.incast_exchange(fabric, list(spec.sizes),
                                      n_chunks=n_chunks, bufs=bufs,
                                      wire_mode=wire_mode,
                                      fetch_ratio=cfg.fetch_ratio)

    rpcs = ch.incast_rpcs_per_round(cfg.num_workers, n_chunks)
    with ResourceMonitor() as mon:
        times = _fabric_bench(cfg, exchange, fabric, metrics)
    st = _stats("incast", cfg, spec, times,
                {"rpcs_per_s": rpcs / float(np.mean(times)),
                 "rpcs_per_round": float(rpcs),
                 "chunks_per_stream": float(n_chunks),
                 "fetch_ratio": float(cfg.fetch_ratio)}, mon.report)
    st.rpc_metrics = metrics.snapshot()
    _attach_trace(st, fabric)
    _cluster_projection(st, cfg, fabric, spec, n_chunks=n_chunks)
    return st


def allreduce_rpcs_per_round(algo: str, n_workers: int) -> int:
    """Messages one full allreduce moves: ring rotates one chunk per
    worker for 2(n-1) steps, tree sends n-1 reduce + n-1 broadcast
    full payloads, rsag is two (n-1)-wide all-to-all flights."""
    n = n_workers
    if algo == "ring":
        return 2 * n * (n - 1)
    if algo == "tree":
        return 2 * (n - 1)
    if algo == "rsag":
        return 2 * n * (n - 1)
    raise ValueError(f"unknown allreduce algo {algo!r}")


def _grad_params(cfg: BenchConfig, spec: PayloadSpec) -> int:
    """train_step: the synthetic gradient's float32 element count —
    the benchmark payload reinterpreted as a gradient, floored so
    every worker/PS shard holds at least one element."""
    return max(cfg.num_workers, cfg.num_ps, 1, spec.total_bytes // 4)


def _reject_collective(cfg: BenchConfig, family: str) -> None:
    """The collective transport lowers the fixed exchange schedules
    onto device ppermute programs; the collective/train families build
    their own per-step schedules over real host buffers, which has no
    lowering there. Loud error (a SKIPPED sweep cell), like the
    zero-copy gate."""
    if cfg.transport == "collective":
        raise RuntimeError(
            f"{family} does not run on the collective transport; use "
            f"--transport loopback|simulated|cluster")


def allreduce(cfg: BenchConfig, device="cuda") -> BenchStats:
    """One cfg.algo allreduce of the payload across cfg.num_workers
    fabric endpoints (rpc.collectives): modeled transports match the
    netmodel/cluster closed forms exactly; loopback reduces real
    float32 gradients through the measured datapath."""
    if cfg.num_workers < 2:
        raise RuntimeError("allreduce needs --num-workers >= 2")
    _reject_collective(cfg, "allreduce")
    from repro_torch import rpc as rpclib
    if cfg.algo not in rpclib.ALLREDUCE_ALGOS:
        raise RuntimeError(f"unknown --algo {cfg.algo!r}; choose from "
                           f"{', '.join(rpclib.ALLREDUCE_ALGOS)}")
    spec = generate_spec(cfg)
    fabric, _, metrics = _make_fabric(cfg, spec, cfg.num_workers,
                                      "allreduce", device)
    wire_mode = cfg.resolved_wire_mode
    if cfg.transport == "loopback":
        # measured path: reduce real seeded gradients
        rng = np.random.default_rng(cfg.seed)
        elems = _grad_params(cfg, spec)
        data = [rng.standard_normal(elems).astype(np.float32)
                for _ in range(cfg.num_workers)]

        def exchange():
            return rpclib.allreduce(fabric, cfg.algo,
                                    data=[d.copy() for d in data],
                                    itemsize=4, wire_mode=wire_mode)
    else:
        def exchange():
            return rpclib.allreduce(fabric, cfg.algo, spec.total_bytes,
                                    wire_mode=wire_mode)

    rpcs = allreduce_rpcs_per_round(cfg.algo, cfg.num_workers)
    with ResourceMonitor() as mon:
        times = _fabric_bench(cfg, exchange, fabric, metrics)
    st = _stats("allreduce", cfg, spec, times,
                {"rpcs_per_s": rpcs / float(np.mean(times)),
                 "rpcs_per_round": float(rpcs),
                 "algo_steps": float(2 * (cfg.num_workers - 1)
                                     if cfg.algo == "ring" else
                                     2 * max(1, (cfg.num_workers - 1)
                                             .bit_length())
                                     if cfg.algo == "tree" else 2)},
                mon.report)
    st.rpc_metrics = metrics.snapshot()
    _attach_trace(st, fabric)
    _cluster_projection(st, cfg, fabric, spec)
    return st


def train_step(cfg: BenchConfig, device="cuda") -> BenchStats:
    """One data-parallel SGD step per iteration
    (train.fabric_train.FabricTrainStep): the payload reinterpreted as
    a float32 gradient, synchronized through sharded parameter servers
    (cfg.train_mode = "ps": endpoints = num_ps + num_workers) or a
    cfg.algo allreduce (endpoints = num_workers). Sweeping workers
    across both train modes locates the PS -> allreduce crossover."""
    _reject_collective(cfg, "train_step")
    if cfg.train_mode not in ("ps", "allreduce"):
        raise RuntimeError(f"unknown --train-mode {cfg.train_mode!r}; "
                           f"choose from ps, allreduce")
    if cfg.train_mode == "ps":
        if cfg.num_ps < 1 or cfg.num_workers < 1:
            raise RuntimeError("train_step/ps needs --num-ps >= 1 and "
                               "--num-workers >= 1")
        n_endpoints = cfg.num_ps + cfg.num_workers
    else:
        if cfg.num_workers < 2:
            raise RuntimeError(
                "train_step/allreduce needs --num-workers >= 2")
        n_endpoints = cfg.num_workers
    from repro_torch.train.fabric_train import (FabricTrainConfig,
                                          FabricTrainStep)
    spec = generate_spec(cfg)
    fabric, _, metrics = _make_fabric(cfg, spec, n_endpoints,
                                      "train_step", device)
    n_params = _grad_params(cfg, spec)
    trainer = FabricTrainStep(fabric, FabricTrainConfig(
        mode=cfg.train_mode, algo=cfg.algo, n_ps=cfg.num_ps,
        n_params=n_params, seed=cfg.seed,
        wire_mode=cfg.resolved_wire_mode))
    with ResourceMonitor() as mon:
        times = _fabric_bench(cfg, trainer.step, fabric, metrics)
    st = _stats("train_step", cfg, spec, times,
                {"steps_per_s": 1.0 / float(np.mean(times)),
                 "grad_MB": n_params * 4 / 1e6,
                 "steps_run": float(trainer.step_count)}, mon.report)
    st.rpc_metrics = metrics.snapshot()
    _attach_trace(st, fabric)
    _cluster_projection(st, cfg, fabric, spec)
    return st


BENCHMARKS: Dict[str, Callable[..., BenchStats]] = {
    "p2p_latency": p2p_latency,
    "p2p_bandwidth": p2p_bandwidth,
    "ps_throughput": ps_throughput,
    "fully_connected": fully_connected,
    "ring": ring,
    "incast": incast,
    "allreduce": allreduce,
    "train_step": train_step,
}

#: benchmarks that run over the rpc fabric (honor cfg.transport)
FABRIC_BENCHMARKS = ("fully_connected", "ring", "incast", "allreduce",
                     "train_step")


def run(cfg: BenchConfig, device="cuda") -> BenchStats:
    """One benchmark run with the endpoints' rows on ``device`` (the
    modeled transports place nothing there)."""
    return BENCHMARKS[cfg.benchmark](cfg, device)


# ---------------------------------------------------------------------------
# Perf-baseline telemetry: deterministic modeled numbers for all six
# benchmark families, committed to benchmarks/BENCH_fabric.json and
# re-derived in CI. The paper families use the netmodel closed forms;
# the fabric families run the simulated transport (exact on the modeled
# clock) — so a fresh run diffs clean against the committed file unless
# the pricing model or the fabric's behavior actually changed.

BASELINE_SCHEMA = 3

#: the original three fabric exchange families — the generic baseline
#: rows; allreduce/train_step get per-algo / per-train-mode rows
_BASELINE_EXCHANGES = ("fully_connected", "ring", "incast")

#: the committed PS -> allreduce crossover sweep (train_step family):
#: one 64 KiB gradient, 2 PS, ring allreduce, eth40g — the worker
#: band where the paper's PS layout wins and the point where the
#: collective takes over for good
CROSSOVER_GRAD_BYTES = 65536
CROSSOVER_WORKERS = (8, 16, 32, 64, 128)


def collect_train_crossover(network: str = "eth40g",
                            num_ps: int = 2) -> dict:
    """Modeled train_step round times, PS vs ring allreduce, along the
    workers axis (exact closed forms; the simulated transport matches
    them bit-for-bit, held by tests/test_fabric_train.py)."""
    from repro_torch.train.fabric_train import train_step_time
    net = NETWORKS[network]
    points = []
    for w in CROSSOVER_WORKERS:
        ps = train_step_time(net, "ps", CROSSOVER_GRAD_BYTES, w,
                             n_ps=num_ps)
        ar = train_step_time(net, "allreduce", CROSSOVER_GRAD_BYTES, w,
                             algo="ring")
        points.append({"workers": w, "ps_s": ps, "allreduce_s": ar,
                       "winner": "ps" if ps < ar else "allreduce"})
    wins_from = None
    for p in reversed(points):
        if p["winner"] != "allreduce":
            break
        wins_from = p["workers"]
    return {"network": network, "num_ps": num_ps, "algo": "ring",
            "grad_bytes": CROSSOVER_GRAD_BYTES, "points": points,
            "allreduce_wins_from": wins_from}

#: measured flush-loop hot-path numbers of the reference package on a
#: host CPU, carried over unchanged so the baseline files agree: the
#: zero-copy datapath work profiled and trimmed the numpy pack path
#: (preallocated output instead of per-buffer np.pad + np.concatenate),
#: the uint8 coercion fast path, and SimulatedTransport.deliver's
#: per-message dict churn (one accumulator dict instead of four).
#: Informational — check_baseline compares only families/wire_modes.
PERF_NOTES = {
    "encode_serialized_us_per_frame": {"before": 117.7, "after": 18.2},
    "simulated_deliver_64msg_us_per_flight": {"before": 445.7,
                                              "after": 112.0},
    "loopback_fc_serialized_ms_per_round": {"before": 8.26,
                                            "after": 5.4},
    "loopback_fc_scatter_gather_ms_per_round": {"before": 6.49,
                                                "after": 5.0},
}


def collect_baseline(network: str = "eth40g", num_ps: int = 2,
                     num_workers: int = 4, iovec_count: int = 10,
                     scheme: str = "uniform", mode: str = "non_serialized",
                     stream_chunks: int = 4, fetch_ratio: float = 1.0,
                     seed: int = 0) -> dict:
    """Modeled round time + throughput of every benchmark family.

    The returned dict records the exact config it was collected under,
    so ``check_baseline`` can re-run the identical configuration.
    """
    config = dict(network=network, num_ps=num_ps, num_workers=num_workers,
                  iovec_count=iovec_count, scheme=scheme, mode=mode,
                  stream_chunks=stream_chunks, fetch_ratio=fetch_ratio,
                  seed=seed)
    base = BenchConfig(num_ps=num_ps, num_workers=num_workers, mode=mode,
                       scheme=scheme, iovec_count=iovec_count, seed=seed,
                       network=network, transport="simulated",
                       stream_chunks=stream_chunks, fetch_ratio=fetch_ratio)
    spec = generate_spec(base)
    net = NETWORKS[network]
    serialized = mode == "serialized"
    rtt = net.rtt(spec, serialized=serialized)
    mbps = net.bandwidth(spec, serialized=serialized)
    families: Dict[str, dict] = {
        "p2p_latency": {"round_time_s": rtt, "throughput": 1.0 / rtt,
                        "metric": "rounds_per_s"},
        "p2p_bandwidth": {
            "round_time_s": spec.total_bytes / (mbps * 1e6),
            "throughput": mbps, "metric": "MBps"},
        "ps_throughput": {
            "round_time_s": net.ps_round_time(spec, num_ps, num_workers,
                                              serialized=serialized),
            "throughput": net.ps_throughput(spec, num_ps, num_workers,
                                            serialized=serialized),
            "metric": "rpcs_per_s"},
    }
    for fam in _BASELINE_EXCHANGES:
        st = run(replace(base, benchmark=fam))
        families[fam] = {"round_time_s": st.mean_s,
                         "throughput": st.derived["rpcs_per_s"],
                         "metric": "rpcs_per_s"}
    for algo in ALLREDUCE_ALGOS:
        st = run(replace(base, benchmark="allreduce", algo=algo))
        families[f"allreduce_{algo}"] = {
            "round_time_s": st.mean_s,
            "throughput": st.derived["rpcs_per_s"],
            "metric": "rpcs_per_s"}
    for tm in ("ps", "allreduce"):
        st = run(replace(base, benchmark="train_step", train_mode=tm))
        families[f"train_step_{tm}"] = {
            "round_time_s": st.mean_s,
            "throughput": st.derived["steps_per_s"],
            "metric": "steps_per_s"}
    # per-wire-mode coverage (schema 2): the paper's three-way
    # Ethernet/IPoIB/RDMA analogue as serialized / scatter_gather /
    # zero_copy — closed forms for the paper families, exact simulated
    # runs for the fabric families
    wire_modes: Dict[str, dict] = {}
    for wm in WIRE_MODES:
        mrtt = net.rtt(spec, mode=wm)
        mbw = net.bandwidth(spec, mode=wm)
        entry: Dict[str, dict] = {
            "p2p_latency": {"round_time_s": mrtt,
                            "throughput": 1.0 / mrtt,
                            "metric": "rounds_per_s"},
            "p2p_bandwidth": {
                "round_time_s": spec.total_bytes / (mbw * 1e6),
                "throughput": mbw, "metric": "MBps"},
            "ps_throughput": {
                "round_time_s": net.ps_round_time(spec, num_ps,
                                                  num_workers, mode=wm),
                "throughput": net.ps_throughput(spec, num_ps,
                                                num_workers, mode=wm),
                "metric": "rpcs_per_s"},
        }
        for fam in _BASELINE_EXCHANGES:
            st = run(replace(base, benchmark=fam, wire_mode=wm))
            entry[fam] = {"round_time_s": st.mean_s,
                          "throughput": st.derived["rpcs_per_s"],
                          "metric": "rpcs_per_s"}
        for algo in ALLREDUCE_ALGOS:
            st = run(replace(base, benchmark="allreduce", algo=algo,
                             wire_mode=wm))
            entry[f"allreduce_{algo}"] = {
                "round_time_s": st.mean_s,
                "throughput": st.derived["rpcs_per_s"],
                "metric": "rpcs_per_s"}
        for tm in ("ps", "allreduce"):
            st = run(replace(base, benchmark="train_step",
                             train_mode=tm, wire_mode=wm))
            entry[f"train_step_{tm}"] = {
                "round_time_s": st.mean_s,
                "throughput": st.derived["steps_per_s"],
                "metric": "steps_per_s"}
        wire_modes[wm] = entry
    return {"schema": BASELINE_SCHEMA, "config": config,
            "families": families, "wire_modes": wire_modes,
            "train_crossover": collect_train_crossover(network=network,
                                                       num_ps=num_ps),
            "perf_notes": PERF_NOTES}


def check_baseline(baseline: dict, rel_tol: float = 0.01) -> List[str]:
    """Diff a committed baseline dict against a fresh collection under
    its recorded config. Returns human-readable drift lines (empty =
    the run still matches within ``rel_tol`` relative tolerance)."""
    fresh = collect_baseline(**baseline.get("config", {}))
    problems: List[str] = []

    def diff(want: dict, got, label: str) -> None:
        if got is None:
            problems.append(f"{label}: family missing from fresh run")
            return
        for key in ("round_time_s", "throughput"):
            a, b = float(want[key]), float(got[key])
            rel = abs(b - a) / max(abs(a), 1e-30)
            if rel > rel_tol:
                problems.append(
                    f"{label}.{key}: baseline {a:.6g} vs fresh {b:.6g} "
                    f"(rel drift {rel:.3%} > tol {rel_tol:.3%})")

    for fam, want in baseline.get("families", {}).items():
        diff(want, fresh["families"].get(fam), fam)
    for wm, fams in baseline.get("wire_modes", {}).items():
        fresh_wm = fresh["wire_modes"].get(wm, {})
        for fam, want in fams.items():
            diff(want, fresh_wm.get(fam), f"{wm}/{fam}")
    cross = baseline.get("train_crossover")
    if cross is not None:
        got = collect_train_crossover(network=cross["network"],
                                      num_ps=cross["num_ps"])
        if got["allreduce_wins_from"] != cross["allreduce_wins_from"]:
            problems.append(
                f"train_crossover.allreduce_wins_from: baseline "
                f"{cross['allreduce_wins_from']} vs fresh "
                f"{got['allreduce_wins_from']}")
        fresh_pts = {p["workers"]: p for p in got["points"]}
        for p in cross["points"]:
            q = fresh_pts.get(p["workers"])
            label = f"train_crossover.w{p['workers']}"
            if q is None:
                problems.append(f"{label}: missing from fresh run")
                continue
            if q["winner"] != p["winner"]:
                problems.append(f"{label}.winner: baseline "
                                f"{p['winner']} vs fresh {q['winner']}")
            for key in ("ps_s", "allreduce_s"):
                a, b = float(p[key]), float(q[key])
                rel = abs(b - a) / max(abs(a), 1e-30)
                if rel > rel_tol:
                    problems.append(
                        f"{label}.{key}: baseline {a:.6g} vs fresh "
                        f"{b:.6g} (rel drift {rel:.3%} > tol "
                        f"{rel_tol:.3%})")
    return problems
