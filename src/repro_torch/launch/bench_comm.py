"""TF-gRPC-Bench CLI of the PyTorch port — the paper's Table 2, as
flags, plus the rpc-fabric families (fully_connected / ring / incast /
allreduce / train_step): a single run, a --sweep or a --workload.

  PYTHONPATH=src python -m repro_torch.launch.bench_comm \
      --benchmark ps_throughput --num-ps 2 --num-workers 3 \
      --scheme skew --iovec-count 10 --mode serialized \
      --warmup 2 --duration 10 [--network rdma_edr] [--arch qwen3-8b]

  PYTHONPATH=src python -m repro_torch.launch.bench_comm \
      --benchmark fully_connected --num-workers 4 --transport collective
  PYTHONPATH=src python -m repro_torch.launch.bench_comm \
      --benchmark incast --num-workers 64 --transport simulated

The endpoints are the rows of tensors on ``--device`` (default cuda: the
GPU, where serialized mode packs and unpacks through the payload_pack
kernels; no card is an error, exit 2) or ``--device cpu`` (the plain
PyTorch path). The paper families and ``--transport collective`` place
the payload there, 8 endpoint rows; the modeled transports (simulated,
cluster) and loopback place nothing on the device.

--arch derives the payload from that architecture's parameter histogram
instead of the S/M/L generator (core.payload.from_arch) and benchmarks
THAT payload. --transport picks the rpc-fabric datapath for the fabric
families: collective (measured row permutations on the device), loopback
(measured shared-buffer memcpy), simulated (netmodel projection;
endpoint counts far beyond the device's rows), cluster (per-link
netmodel routing over a multi-endpoint ClusterSpec — pass
--cluster-spec with inline JSON or a file path, or get a homogeneous
cluster on --network; cluster rows carry per-endpoint interceptor
metrics). --fetch-ratio sizes the incast fetch payload relative to the
push. --wire-mode picks the rpc datapath encoding explicitly
(serialized | scatter_gather | zero_copy; default derives from --mode).
Fabric-family rows carry per-method interceptor metrics under
"rpc_metrics" and the tracer's per-phase latency breakdown under
"rpc_phases" in the --json output; --json writes the versioned envelope
{"schema": 3, "rows": [...]}.

--trace OUT.json exports the run's span trees as Chrome trace-event
JSON (load in Perfetto / chrome://tracing; one track per endpoint).
--baseline PATH collects the deterministic modeled round-time /
throughput of all families and writes the baseline file CI diffs;
--check-baseline PATH re-collects under the file's recorded config and
exits 1 on drift beyond --baseline-tolerance.

--sweep takes a comma-separated list of axes (scheme, mode, wire_mode,
payload, transport, benchmark, network, workers, stream_chunks, algo,
train_mode) and runs the cross-product of their values in one
invocation, one table (and one schema-3 row a cell under --json). Every
cell is one run on ``--device``'s rows: on the card its serialized
cells pack and unpack through the payload_pack kernels. A cell that
cannot run (allreduce on the collective transport, say) is reported as
a SKIPPED row with its error, as in the reference. A cell the card
fails (a kernel that does not build or launch, out of memory, a CUDA
error) stops the sweep with that error, and the CLI exits non-zero.

  PYTHONPATH=src python -m repro_torch.launch.bench_comm \
      --benchmark ring --transport collective --num-workers 4 \
      --arch qwen3-8b --sweep mode,stream_chunks --warmup 0.2 --duration 0.5

--workload switches the CLI from the closed-loop families to the
open-loop trace driver (``repro_torch.workload``): synthesize a seeded
arrival process (--workload poisson|bursty|diurnal with --rate and
--duration-s) or replay a recorded trace (--workload trace --trace-in
PATH), fire it against a serve cluster of synthetic (numpy) engines
behind real per-endpoint ServeSchedulers on the cluster transport
(--num-ps / --num-workers / --cluster-spec, --sched-policy,
--dispatch-policy), and print the SLO table. --trace-out records the
workload for exact replay; --fault-bursts N carves N correlated
burst-loss windows into the trace. The workload path is host-only, as in
the reference: it runs no model and places nothing on the device.

  PYTHONPATH=src python -m repro_torch.launch.bench_comm --device cpu \
      --workload poisson --rate 200 --duration-s 2 --trace-out t.json
  PYTHONPATH=src python -m repro_torch.launch.bench_comm --device cpu \
      --workload trace --trace-in t.json
"""
import argparse
import json
import sys
from typing import List, Optional

import torch

FABRIC_BENCHMARKS = ("fully_connected", "ring", "incast", "allreduce",
                     "train_step")
#: fabric families that read --algo (the collective schedule)
ALGO_BENCHMARKS = ("allreduce", "train_step")
WORKLOAD_CHOICES = ("poisson", "bursty", "diurnal", "trace")
BENCHMARK_CHOICES = ("p2p_latency", "p2p_bandwidth", "ps_throughput",
                     "fully_connected", "ring", "incast", "allreduce",
                     "train_step")
TRANSPORT_CHOICES = ("collective", "loopback", "simulated", "cluster")

#: values an axis takes when swept (benchmark sweeps over the fabric
#: families: the three paper benchmarks ignore --transport so crossing
#: them with transports would repeat identical runs). workers and
#: stream_chunks are the scaling axes — one invocation yields a
#: worker-count or chunk-count curve.
SWEEP_AXES = {
    "scheme": ("uniform", "random", "skew"),
    "mode": ("non_serialized", "serialized"),
    "wire_mode": ("serialized", "scatter_gather", "zero_copy"),
    "payload": ("small", "medium", "large"),
    "transport": TRANSPORT_CHOICES,
    "benchmark": FABRIC_BENCHMARKS,
    "network": None,     # filled from netmodel.NETWORKS lazily
    "workers": (2, 4, 8, 16),
    "stream_chunks": (1, 2, 4, 8),
    "algo": ("ring", "tree", "rsag"),
    "train_mode": ("ps", "allreduce"),
}

#: sweep axis -> BenchConfig field (identity unless listed)
AXIS_FIELD = {"workers": "num_workers"}


def _metric(st) -> str:
    return {"p2p_latency": "rtt_us", "p2p_bandwidth": "MBps",
            "train_step": "steps_per_s"}.get(st.name, "rpcs_per_s")


def _effective_network(cfg) -> Optional[str]:
    """The network model that actually priced the run: simulated cells
    fall back to eth40g when --network is unset (bench._make_fabric),
    and the report must say so rather than show a null. A cluster cell
    with an explicit spec prices per endpoint/link — labeled
    'cluster'."""
    if cfg.benchmark in FABRIC_BENCHMARKS:
        if cfg.transport == "cluster":
            return ("cluster" if cfg.cluster_spec is not None
                    else cfg.network or "eth40g")
        if cfg.transport == "simulated":
            return cfg.network or "eth40g"
    return cfg.network


def _build_config(args, payload_spec, **overrides):
    from repro_torch.configs.tfgrpc_bench import BenchConfig
    base = dict(
        benchmark=args.benchmark, num_ps=args.num_ps,
        num_workers=args.num_workers, mode=args.mode, scheme=args.scheme,
        skew_bias=args.skew_bias, iovec_count=args.iovec_count,
        small_bytes=args.small_bytes, medium_bytes=args.medium_bytes,
        large_bytes=args.large_bytes,
        categories=tuple(args.categories.split(",")),
        warmup_s=args.warmup, duration_s=args.duration, seed=args.seed,
        network=args.network, transport=args.transport,
        wire_mode=args.wire_mode,
        stream_chunks=args.stream_chunks, fetch_ratio=args.fetch_ratio,
        deadline_s=args.deadline_s, admission_limit=args.admission_limit,
        cluster_spec=args.cluster_spec, payload_spec=payload_spec,
        algo=args.algo or "ring",
        train_mode=args.train_mode or "allreduce",
        trace=args.trace is not None)
    base.update(overrides)
    return BenchConfig(**base)


def _print_single(st, cfg, args) -> None:
    scheme = st.spec.scheme
    tail = "/" + cfg.skew_bias if scheme == "skew" else ""
    extra = f", {cfg.transport}" if cfg.benchmark in FABRIC_BENCHMARKS \
        else ""
    wm = (f", wire={cfg.resolved_wire_mode}" if cfg.wire_mode is not None
          else "")
    print(f"benchmark      : {st.name} [{scheme}{tail}, {cfg.mode}"
          f"{wm}{extra}]")
    print(f"payload        : {st.spec.n_buffers} iovecs, "
          f"{st.spec.total_bytes/1e6:.3f} MB")
    if cfg.benchmark not in FABRIC_BENCHMARKS \
            or cfg.transport == "collective":
        print(f"device         : {_device_name(args.device)}")
    if cfg.benchmark in ALGO_BENCHMARKS:
        tm = (f", train_mode={cfg.train_mode}"
              if cfg.benchmark == "train_step" else "")
        print(f"collective     : algo={cfg.algo}{tm}")
    projected = (cfg.benchmark in FABRIC_BENCHMARKS
                 and cfg.transport in ("simulated", "cluster"))
    label = "net projected " if projected else "host measured "
    if projected:
        print(f"sim network    : {_effective_network(cfg)}")
    print(f"{label} : mean {st.mean_s*1e6:.1f} us  "
          f"p50 {st.p50_s*1e6:.1f}  p95 {st.p95_s*1e6:.1f}  "
          f"({st.n_iters} iters)")
    for k, v in st.derived.items():
        print(f"               : {k} = {v:.2f}")
    if st.resources:
        print(f"resources      : cpu_util {st.resources.cpu_util:.2f}  "
              f"rss_peak {st.resources.rss_peak_bytes/1e6:.0f} MB")
    nets = ([args.network] if args.network else
            sorted(st.model_projection))
    for n in nets:
        unit = {"p2p_latency": "s RTT", "p2p_bandwidth": "MB/s",
                "train_step": "steps/s"}.get(st.name, "RPC/s")
        print(f"model {n:12s}: {st.model_projection[n]:.6g} {unit}")
    _print_phases(st)


def _device_name(device: str) -> str:
    return torch.cuda.get_device_name() if device == "cuda" else "cpu"


def _print_phases(st) -> None:
    """Per-phase latency breakdown table (fabric families with a
    tracer): mean per-call time in each phase, per method."""
    if not st.rpc_phases:
        return
    from repro_torch.rpc.tracing import PHASES
    print("phase breakdown (mean us/call):")
    for meth in sorted(st.rpc_phases):
        rec = st.rpc_phases[meth]
        calls = max(1, rec["calls"])
        cells = "  ".join(
            f"{p} {rec['phases'].get(p, 0.0) / calls * 1e6:.1f}"
            for p in PHASES if rec["phases"].get(p, 0.0) > 0.0)
        print(f"  {meth:24s} {rec['calls']} calls  "
              f"e2e {rec['end_to_end_s'] / calls * 1e6:.1f}  {cells}")


def _card_errors() -> tuple:
    """What a cell raises when the card, not its configuration, fails
    it: a kernel that does not build or launch, the card out of memory,
    a CUDA error. These stop a sweep."""
    from repro_torch.kernels._build import KernelError
    return (KernelError, torch.OutOfMemoryError) + (
        (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
        else ())


def run_sweep(args, axes: List[str], payload_spec) -> List[dict]:
    """Run the cross-product of the swept axes' values; every cell is
    one bench.run on ``args.device``'s rows. Cells that cannot run
    (e.g. a collective cell needing more endpoints than the device
    has rows) are reported in the table rather than aborting the
    sweep; an error of the card (``_card_errors``) is raised."""
    import itertools

    from repro_torch.core import bench
    from repro_torch.core.netmodel import NETWORKS

    values = []
    for ax in axes:
        vals = SWEEP_AXES[ax]
        if ax == "network":
            vals = tuple(sorted(NETWORKS))
        if ax == "benchmark" and "stream_chunks" in axes:
            # crossing benchmark x stream_chunks only makes sense for
            # benchmarks that read the chunk count — fully_connected
            # would repeat identical rows dressed up as a curve
            vals = tuple(b for b in vals if b in ("ring", "incast"))
        if ax == "benchmark" and "algo" in axes:
            # likewise, only the collective families read --algo
            vals = tuple(b for b in vals if b in ALGO_BENCHMARKS)
        if ax == "benchmark" and "train_mode" in axes:
            vals = tuple(b for b in vals if b == "train_step")
        if ax == "payload":
            # the payload axis restricts the generator to ONE size
            # category per cell — a per-category S/M/L curve
            values.append([("categories", (v,)) for v in vals])
            continue
        values.append([(AXIS_FIELD.get(ax, ax), v) for v in vals])
    rows = []
    for combo in itertools.product(*values):
        overrides = dict(combo)
        cfg = _build_config(args, payload_spec, **overrides)
        row = {"benchmark": cfg.benchmark, "scheme": cfg.scheme,
               "mode": cfg.mode, "wire_mode": cfg.resolved_wire_mode,
               "network": _effective_network(cfg)}
        if "payload" in axes:
            row["payload"] = cfg.categories[0]
        if "workers" in axes:
            row["workers"] = cfg.num_workers
        if "stream_chunks" in axes:
            row["stream_chunks"] = cfg.stream_chunks
        if cfg.benchmark in ALGO_BENCHMARKS or "algo" in axes:
            row["algo"] = cfg.algo
        if cfg.benchmark == "train_step" or "train_mode" in axes:
            row["train_mode"] = cfg.train_mode
        if cfg.benchmark in FABRIC_BENCHMARKS:
            row["transport"] = cfg.transport
        try:
            st = bench.run(cfg, device=args.device)
        except (RuntimeError, ValueError) as e:
            if isinstance(e, _card_errors()):
                raise
            row.update(error=str(e).split(";")[0])
            rows.append(row)
            continue
        m = _metric(st)
        row.update(mean_us=st.mean_s * 1e6, p95_us=st.p95_s * 1e6,
                   n_iters=st.n_iters, metric=m,
                   value=st.derived.get(m, st.derived.get("rpcs_per_s")))
        if st.rpc_metrics:
            row["rpc_metrics"] = st.rpc_metrics
        if st.rpc_phases:
            row["rpc_phases"] = st.rpc_phases
        rows.append(row)
    return rows


def _print_sweep(rows: List[dict]) -> None:
    cols = ["benchmark", "scheme", "mode", "wire_mode", "transport",
            "network"]
    for extra in ("payload", "workers", "stream_chunks", "algo",
                  "train_mode"):                           # swept axes
        if any(extra in r for r in rows):
            cols.append(extra)
    n_id = len(cols)                             # identity columns
    cols += ["mean_us", "metric", "value"]
    widths = {c: max(len(c), *(len(_cell(r, c)) for r in rows))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    print("  ".join("-" * widths[c] for c in cols))
    for r in rows:
        if "error" in r:
            line = "  ".join(_cell(r, c).ljust(widths[c])
                             for c in cols[:n_id])
            print(f"{line}  SKIPPED: {r['error']}")
        else:
            print("  ".join(_cell(r, c).ljust(widths[c]) for c in cols))


def _cell(row: dict, col: str) -> str:
    v = row.get(col)
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def main(argv: Optional[List[str]] = None) -> Optional[List[dict]]:
    """Parse, validate and run one benchmark, a sweep or a workload;
    returns the result rows (None for the baseline actions)."""
    ap = argparse.ArgumentParser(
        description="TF-gRPC-Bench micro-benchmark suite (paper Table 2)")
    ap.add_argument("--benchmark", default="p2p_latency",
                    choices=list(BENCHMARK_CHOICES))
    ap.add_argument("--num-ps", type=int, default=1)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--transport", default="collective",
                    choices=list(TRANSPORT_CHOICES))
    ap.add_argument("--cluster-spec", default=None, metavar="JSON|PATH",
                    help="cluster transport topology: inline ClusterSpec "
                         "JSON or a path to a JSON file (default: a "
                         "homogeneous cluster on --network)")
    ap.add_argument("--stream-chunks", type=int, default=4,
                    help="chunks per stream (ring/incast families)")
    ap.add_argument("--algo", default=None,
                    choices=["ring", "tree", "rsag"],
                    help="allreduce/train_step families: the "
                         "collective schedule (ring = bandwidth-"
                         "optimal rotation, tree = binomial "
                         "reduce+broadcast, rsag = reduce-scatter + "
                         "allgather; default ring)")
    ap.add_argument("--train-mode", default=None,
                    choices=["ps", "allreduce"],
                    help="train_step family: gradient-synchronization "
                         "layout — ps shards parameters across "
                         "--num-ps server endpoints (push/fetch "
                         "flights), allreduce reduces with the --algo "
                         "schedule across --num-workers (default "
                         "allreduce); run both across worker counts "
                         "to find the crossover")
    ap.add_argument("--fetch-ratio", type=float, default=1.0,
                    help="incast: fetch payload as a fraction/multiple "
                         "of the push payload (1.0 = symmetric)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="fabric families: default per-call deadline "
                         "(relative s), propagated to servers in the "
                         "frame header — servers shed expired work; "
                         "shed/deadline counts land in rpc_metrics")
    ap.add_argument("--admission-limit", type=int, default=None,
                    help="fabric families: per-endpoint outstanding-"
                         "call cap enforced by server-side admission "
                         "control (rejected calls retry; rejected "
                         "counts land in rpc_metrics)")
    ap.add_argument("--workload", default=None,
                    choices=list(WORKLOAD_CHOICES),
                    help="open-loop workload mode: synthesize a seeded "
                         "arrival process (poisson/bursty/diurnal, "
                         "needs --rate and --duration-s) or replay a "
                         "recorded trace (trace, needs --trace-in) "
                         "against a synthetic serve cluster, and "
                         "report SLOs instead of closed-loop "
                         "throughput (host only: no device work)")
    ap.add_argument("--rate", type=float, default=None,
                    help="workload generators: offered load in req/s")
    ap.add_argument("--duration-s", type=float, default=None,
                    help="workload generators: trace horizon in "
                         "modeled seconds")
    ap.add_argument("--trace-in", default=None, metavar="PATH",
                    help="--workload trace: recorded trace to replay "
                         "(mutually exclusive with the generator "
                         "flags)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="workload mode: record the trace (arrivals, "
                         "shapes, fault windows) for exact replay")
    ap.add_argument("--prompt-dist", default="lognormal",
                    choices=["lognormal", "zipf", "small", "medium",
                             "large"],
                    help="workload generators: prompt-length sampler "
                         "(heavy-tailed lognormal/zipf, or a fixed "
                         "paper size category)")
    ap.add_argument("--sched-policy", default="fifo",
                    choices=["fifo", "sjf"],
                    help="workload mode: per-endpoint serve scheduler "
                         "admission policy")
    ap.add_argument("--dispatch-policy", default="round_robin",
                    choices=["round_robin", "least_loaded",
                             "scheduler_least_loaded"],
                    help="workload mode: sharded dispatch policy "
                         "across ps endpoints")
    ap.add_argument("--starvation-age-s", type=float, default=None,
                    help="workload mode, --sched-policy sjf: waits "
                         "past this age regain FIFO priority")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="workload mode: per-endpoint continuous-"
                         "batching admission cap")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="workload mode: per-endpoint KV-cache block "
                         "budget (None = unbounded; small values "
                         "exercise preemption)")
    ap.add_argument("--fault-bursts", type=int, default=0,
                    help="workload generators: carve this many "
                         "correlated burst-loss windows into the "
                         "trace (replayed with it)")
    ap.add_argument("--fault-burst-width-s", type=float, default=0.5,
                    help="width of each --fault-bursts window "
                         "(modeled seconds)")
    ap.add_argument("--mode", default="non_serialized",
                    choices=["non_serialized", "serialized"])
    ap.add_argument("--wire-mode", default=None,
                    choices=["serialized", "scatter_gather",
                             "zero_copy"],
                    help="rpc datapath encoding (default derives from "
                         "--mode: serialized -> serialized, "
                         "non_serialized -> scatter_gather); zero_copy "
                         "ships pre-registered shared-pool descriptors "
                         "instead of payload bytes (unsupported on "
                         "--transport collective)")
    ap.add_argument("--scheme", default="uniform",
                    choices=["uniform", "random", "skew"])
    ap.add_argument("--skew-bias", default="large",
                    choices=["large", "medium", "small"])
    ap.add_argument("--iovec-count", type=int, default=10)
    ap.add_argument("--small-bytes", type=int, default=10)
    ap.add_argument("--medium-bytes", type=int, default=10 * 1024)
    ap.add_argument("--large-bytes", type=int, default=1024 * 1024)
    ap.add_argument("--categories", default="small,medium,large")
    ap.add_argument("--warmup", type=float, default=2.0)
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--network", default=None,
                    help="print only this network's projection")
    ap.add_argument("--arch", default=None,
                    help="payload from this arch's parameter histogram")
    ap.add_argument("--sweep", default=None, metavar="AXES",
                    help="comma-separated axes to cross-product in one "
                         f"run: {','.join(SWEEP_AXES)}")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the result rows as a versioned "
                         "JSON envelope {schema: 3, rows: [...]} "
                         "('-' for stdout)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="fabric families, single run: export the "
                         "run's span trees as Chrome trace-event JSON "
                         "(Perfetto / chrome://tracing)")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="collect the deterministic modeled baseline "
                         "(round time + throughput, all six families) "
                         "and write it to PATH, then exit")
    ap.add_argument("--check-baseline", default=None, metavar="PATH",
                    help="re-collect under PATH's recorded config and "
                         "exit 1 on drift beyond --baseline-tolerance")
    ap.add_argument("--baseline-tolerance", type=float, default=0.01,
                    help="relative drift tolerance for "
                         "--check-baseline (default 0.01 = 1%%)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the endpoints' rows live (default cuda: "
                         "the GPU, through the payload_pack kernels; no "
                         "card is an error); cpu runs the plain path")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible "
                 "(torch.cuda.is_available() is False); pass --device cpu "
                 "for the plain PyTorch path")

    # --categories: validate against the payload generator's known
    # buffer categories instead of silently generating from nothing
    from repro_torch.core.payload import CATEGORIES
    cats = tuple(c for c in args.categories.split(",") if c)
    unknown = [c for c in cats if c not in CATEGORIES]
    if unknown or not cats:
        ap.error(f"--categories: unknown categor"
                 f"{'y' if len(unknown) == 1 else 'ies'} "
                 f"{', '.join(repr(c) for c in unknown) or '(empty)'}; "
                 f"choose from {', '.join(CATEGORIES)}")
    args.categories = ",".join(cats)

    if args.mode == "serialized" and args.wire_mode in (
            "scatter_gather", "zero_copy"):
        ap.error(f"--wire-mode {args.wire_mode} contradicts --mode "
                 "serialized; drop one of the two flags")

    if args.fetch_ratio <= 0:
        ap.error(f"--fetch-ratio must be > 0, got {args.fetch_ratio}")
    if args.deadline_s is not None and args.deadline_s <= 0:
        ap.error(f"--deadline-s must be > 0, got {args.deadline_s}")
    if args.admission_limit is not None and args.admission_limit < 1:
        ap.error(f"--admission-limit must be >= 1, got "
                 f"{args.admission_limit}")
    if (args.deadline_s is not None or args.admission_limit is not None) \
            and args.benchmark not in FABRIC_BENCHMARKS \
            and args.sweep is None and args.workload is None:
        ap.error("--deadline-s/--admission-limit need a fabric "
                 f"benchmark ({', '.join(FABRIC_BENCHMARKS)}); got "
                 f"--benchmark {args.benchmark}")
    if args.algo is not None and args.benchmark not in ALGO_BENCHMARKS \
            and args.sweep is None and args.workload is None:
        ap.error(f"--algo needs a collective benchmark "
                 f"({', '.join(ALGO_BENCHMARKS)}); got --benchmark "
                 f"{args.benchmark}")
    if args.train_mode is not None and args.benchmark != "train_step" \
            and args.sweep is None and args.workload is None:
        ap.error(f"--train-mode needs --benchmark train_step; got "
                 f"--benchmark {args.benchmark}")
    if args.baseline_tolerance <= 0:
        ap.error(f"--baseline-tolerance must be > 0, got "
                 f"{args.baseline_tolerance}")
    if args.baseline is not None and args.check_baseline is not None:
        ap.error("--baseline and --check-baseline are mutually "
                 "exclusive (write a file OR diff against one)")
    if args.trace is not None:
        if args.sweep is not None:
            ap.error("--trace needs a single run, not --sweep (one "
                     "trace file per run)")
        if args.baseline is not None or args.check_baseline is not None:
            ap.error("--trace records a benchmark run's spans, but "
                     "--baseline/--check-baseline collect modeled "
                     "numbers without running a benchmark; drop one "
                     "of the flags")
        if args.benchmark not in FABRIC_BENCHMARKS:
            ap.error(f"--trace needs a fabric benchmark "
                     f"({', '.join(FABRIC_BENCHMARKS)}); got "
                     f"--benchmark {args.benchmark}")

    # open-loop workload flags vs the closed-loop paper families:
    # every combination is either meaningful or a loud error, never a
    # silently ignored flag
    if args.workload is None:
        used = [name for name, val in (
            ("--rate", args.rate),
            ("--duration-s", args.duration_s),
            ("--trace-in", args.trace_in),
            ("--trace-out", args.trace_out),
            ("--starvation-age-s", args.starvation_age_s),
            ("--kv-blocks", args.kv_blocks),
            ("--fault-bursts", args.fault_bursts or None),
        ) if val is not None]
        if args.sched_policy != "fifo":
            used.append("--sched-policy")
        if args.dispatch_policy != "round_robin":
            used.append("--dispatch-policy")
        if used:
            ap.error(f"{', '.join(used)}: open-loop workload flag"
                     f"{'s' if len(used) > 1 else ''} without "
                     f"--workload — the closed-loop paper families "
                     f"pace themselves on completions; pass "
                     f"--workload {{{', '.join(WORKLOAD_CHOICES)}}} "
                     f"for an open-loop run")
    else:
        for flag, val in (("--sweep", args.sweep),
                          ("--trace", args.trace),
                          ("--baseline", args.baseline),
                          ("--check-baseline", args.check_baseline),
                          ("--arch", args.arch),
                          ("--algo", args.algo),
                          ("--train-mode", args.train_mode)):
            if val is not None:
                ap.error(f"--workload is a standalone open-loop run; "
                         f"it cannot combine with {flag}")
        if args.fault_bursts < 0:
            ap.error(f"--fault-bursts must be >= 0, got "
                     f"{args.fault_bursts}")
        if args.fault_burst_width_s <= 0:
            ap.error(f"--fault-burst-width-s must be > 0, got "
                     f"{args.fault_burst_width_s}")
        if args.max_batch < 1:
            ap.error(f"--max-batch must be >= 1, got {args.max_batch}")
        if args.kv_blocks is not None and args.kv_blocks < 1:
            ap.error(f"--kv-blocks must be >= 1, got {args.kv_blocks}")
        if args.workload == "trace":
            if args.trace_in is None:
                ap.error("--workload trace replays a recorded trace; "
                         "pass --trace-in PATH")
            fixed = [n for n, v in (("--rate", args.rate),
                                    ("--duration-s", args.duration_s))
                     if v is not None]
            if args.fault_bursts:
                fixed.append("--fault-bursts")
            if fixed:
                ap.error(f"{', '.join(fixed)}: a replayed trace "
                         f"already fixes its arrivals and fault "
                         f"schedule; generator flags are mutually "
                         f"exclusive with --trace-in")
        else:
            if args.trace_in is not None:
                ap.error("--trace-in implies --workload trace; the "
                         f"{args.workload} generator synthesizes its "
                         "own arrivals")
            if args.rate is None or args.duration_s is None:
                ap.error(f"--workload {args.workload} is open-loop: "
                         f"it needs --rate (req/s) and --duration-s")
            if args.rate <= 0:
                ap.error(f"--rate must be > 0, got {args.rate}")
            if args.duration_s <= 0:
                ap.error(f"--duration-s must be > 0, got "
                         f"{args.duration_s}")

    axes = None
    if args.sweep is not None:
        axes = [a.strip() for a in args.sweep.split(",") if a.strip()]
        bad = [a for a in axes if a not in SWEEP_AXES]
        if bad or not axes:
            ap.error(f"--sweep: unknown axes {bad or '(empty)'}; choose "
                     f"from {', '.join(SWEEP_AXES)}")
        dups = sorted({a for a in axes if axes.count(a) > 1})
        if dups:
            ap.error(f"--sweep: duplicate ax"
                     f"{'is' if len(dups) == 1 else 'es'} "
                     f"{', '.join(repr(a) for a in dups)}; each axis "
                     f"may appear once")
        if "transport" in axes and "benchmark" not in axes \
                and args.benchmark not in FABRIC_BENCHMARKS:
            ap.error(f"--sweep transport needs a fabric benchmark "
                     f"({', '.join(FABRIC_BENCHMARKS)}); "
                     f"got --benchmark {args.benchmark}")
        # the scaling axes only scale benchmarks that read them —
        # sweeping them elsewhere would print identical rows dressed
        # up as a curve
        workers_ok = FABRIC_BENCHMARKS + ("ps_throughput",)
        if "workers" in axes and "benchmark" not in axes \
                and args.benchmark not in workers_ok:
            ap.error(f"--sweep workers needs a benchmark that scales "
                     f"with workers ({', '.join(workers_ok)}); "
                     f"got --benchmark {args.benchmark}")
        streaming_ok = ("ring", "incast")
        if "stream_chunks" in axes \
                and args.benchmark not in streaming_ok \
                and "benchmark" not in axes:
            ap.error(f"--sweep stream_chunks needs a streaming "
                     f"benchmark ({', '.join(streaming_ok)}); "
                     f"got --benchmark {args.benchmark}")
        if "algo" in axes and args.benchmark not in ALGO_BENCHMARKS \
                and "benchmark" not in axes:
            ap.error(f"--sweep algo needs a collective benchmark "
                     f"({', '.join(ALGO_BENCHMARKS)}); got "
                     f"--benchmark {args.benchmark}")
        if "train_mode" in axes and args.benchmark != "train_step" \
                and "benchmark" not in axes:
            ap.error(f"--sweep train_mode needs --benchmark "
                     f"train_step; got --benchmark {args.benchmark}")
        if "stream_chunks" in axes and ("algo" in axes
                                        or "train_mode" in axes):
            # no benchmark reads both the chunk count and the
            # collective axes — the cross-product would be empty
            ap.error("--sweep stream_chunks cannot cross algo/"
                     "train_mode: no benchmark reads both")

    if args.cluster_spec is not None:
        # parse + consistency in one place, before any work or output
        if args.transport != "cluster" \
                and not (axes and "transport" in axes) \
                and args.workload is None:
            ap.error("--cluster-spec needs --transport cluster, a "
                     "transport sweep axis, or --workload")
        from repro_torch.rpc.cluster import load_cluster_spec
        try:
            args.cluster_spec = load_cluster_spec(args.cluster_spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            ap.error(f"--cluster-spec: {e}")

    if args.workload is not None:
        rows = run_workload(args, ap)
        _write_json(args, rows)
        return rows

    from repro_torch.core import bench

    # baseline telemetry actions are standalone: collect/diff the
    # deterministic modeled numbers and exit without running a bench
    if args.check_baseline is not None:
        try:
            with open(args.check_baseline) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:
            ap.error(f"--check-baseline: {e}")
        problems = bench.check_baseline(
            data, rel_tol=args.baseline_tolerance)
        if problems:
            for p in problems:
                print(f"BASELINE DRIFT: {p}")
            sys.exit(1)
        n_wm = len(data.get("wire_modes", {}))
        print(f"baseline OK: {len(data.get('families', {}))} families"
              f"{f' x {n_wm} wire modes' if n_wm else ''} "
              f"within {args.baseline_tolerance:.2%}")
        return
    if args.baseline is not None:
        kw = {"network": args.network} if args.network else {}
        data = bench.collect_baseline(**kw)
        text = json.dumps(data, indent=2, sort_keys=True)
        if args.baseline == "-":
            sys.stdout.write(text + "\n")
        else:
            with open(args.baseline, "w") as f:
                f.write(text + "\n")
            print(f"wrote baseline ({len(data['families'])} families, "
                  f"{data['config']['network']}) to {args.baseline}")
        return

    payload_spec = None
    if args.arch:
        from repro_torch.configs import get_config
        from repro_torch.core.payload import from_arch
        payload_spec = from_arch(get_config(args.arch), seed=args.seed)
        print(f"payload from {args.arch}: {payload_spec.n_buffers} "
              f"buffers, {payload_spec.total_bytes/1e6:.2f} MB "
              f"({', '.join(payload_spec.categories)})")

    if axes is not None:
        rows = run_sweep(args, axes, payload_spec)
        _print_sweep(rows)
        _write_json(args, rows)
        return rows
    cfg = _build_config(args, payload_spec)
    st = bench.run(cfg, device=args.device)
    _print_single(st, cfg, args)
    m = _metric(st)
    rows = [{"benchmark": st.name, "scheme": st.spec.scheme,
             "mode": cfg.mode, "transport": cfg.transport,
             "network": _effective_network(cfg),
             "mean_us": st.mean_s * 1e6,
             "p95_us": st.p95_s * 1e6, "n_iters": st.n_iters,
             "metric": m,
             "value": st.derived.get(m, st.derived.get("rpcs_per_s"))}]
    if st.rpc_metrics:
        rows[0]["rpc_metrics"] = st.rpc_metrics
    if st.rpc_phases:
        rows[0]["rpc_phases"] = st.rpc_phases
    if args.trace:
        if st.tracer is None:
            ap.error(f"--trace: the {cfg.transport} run attached "
                     f"no tracer")
        st.tracer.export_chrome(args.trace)
        print(f"wrote Chrome trace ({len(st.tracer.spans())} "
              f"spans) to {args.trace}")
    _write_json(args, rows)
    return rows


def _write_json(args, rows: List[dict]) -> None:
    if not args.json:
        return
    text = json.dumps({"schema": 3, "rows": rows}, indent=2)
    if args.json == "-":
        sys.stdout.write(text + "\n")
    else:
        with open(args.json, "w") as f:
            f.write(text + "\n")
        print(f"wrote {len(rows)} row(s) to {args.json}")


def run_workload(args, ap) -> List[dict]:
    """Open-loop workload mode: build/replay the trace, serve it, and
    print the SLO table. Returns the schema-3 workload row."""
    from repro_torch.workload import (Trace, correlated_burst_windows,
                                      format_slo_table, serve_workload,
                                      synthesize_trace)
    if args.workload == "trace":
        try:
            trace = Trace.load(args.trace_in)
        except (OSError, ValueError, KeyError, TypeError) as e:
            ap.error(f"--trace-in: {e}")
    else:
        trace = synthesize_trace(args.workload, args.rate,
                                 args.duration_s, seed=args.seed,
                                 prompt_kind=args.prompt_dist)
        if args.fault_bursts:
            correlated_burst_windows(
                trace, n_windows=args.fault_bursts,
                width_s=args.fault_burst_width_s)
    if args.trace_out:
        trace.save(args.trace_out)
        print(f"wrote trace ({len(trace)} events, "
              f"{len(trace.fault_windows)} fault windows) to "
              f"{args.trace_out}")
    try:
        run = serve_workload(
            trace, cluster=args.cluster_spec, n_ps=args.num_ps,
            n_workers=args.num_workers,
            dispatch_policy=args.dispatch_policy,
            sched_policy=args.sched_policy,
            starvation_age_s=args.starvation_age_s,
            max_batch=args.max_batch, kv_blocks=args.kv_blocks,
            deadline_s=args.deadline_s)
    except ValueError as e:
        ap.error(f"--workload: {e}")
    kind = trace.meta.get("kind", "trace")
    print(f"workload       : {kind} [{len(trace)} events over "
          f"{trace.duration_s:.3f} s, seed {trace.seed}]")
    print(f"serving        : {args.num_ps} ps x {args.num_workers} "
          f"workers, sched {args.sched_policy}, dispatch "
          f"{args.dispatch_policy}")
    if trace.fault_windows:
        print(f"fault windows  : {len(trace.fault_windows)} "
              f"correlated burst-loss window"
              f"{'s' if len(trace.fault_windows) > 1 else ''}")
    print(format_slo_table(run.report))
    return [{
        "benchmark": "workload", "workload": kind,
        "events": len(trace), "seed": trace.seed,
        "sched_policy": args.sched_policy,
        "dispatch_policy": args.dispatch_policy,
        "fault_windows": len(trace.fault_windows),
        "slo": run.report.to_dict(),
        "rpc_metrics": run.metrics.snapshot(gauges=True),
    }]


if __name__ == "__main__":
    main()
