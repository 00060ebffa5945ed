"""TF-gRPC-Bench CLI of the PyTorch port — the paper's Table 2, as
flags, plus the rpc-fabric families (fully_connected / ring / incast /
allreduce / train_step), one run per call.

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

--sweep and --workload (the cross-product sweep and the open-loop trace
driver of ``repro.launch.bench_comm``) are not ported yet and exit with
an error that names ROADMAP.md.
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
BENCHMARK_CHOICES = ("p2p_latency", "p2p_bandwidth", "ps_throughput",
                     "fully_connected", "ring", "incast", "allreduce",
                     "train_step")
TRANSPORT_CHOICES = ("collective", "loopback", "simulated", "cluster")


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


def main(argv: Optional[List[str]] = None) -> Optional[List[dict]]:
    """Parse, validate and run one benchmark; returns the result rows
    (None for the baseline actions)."""
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
    ap.add_argument("--workload", default=None, metavar="KIND",
                    help="open-loop workload mode: not ported yet "
                         "(ROADMAP.md)")
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
                    help="cross-product sweep: not ported yet "
                         "(ROADMAP.md)")
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

    for flag, val in (("--sweep", args.sweep),
                      ("--workload", args.workload)):
        if val is not None:
            ap.error(f"{flag} is not ported to repro_torch yet (ROADMAP.md, "
                     f"Queue 1); run repro.launch.bench_comm {flag} or a "
                     f"single benchmark here")
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
            and args.benchmark not in FABRIC_BENCHMARKS:
        ap.error("--deadline-s/--admission-limit need a fabric "
                 f"benchmark ({', '.join(FABRIC_BENCHMARKS)}); got "
                 f"--benchmark {args.benchmark}")
    if args.algo is not None and args.benchmark not in ALGO_BENCHMARKS:
        ap.error(f"--algo needs a collective benchmark "
                 f"({', '.join(ALGO_BENCHMARKS)}); got --benchmark "
                 f"{args.benchmark}")
    if args.train_mode is not None and args.benchmark != "train_step":
        ap.error(f"--train-mode needs --benchmark train_step; got "
                 f"--benchmark {args.benchmark}")
    if args.baseline_tolerance <= 0:
        ap.error(f"--baseline-tolerance must be > 0, got "
                 f"{args.baseline_tolerance}")
    if args.baseline is not None and args.check_baseline is not None:
        ap.error("--baseline and --check-baseline are mutually "
                 "exclusive (write a file OR diff against one)")
    if args.trace is not None:
        if args.baseline is not None or args.check_baseline is not None:
            ap.error("--trace records a benchmark run's spans, but "
                     "--baseline/--check-baseline collect modeled "
                     "numbers without running a benchmark; drop one "
                     "of the flags")
        if args.benchmark not in FABRIC_BENCHMARKS:
            ap.error(f"--trace needs a fabric benchmark "
                     f"({', '.join(FABRIC_BENCHMARKS)}); got "
                     f"--benchmark {args.benchmark}")

    if args.cluster_spec is not None:
        # parse + consistency in one place, before any work or output
        if args.transport != "cluster":
            ap.error("--cluster-spec needs --transport cluster")
        from repro_torch.rpc.cluster import load_cluster_spec
        try:
            args.cluster_spec = load_cluster_spec(args.cluster_spec)
        except (OSError, ValueError, KeyError, TypeError) as e:
            ap.error(f"--cluster-spec: {e}")

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


if __name__ == "__main__":
    main()
