"""Communication scaling sweeps of the PyTorch port, driven through its
``bench_comm`` CLI, as ``examples/comm_benchmark_sweep.py`` drives the
reference's: one ``--sweep`` invocation, the streaming fabric families
(ring / incast) crossed with the worker-count and chunk-count scaling
axes, one table (per-row ``rpc_metrics`` included in --json).

    PYTHONPATH=src python examples/torch_comm_benchmark_sweep.py [--quick]
        [--transport simulated|cluster|loopback|collective]
        [--network rdma_edr] [--json rows.json] [--device cuda|cpu]

The default ``simulated`` transport prices every cell analytically, so
the 2x4x4 cross-product runs in seconds and places nothing on the card;
``--transport collective`` measures the cells that fit the 8 endpoint
rows on ``--device`` (16 workers do not, and show as SKIPPED rows).
"""
import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny warmup/duration (smoke-test config)")
    ap.add_argument("--transport", default="simulated")
    ap.add_argument("--network", default=None)
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.launch import bench_comm

    warmup, duration = ("0.05", "0.1") if args.quick else ("0.5", "2.0")
    bench_args = [
        "--sweep", "benchmark,workers,stream_chunks",
        "--transport", args.transport,
        "--warmup", warmup, "--duration", duration,
        "--device", args.device,
    ]
    if args.network:
        bench_args += ["--network", args.network]
    if args.json:
        bench_args += ["--json", args.json]
    return bench_comm.main(bench_args)


if __name__ == "__main__":
    main()
