"""Quickstart of the PyTorch port: the paper's three micro-benchmarks in
a few lines, with the endpoints as rows of tensors on one card.

    PYTHONPATH=src python examples/torch_quickstart.py            # the card
    PYTHONPATH=src python examples/torch_quickstart.py --quick --device cpu

Runs TF-gRPC-P2P-Latency / -Bandwidth / -PS-Throughput with the paper's
default payloads, non-serialized and serialized (on the card serialized
mode packs and unpacks through the hand-written payload_pack kernels),
and prints the measured numbers next to the netmodel projections for
the paper's clusters. The projections are the model's, not the card's.
"""
import argparse
from typing import List, Optional

import torch

from repro_torch.configs.tfgrpc_bench import BenchConfig
from repro_torch.core import bench

NETS = ("eth40g", "ipoib_edr", "rdma_edr")


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny warmup/duration (a smoke run)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible; pass --device cpu")
    times = (dict(warmup_s=0.0, duration_s=0.05) if args.quick
             else dict(warmup_s=0.3, duration_s=1.0))
    where = (torch.cuda.get_device_name() if args.device == "cuda"
             else "cpu")
    print(f"endpoints: 8 rows on {where}")

    results = []
    for mode in ("non_serialized", "serialized"):
        for scheme in ("uniform", "random", "skew"):
            st = bench.run(BenchConfig(scheme=scheme, mode=mode, **times),
                           device=args.device)
            proj = {k: f"{v * 1e6:.0f}us" for k, v in
                    st.model_projection.items() if k in NETS}
            print(f"P2P-Latency   [{scheme:7s} {mode:14s}] "
                  f"mean={st.mean_s * 1e6:8.1f}us "
                  f"p95={st.p95_s * 1e6:8.1f}us  projections={proj}")
            results.append(st)
        st = bench.run(BenchConfig(benchmark="p2p_bandwidth", scheme="skew",
                                   mode=mode, **times), device=args.device)
        print(f"P2P-Bandwidth [skew    {mode:14s}] "
              f"{st.derived['MBps']:10.1f} MB/s  projections(MB/s)="
              f"{ {k: round(st.model_projection[k]) for k in NETS} }")
        results.append(st)
        st = bench.run(BenchConfig(benchmark="ps_throughput", num_ps=2,
                                   num_workers=3, mode=mode, **times),
                       device=args.device)
        print(f"PS-Throughput [2PSx3W  {mode:14s}] "
              f"{st.derived['rpcs_per_s']:10.1f} RPC/s  projections(RPC/s)="
              f"{ {k: round(st.model_projection[k]) for k in NETS} }")
        results.append(st)
    print(f"resources: cpu_util={st.resources.cpu_util:.2f} "
          f"rss_peak={st.resources.rss_peak_bytes / 1e6:.0f}MB")
    return results


if __name__ == "__main__":
    main()
