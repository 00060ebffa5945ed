"""repro_torch.core — the paper's contribution: the TF-gRPC-Bench
micro-benchmark suite, with the endpoints as rows of tensors on one card.

The bench drivers are lazy (PEP 562): payload/netmodel are pure
numpy, and importing them (e.g. from repro_torch.rpc's simulated
transport) must not drag in torch.
"""
from repro_torch.core.netmodel import NETWORKS, NetworkModel, paper_ratio_report
from repro_torch.core.payload import PayloadSpec, from_arch, generate_spec

__all__ = ["BenchStats", "fully_connected", "incast", "p2p_bandwidth",
           "p2p_latency", "ps_throughput", "ring", "run", "NETWORKS",
           "NetworkModel", "paper_ratio_report", "PayloadSpec",
           "from_arch", "generate_spec"]

_BENCH_EXPORTS = {"BenchStats", "fully_connected", "incast",
                  "p2p_bandwidth", "p2p_latency", "ps_throughput",
                  "ring", "run"}


def __getattr__(name):
    if name in _BENCH_EXPORTS:
        from repro_torch.core import bench
        return getattr(bench, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
