"""The paper's own configuration space (TF-gRPC-Bench, Table 1 + Table 2).

Buffer-size categories and benchmark defaults exactly as published;
consumed by repro_torch.core (payload generator + benchmark drivers).
"""
from dataclasses import dataclass, field
from typing import Optional, Tuple


# Table 1 — iovec buffer size categories (bytes)
SMALL_DEFAULT = 10
MEDIUM_DEFAULT = 10 * 1024
LARGE_DEFAULT = 1 * 1024 * 1024
SMALL_RANGE = (1, 1024)                         # [1 B, 1 KB)
MEDIUM_RANGE = (1024, 1024 * 1024)              # [1 KB, 1 MB)
LARGE_RANGE = (1024 * 1024, 10 * 1024 * 1024)   # [1 MB, 10 MB]

# Skew scheme default composition (paper §3.2): 60% Large / 30% Medium / 10% Small
SKEW_FRACTIONS = {"large": 0.6, "medium": 0.3, "small": 0.1}
# §3.2: "users have the option to generate the payload in Small or
# Medium biased manner too" — same 60/30/10 split, rotated.
SKEW_BIAS_FRACTIONS = {
    "large":  {"large": 0.6, "medium": 0.3, "small": 0.1},
    "medium": {"medium": 0.6, "large": 0.3, "small": 0.1},
    "small":  {"small": 0.6, "medium": 0.3, "large": 0.1},
}


@dataclass(frozen=True)
class BenchConfig:
    """Table 2 — configurable parameters of TF-gRPC-Bench, extended with
    the rpc-fabric benchmark families (fully_connected / ring / incast
    + transport)."""
    # p2p_latency | p2p_bandwidth | ps_throughput | fully_connected
    # | ring | incast | allreduce | train_step
    benchmark: str = "p2p_latency"
    num_ps: int = 1
    num_workers: int = 1
    mode: str = "non_serialized"     # non_serialized | serialized
    # wire mode of the rpc datapath: serialized | scatter_gather |
    # zero_copy. None derives it from `mode` (serialized ->
    # "serialized", non_serialized -> "scatter_gather"); set it
    # explicitly to reach the zero-copy shared-buffer-pool tier.
    # An explicit value wins over `mode`.
    wire_mode: Optional[str] = None
    scheme: str = "uniform"          # uniform | random | skew
    skew_bias: str = "large"         # large | medium | small (skew only)
    iovec_count: int = 10
    small_bytes: int = SMALL_DEFAULT
    medium_bytes: int = MEDIUM_DEFAULT
    large_bytes: int = LARGE_DEFAULT
    categories: Tuple[str, ...] = ("small", "medium", "large")
    warmup_s: float = 2.0
    duration_s: float = 10.0
    seed: int = 0
    dtype: str = "uint8"
    network: Optional[str] = None    # key into core.netmodel.NETWORKS
    # rpc fabric transport: collective | loopback | simulated | cluster
    # (fabric families only; the three paper benchmarks are collective)
    transport: str = "collective"
    # cluster transport topology: a repro_torch.rpc.ClusterSpec (or dict/JSON
    # accepted by rpc.as_cluster_spec). None synthesizes a homogeneous
    # cluster of the needed size on `network`
    cluster_spec: Optional[object] = None
    # chunks per stream for the ring/incast streaming families
    stream_chunks: int = 4
    # incast asymmetry: the fetch payload is this fraction/multiple of
    # the push payload (1.0 = symmetric; 0.25 models a small variable
    # pull against a large gradient push)
    fetch_ratio: float = 1.0
    # allreduce/train_step families: the collective schedule
    # (ring | tree | rsag, keys of netmodel.ALLREDUCE_ALGOS)
    algo: str = "ring"
    # train_step family: gradient-synchronization layout
    # (ps = sharded parameter servers; allreduce = cfg.algo collective)
    train_mode: str = "allreduce"
    # failure-semantics axes (fabric families only): a default per-call
    # deadline (relative seconds, propagated to servers in the frame
    # header) and a per-endpoint admission limit — both surface their
    # shed/rejected/retry counts in the rpc_metrics report
    deadline_s: Optional[float] = None
    admission_limit: Optional[int] = None
    # explicit payload override (e.g. --arch): a core.payload.PayloadSpec;
    # when set, the S/M/L generator fields above are ignored
    payload_spec: Optional[object] = None
    # attach a rpc.Tracer to the fabric even on measured transports
    # (modeled transports always trace — spans cost nothing on the
    # modeled clock); bench_comm --trace exports the Chrome JSON
    trace: bool = False

    @property
    def resolved_wire_mode(self) -> str:
        """The effective wire mode: explicit ``wire_mode`` wins, else
        derived from the paper's two-valued ``mode`` field."""
        if self.wire_mode is not None:
            return self.wire_mode
        return ("serialized" if self.mode == "serialized"
                else "scatter_gather")


# §4.5 experiment: 2 parameter servers, 3 workers
PS_THROUGHPUT_CONFIG = BenchConfig(
    benchmark="ps_throughput", num_ps=2, num_workers=3)
