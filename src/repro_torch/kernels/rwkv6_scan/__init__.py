from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_ref, rwkv6_scan_plain

__all__ = ["rwkv6_scan", "rwkv6_ref", "rwkv6_scan_plain"]
