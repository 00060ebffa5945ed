from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import mamba_ssd_chunked, ssd_scan_plain

__all__ = ["ssd_scan", "mamba_ssd_chunked", "ssd_scan_plain"]
