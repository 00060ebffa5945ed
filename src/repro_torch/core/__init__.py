"""repro_torch.core — the numpy payload generator and network model the
rpc fabric prices flights with (copies of ``repro.core.payload`` and
``repro.core.netmodel``). The benchmark drivers are not ported yet."""
from repro_torch.core.netmodel import NETWORKS, NetworkModel, paper_ratio_report
from repro_torch.core.payload import PayloadSpec, from_arch, generate_spec

__all__ = ["NETWORKS", "NetworkModel", "paper_ratio_report", "PayloadSpec",
           "from_arch", "generate_spec"]
