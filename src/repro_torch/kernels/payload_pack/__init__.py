from repro_torch.kernels.payload_pack.ops import LANE, pack, to_card, unpack
from repro_torch.kernels.payload_pack.ref import pack_plain, unpack_plain

__all__ = ["LANE", "pack", "unpack", "pack_plain", "unpack_plain",
           "to_card"]
