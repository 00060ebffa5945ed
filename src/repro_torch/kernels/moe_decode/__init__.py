from repro_torch.kernels.moe_decode.ops import moe_decode_ffn
from repro_torch.kernels.moe_decode.ref import moe_decode_plain

__all__ = ["moe_decode_ffn", "moe_decode_plain"]
