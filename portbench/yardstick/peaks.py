"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). Every roofline and mfu of the
benchmark is a share of these; the run prints the card's power limit
beside them."""

BF16_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s
FP32_FLOPS = 67e12         # fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12          # HBM3 bytes/s
