"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``):

  flash_attention — fused GQA attention forward (causal / sliding
                    window / softcap), replacing the Pallas TPU kernel
  payload_pack    — pack / unpack of iovec buffers into one contiguous
                    transfer (the serialized mode), replacing the two
                    Pallas TPU kernels of the same name
  rwkv6_scan      — chunked RWKV-6 WKV scan (prefill), replacing the
                    Pallas TPU kernel rwkv6_scan_kernel
  moe_decode      — the dropless MoE decode's expert FFN over its routed
                    experts alone; replaces no TPU kernel (the reference
                    leaves the expert products to XLA)
  ssd_scan        — the Mamba-2 chunked SSD scan (prefill); replaces no
                    TPU kernel (the reference runs it as einsums)
"""
