"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``):

  flash_attention — fused GQA attention forward (causal / sliding
                    window / softcap), replacing the Pallas TPU kernel
  payload_pack    — pack / unpack of iovec buffers into one contiguous
                    transfer (the serialized mode), replacing the two
                    Pallas TPU kernels of the same name
"""
