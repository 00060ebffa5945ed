"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``):

  flash_attention — fused GQA attention forward (causal / sliding
                    window / softcap), replacing the Pallas TPU kernel
"""
