"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. InternViT + LLaMA3-70B-class language backbone.
[arXiv:2404.16821]. Backbone only: the vision frontend is a stub —
input_specs() provides precomputed patch embeddings.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                ParallelConfig, TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="internvl2-76b",
        family="dense",
        num_layers=80,
        d_model=8192,
        d_ff=28672,
        vocab_size=128256,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=8, d_head=128, rope_theta=5e5),
        ffn_activation="swiglu",
        frontend="vision_patches",
    ),
    train=TrainConfig(remat_policy="nothing_saveable"),
    parallel=ParallelConfig(fsdp=True),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(
        ("long_500k", "pure full-attention arch; skipped per shape-sheet rule"),
    ),
)
