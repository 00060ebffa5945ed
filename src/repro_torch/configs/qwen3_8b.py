"""qwen3-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936, qk_norm. [hf:Qwen/Qwen3-8B]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen3-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        d_ff=12288,
        vocab_size=151936,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=8, d_head=128, qk_norm=True,
            rope_theta=1e6),
        ffn_activation="swiglu",
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(
        ("long_500k", "pure full-attention arch; skipped per shape-sheet rule"),
    ),
)
