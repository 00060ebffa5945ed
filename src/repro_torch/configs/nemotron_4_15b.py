"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP (no GLU). [arXiv:2402.16819]
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        d_ff=24576,
        vocab_size=256000,
        attention=AttentionConfig(n_heads=48, n_kv_heads=8, d_head=128),
        ffn_activation="sq_relu",
        norm="layernorm",
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(
        ("long_500k", "pure full-attention arch; skipped per shape-sheet rule"),
    ),
)
