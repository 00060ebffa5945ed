"""qwen1.5-4b [dense] — 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-4B].

20 heads on a 16-way model axis: GSPMD uneven sharding (pad) on the head
dim; FFN (6912) and vocab (151936) shard evenly.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="qwen1.5-4b",
        family="dense",
        num_layers=40,
        d_model=2560,
        d_ff=6912,
        vocab_size=151936,
        attention=AttentionConfig(
            n_heads=20, n_kv_heads=20, d_head=128, qkv_bias=True),
        ffn_activation="swiglu",
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(
        ("long_500k", "pure full-attention arch; skipped per shape-sheet rule"),
    ),
)
