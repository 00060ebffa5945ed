"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]. SWA bounds the KV cache => long_500k runnable.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                MoEConfig, TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=32,
        d_model=4096,
        d_ff=14336,
        vocab_size=32000,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=8, d_head=128,
            sliding_window=4096, rope_theta=1e6),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
        ffn_activation="swiglu",
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
