"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2; Mamba:attention 1:7
interleave (1 attention layer per 8), MoE every other layer.
[arXiv:2403.19887]. Hybrid (mostly constant-state) => long_500k runs;
the 1-in-8 attention layers keep a sequence-sharded full cache.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                MoEConfig, ParallelConfig, SSMConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        d_ff=24576,
        vocab_size=65536,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=8, d_head=128, use_rope=False),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        ffn_activation="swiglu",
        # Jamba period-8 block: attn at position 4, mamba elsewhere
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        # MoE on odd positions (every other layer)
        moe_pattern=(False, True, False, True, False, True, False, True),
    ),
    train=TrainConfig(optimizer="adafactor"),
    parallel=ParallelConfig(fsdp=True),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
