"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8. Trillion-param MoE (paper-table).
[arXiv:2501.kimi2]. Full attention => long_500k skipped per shape sheet.
Its GQA attention of dh 112 mirrors the JAX package and is not Kimi-K2's
published MLA, which ``kimi-k2-instruct`` carries.

Adafactor optimizer: 1T params * (4B adam m + 4B v + 4B master) does not
fit 512 v5e chips; factored second moment does (see DESIGN.md).
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                MoEConfig, ParallelConfig, TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        d_ff=2048,            # expert hidden size (fine-grained experts)
        vocab_size=163840,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=8, d_head=112, rope_theta=5e7),
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                      expert_sharding="ep"),
        ffn_activation="swiglu",
    ),
    train=TrainConfig(optimizer="adafactor", remat_policy="nothing_saveable"),
    parallel=ParallelConfig(fsdp=True),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(
        ("long_500k", "full-attention arch: 512k dense prefill is quadratic; "
                      "skipped per shape-sheet rule"),
    ),
)
