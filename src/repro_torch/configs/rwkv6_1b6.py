"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536. RWKV-6 "Finch": data-dependent decay linear recurrence.
[arXiv:2404.05892]. Constant-size recurrent state => long_500k runs.
"""
from repro_torch.configs.base import (ArchConfig, ModelConfig, SSMConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab_size=65536,
        ssm=SSMConfig(kind="rwkv6", head_size=64),
        ffn_activation="sq_relu",   # rwkv channel-mix uses squared relu
        norm="layernorm",
        layer_pattern=("rwkv",),
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
