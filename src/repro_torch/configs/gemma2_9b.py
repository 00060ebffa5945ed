"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; local(4096)+global alternating attention, logit softcap,
GeGLU. [arXiv:2408.00118]

long_500k runs: local layers' KV caches are window-bounded (4096);
global layers hold the full (sequence-sharded) cache — decode-time
attention is linear in context length.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="gemma2-9b",
        family="dense",
        num_layers=42,
        d_model=3584,
        d_ff=14336,
        vocab_size=256000,
        attention=AttentionConfig(
            n_heads=16, n_kv_heads=8, d_head=256,
            logit_softcap=50.0),
        ffn_activation="geglu",
        final_logit_softcap=30.0,
        layer_pattern=("attn", "attn"),
        window_pattern=(4096, None),   # local, global alternating
        tie_embeddings=True,
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
