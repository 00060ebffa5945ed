"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone.

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504
[arXiv:2106.07447]. Modality frontend is a stub: input_specs() provides
precomputed frame embeddings. Encoder-only => no decode shapes.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="hubert-xlarge",
        family="encoder",
        num_layers=48,
        d_model=1280,
        d_ff=5120,
        vocab_size=504,
        attention=AttentionConfig(
            n_heads=16, n_kv_heads=16, d_head=80,
            causal=False, use_rope=False, qkv_bias=True),
        ffn_activation="gelu",
        norm="layernorm",
        is_encoder=True,
        frontend="audio_frames",
        tie_embeddings=True,
    ),
    train=TrainConfig(),
    shapes=("train_4k", "prefill_32k"),
    skip_reasons=(
        ("decode_32k", "encoder-only: no autoregressive decode step"),
        ("long_500k", "encoder-only: no autoregressive decode step"),
    ),
)
