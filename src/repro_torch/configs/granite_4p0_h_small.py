"""granite-4.0-h-small [hybrid] — 40L d_model=4096, vocab=100352, tied
embeddings; 36 Mamba-2 layers (128 heads of 64, d_inner 8192, d_state
128, one B/C group, conv 4 with bias) and 4 GQA attention layers at
positions 5, 15, 25, 35 (32 q / 8 kv heads of 128, no positional
encoding, softmax scale 1/128); an MoE in every layer: 72 experts of
768, top-10, SwiGLU, beside one shared SwiGLU expert of 1536. muP
multipliers: embeddings x12, each residual branch x0.22, logits / 16;
RMSNorm eps 1e-5.
[https://huggingface.co/ibm-granite/granite-4.0-h-small, config.json,
``model_type`` granitemoehybrid]. A port-only entry: the reference has
no such model, so it is outside ``list_archs``.
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                      MoEConfig, SSMConfig, TrainConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid",
        num_layers=40,
        d_model=4096,
        d_ff=768,
        vocab_size=100352,
        attention=AttentionConfig(
            n_heads=32, n_kv_heads=8, d_head=128, use_rope=False,
            softmax_scale=0.0078125),
        moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768,
                      d_ff_shared=1536),
        ssm=SSMConfig(kind="mamba", d_state=128, d_conv=4, expand=2),
        ffn_activation="swiglu",
        tie_embeddings=True,
        # period 10: attention at position 5, Mamba-2 elsewhere
        layer_pattern=("mamba",) * 5 + ("attn",) + ("mamba",) * 4,
        max_position_embeddings=131072,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        norm_eps=1e-5,
    ),
    train=TrainConfig(),
    shapes=("prefill_32k", "decode_32k"),
)
