"""kimi-k2-instruct [moe] — 61L d_model=7168, vocab=163840 untied; layer
0 a dense SwiGLU of 18432, layers 1-60 an MoE of 384 routed experts of
2048, top-8, beside one shared expert of 2048. Routing is DeepSeek-V3's
``noaux_tc`` with one group: top-8 of sigmoid(x W_r) plus a correction
bias, weighted by the unbiased scores normalised and times 2.827.
Attention is MLA over 64 heads: queries through a normed latent of 1536,
keys and values expanded from a normed latent of 512 shared by every
head (128 + 128 per head), beside one key of 64 roped on interleaved
pairs and shared by every head; YaRN rope (theta 50000, factor 32 over
4096 positions, beta 1 / 1, mscale 1 / 1), so the softmax scale is
192^-0.5 (0.1 ln 32 + 1)^2. RMSNorm eps 1e-6.
[https://huggingface.co/moonshotai/Kimi-K2-Instruct, config.json,
``model_type`` kimi_k2, DeepSeek-V3's layout]. A port-only entry: the
reference has no such model, so it is outside ``list_archs``.

As registered the layer holds all 384 experts of its router of 384; a
deployment's share sets ``num_experts`` to the experts one card holds
(``portbench/configs/kimi-k2-instruct.json``: 8).
"""
from repro_torch.configs.base import (ArchConfig, AttentionConfig, ModelConfig,
                                      MoEConfig, TrainConfig, YarnConfig)

CONFIG = ArchConfig(
    model=ModelConfig(
        name="kimi-k2-instruct",
        family="moe",
        num_layers=61,
        d_model=7168,
        d_ff=18432,           # the dense layer's
        vocab_size=163840,
        attention=AttentionConfig(
            n_heads=64, n_kv_heads=64, d_head=192, rope_theta=50000.0,
            rope_interleaved=True,
            yarn=YarnConfig(factor=32.0,
                            original_max_position_embeddings=4096,
                            beta_fast=1.0, beta_slow=1.0, mscale=1.0,
                            mscale_all_dim=1.0),
            kv_lora_rank=512, q_lora_rank=1536, qk_rope_head_dim=64,
            v_head_dim=128),
        moe=MoEConfig(num_experts=384, router_experts=384, top_k=8,
                      d_ff_expert=2048,
                      d_ff_routed=2048, d_ff_shared=2048,
                      scoring="sigmoid", routed_scaling_factor=2.827),
        ffn_activation="swiglu",
        first_k_dense=1,
        max_position_embeddings=131072,
        norm_eps=1e-6,
    ),
    train=TrainConfig(),
    shapes=("prefill_32k", "decode_32k"),
)
