"""Config system for the repro framework.

Plain frozen dataclasses; every architecture in ``src/repro/configs/``
builds an :class:`ArchConfig` from these. Configs are pure data — no jax
imports here, so importing a config never touches device state.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Attention / block flavors
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class YarnConfig:
    """YaRN's rope scaling (arXiv:2309.00071), as DeepSeek-V3 publishes
    it: the inverse frequencies blend theta^(-2i/d) with it divided by
    ``factor`` over the dims between the correction dims of
    ``beta_fast`` and ``beta_slow`` rotations in
    ``original_max_position_embeddings``; cos and sin scale by
    mscale(mscale) / mscale(mscale_all_dim), and the softmax scale by
    mscale(mscale_all_dim)^2 (mscale(m) = 0.1 m ln(factor) + 1)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False                  # qwen3-style per-head RMSNorm on q,k
    logit_softcap: Optional[float] = None  # gemma2-style tanh soft-capping
    sliding_window: Optional[int] = None   # SWA window (tokens), None = full
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # softmax scale of the scores; None = 1/sqrt(d_head)
    softmax_scale: Optional[float] = None
    # rope over interleaved pairs (x[2i], x[2i+1]) at frequency i
    # (DeepSeek-V3's) instead of the first half against the second
    rope_interleaved: bool = False
    yarn: Optional[YarnConfig] = None
    # multi-head latent attention (DeepSeek-V2/V3's MLA) where
    # kv_lora_rank is set: queries through a normed latent of
    # q_lora_rank, keys and values expanded from one normed latent of
    # kv_lora_rank shared by every head, beside one roped key of
    # qk_rope_head_dim shared by every head. d_head is the query / key
    # head dim (qk_nope_head_dim + qk_rope_head_dim), v_head_dim the
    # value's; n_kv_heads equals n_heads
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 0
    v_head_dim: Optional[int] = None

    @property
    def mla(self) -> bool:
        return self.kv_lora_rank is not None


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # 'tp'  : experts replicated on the expert dim, TP-sharded on d_ff
    # 'ep'  : experts sharded over the model axis (expert parallelism)
    expert_sharding: str = "tp"
    aux_loss_weight: float = 0.01
    # width of one shared SwiGLU expert every token runs beside the
    # routed ones; None = none
    d_ff_shared: Optional[int] = None
    # the routed experts' width where the configuration gives it apart
    # from its intermediate size, which is then the dense layers'
    # (DeepSeek-V3's ``moe_intermediate_size``); it takes precedence over
    # ``d_ff_expert``, which a harness sets from that intermediate size
    d_ff_routed: Optional[int] = None
    # 'softmax': top-k of the softmax over the router's logits;
    # 'sigmoid': DeepSeek-V3's noaux_tc, top-k of sigmoid(logits) plus
    # a selection bias (``router_bias``), weighted by the unbiased scores.
    # Either way the top-k weights are divided by their sum, then
    # multiplied by the scaling factor
    scoring: str = "softmax"
    routed_scaling_factor: float = 1.0
    # an expert-parallel share: the router's width where the layer holds
    # only ``num_experts`` of the experts, ``expert_offset`` .. +
    # num_experts - 1, and computes the assignments that fall on them
    # alone; None = num_experts (every expert held)
    router_experts: Optional[int] = None
    expert_offset: int = 0

    @property
    def expert_d_ff(self) -> int:
        """The width of one routed expert."""
        return self.d_ff_routed or self.d_ff_expert

    @property
    def n_routed(self) -> int:
        """The router's width: the experts every token is routed over."""
        return self.router_experts or self.num_experts

    @property
    def is_share(self) -> bool:
        """Whether the layer holds only some of the router's experts."""
        return self.n_routed != self.num_experts


@dataclass(frozen=True)
class SSMConfig:
    """RWKV-6 / Mamba style recurrent block parameters."""
    kind: str = "rwkv6"        # 'rwkv6' | 'mamba'
    d_state: int = 16          # mamba state dim
    d_conv: int = 4            # mamba local conv width
    expand: int = 2            # mamba inner expansion
    head_size: int = 64        # rwkv6 head size


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encoder
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # FFN activation: 'swiglu' | 'geglu' | 'gelu' | 'sq_relu'
    ffn_activation: str = "swiglu"
    norm: str = "rmsnorm"           # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = False
    final_logit_softcap: Optional[float] = None
    # layer pattern, repeated cyclically; entries: 'attn' | 'mamba' | 'rwkv'
    # e.g. jamba 1:7 -> ('mamba',)*4 + ('attn',) + ('mamba',)*3
    layer_pattern: Tuple[str, ...] = ("attn",)
    # which positions in the pattern use MoE FFN (all if moe and empty)
    moe_pattern: Tuple[bool, ...] = ()
    # gemma2-style alternating local/global window per pattern position:
    # None = use attention.sliding_window everywhere
    window_pattern: Optional[Tuple[Optional[int], ...]] = None
    # encoder-only models have no decode path
    is_encoder: bool = False
    # [audio]/[vlm]: stub frontend supplies embeddings directly
    frontend: Optional[str] = None  # None | 'audio_frames' | 'vision_patches'
    max_position_embeddings: int = 1_048_576
    # muP multipliers (None = none): the embedding's output, each
    # residual branch before its add, and the logits (divided by
    # ``logits_scaling``)
    embedding_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    # epsilon of every RMSNorm / LayerNorm and of Mamba's gated norm
    norm_eps: float = 1e-6
    # leading layers whose FFN is dense (of d_ff) where the pattern puts
    # an MoE (DeepSeek-V3's first_k_dense_replace)
    first_k_dense: int = 0

    @property
    def pattern_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.num_layers % self.pattern_period == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern period {self.pattern_period}")
        return self.num_layers // self.pattern_period

    def moe_at(self, pos: int) -> bool:
        if self.moe is None:
            return False
        if not self.moe_pattern:
            return True
        return self.moe_pattern[pos % self.pattern_period]

    def moe_layer(self, li: int) -> bool:
        """Whether layer ``li`` (not a pattern position) runs an MoE."""
        return li >= self.first_k_dense and \
            self.moe_at(li % self.pattern_period)

    def window_at(self, pos: int) -> Optional[int]:
        if self.window_pattern is None:
            return self.attention.sliding_window if self.attention else None
        return self.window_pattern[pos % self.pattern_period]

    # ---------------- parameter counting (for roofline / payloads) ---------
    def param_counts(self) -> dict:
        """Analytic parameter count per component, in elements: layer by
        layer, MLA by its ranks, a dense leading layer by ``d_ff``, an MoE
        by the experts it holds (``expert_d_ff``), its router (and the
        sigmoid router's bias) over ``n_routed`` and its shared expert."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        counts = {"embed": v * d}
        if not self.tie_embeddings and not self.is_encoder:
            counts["lm_head"] = v * d
        att = self.attention
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        layers = 0
        for li in range(self.n_periods * self.pattern_period):
            kind = self.layer_pattern[li % self.pattern_period]
            layer = 0
            if kind == "attn" and att.mla:
                H, dr = att.n_heads, att.qk_rope_head_dim
                rq, rkv = att.q_lora_rank, att.kv_lora_rank
                layer += d * rq + rq + rq * H * att.d_head   # q, its norm
                layer += d * (rkv + dr) + rkv                # latent, norm
                layer += rkv * H * (att.d_head - dr + att.v_head_dim)
                layer += H * att.v_head_dim * d              # o
            elif kind == "attn":
                hq = att.n_heads * att.d_head
                hkv = att.n_kv_heads * att.d_head
                layer += d * hq + 2 * d * hkv + hq * d  # q,k,v,o
                if att.qkv_bias:
                    layer += hq + 2 * hkv
            elif kind == "mamba":
                di = self.ssm.expand * d
                layer += d * 2 * di                  # in_proj
                layer += di * self.ssm.d_conv        # conv
                layer += di * (2 * self.ssm.d_state + 1) + di  # x_proj-ish + dt
                layer += di * d                      # out_proj
            elif kind == "rwkv":
                layer += 4 * d * d + 6 * d           # r,k,v,o + mixes
                layer += d * d                       # gate
            # FFN
            if self.moe_layer(li):
                e = self.moe
                layer += e.num_experts * n_mat * d * e.expert_d_ff
                layer += d * e.n_routed              # router
                if e.scoring == "sigmoid":
                    layer += e.n_routed              # its selection bias
                if e.d_ff_shared is not None:
                    layer += n_mat * d * e.d_ff_shared
            else:
                layer += n_mat * d * f
            layer += 2 * d                           # two norms
            layers += layer
        counts["layers"] = layers
        counts["final_norm"] = d
        return counts

    def num_params(self) -> int:
        return int(sum(self.param_counts().values()))

    def num_active_params(self) -> int:
        """Active params per token (MoE counts top_k experts only; a layer
        holding a share of the experts, the top_k x num_experts /
        n_routed of its experts a token reaches on average)."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        idle = e.num_experts * (1 - e.top_k / e.n_routed) if e.is_share \
            else e.num_experts - e.top_k
        dead = sum(idle * n_mat * self.d_model * e.expert_d_ff
                   for li in range(self.num_layers) if self.moe_layer(li))
        return int(self.num_params() - dead)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


# ---------------------------------------------------------------------------
# Training / runtime
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"        # 'adamw' | 'adafactor' | 'sgd'
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # DP gradient compression: None | 'bf16' | 'int8'
    grad_compression: Optional[str] = None
    remat: bool = True
    remat_policy: str = "nothing_saveable"  # or 'dots_saveable'
    scan_layers: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # real-TPU hot paths (Pallas). Off for the CPU dry-run: Mosaic
    # kernels do not lower on the CPU backend.
    use_flash_kernel: bool = False
    use_rwkv_kernel: bool = False


@dataclass(frozen=True)
class ParallelConfig:
    """Logical→physical axis mapping knobs (see parallel/sharding.py)."""
    fsdp: bool = False              # shard params over the data axis (ZeRO-3 / PS mode)
    ps_mode: bool = False           # explicit pull/push parameter-server phasing
    seq_shard_prefill: bool = True  # shard long-seq activations over 'data'
    seq_shard_kv_decode: bool = True  # shard KV cache seq dim when batch < data axis
    expert_sharding: Optional[str] = None  # override MoEConfig.expert_sharding


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # shapes this arch supports (by name); filled by registry defaults
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_reasons: Tuple[Tuple[str, str], ...] = ()

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig,
            n_layers: Optional[int] = None,
            d_model: int = 64,
            vocab: int = 128) -> ArchConfig:
    """A tiny same-family config for CPU smoke tests."""
    m = cfg.model
    period = m.pattern_period
    nl = n_layers or max(period, 2 if period == 1 else period)
    nl = ((nl + period - 1) // period) * period
    att = None
    if m.attention is not None:
        att = dataclasses.replace(
            m.attention, n_heads=4,
            n_kv_heads=min(4, max(1, m.attention.n_kv_heads * 4 // m.attention.n_heads)),
            d_head=16,
            sliding_window=(64 if m.attention.sliding_window else None))
    moe = None
    if m.moe is not None:
        # dropless capacity so reduced-config tests are batch-shape exact
        moe = dataclasses.replace(m.moe, num_experts=4,
                                  top_k=min(2, m.moe.top_k), d_ff_expert=96,
                                  capacity_factor=4.0 / min(2, m.moe.top_k))
    ssm = m.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, head_size=16)
    wp = None
    if m.window_pattern is not None:
        wp = tuple(64 if w else None for w in m.window_pattern)
    if att is not None and att.mla:
        # MLA's ranks and head dims cut alike: q / k 16 + 8 rope, v 16
        att = dataclasses.replace(att, d_head=24, qk_rope_head_dim=8,
                                  v_head_dim=16, q_lora_rank=32,
                                  kv_lora_rank=16)
    if moe is not None and m.moe.router_experts:
        # a share: 4 experts held of a router of 8, dropless
        moe = dataclasses.replace(moe, router_experts=8, d_ff_routed=96,
                                  capacity_factor=8 / moe.top_k)
    model = dataclasses.replace(
        m, num_layers=nl, d_model=d_model, d_ff=160, vocab_size=vocab,
        attention=att, moe=moe, ssm=ssm, window_pattern=wp,
        max_position_embeddings=4096)
    train = dataclasses.replace(cfg.train, param_dtype="float32",
                                compute_dtype="float32")
    return cfg.replace(model=model, train=train)
