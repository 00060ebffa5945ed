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

    def window_at(self, pos: int) -> Optional[int]:
        if self.window_pattern is None:
            return self.attention.sliding_window if self.attention else None
        return self.window_pattern[pos % self.pattern_period]

    # ---------------- parameter counting (for roofline / payloads) ---------
    def param_counts(self) -> dict:
        """Analytic parameter count per component, in elements."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        counts = {"embed": v * d}
        if not self.tie_embeddings and not self.is_encoder:
            counts["lm_head"] = v * d
        per_layer = 0.0
        att = self.attention
        for pos in range(self.pattern_period):
            kind = self.layer_pattern[pos]
            layer = 0
            if kind == "attn":
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
            if self.moe_at(pos):
                e = self.moe
                n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
                layer += e.num_experts * n_mat * d * e.d_ff_expert
                layer += d * e.num_experts           # router
            else:
                n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
                layer += n_mat * d * f
            layer += 2 * d                           # two norms
            per_layer += layer
        counts["layers"] = per_layer * self.n_periods
        counts["final_norm"] = d
        return counts

    def num_params(self) -> int:
        return int(sum(self.param_counts().values()))

    def num_active_params(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        n_mat = 3 if self.ffn_activation in ("swiglu", "geglu") else 2
        dead = 0.0
        for pos in range(self.pattern_period):
            if self.moe_at(pos):
                dead += (e.num_experts - e.top_k) * n_mat * \
                    self.d_model * e.d_ff_expert
        return int(self.num_params() - dead * self.n_periods)


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
    model = dataclasses.replace(
        m, num_layers=nl, d_model=d_model, d_ff=160, vocab_size=vocab,
        attention=att, moe=moe, ssm=ssm, window_pattern=wp,
        max_position_embeddings=4096)
    train = dataclasses.replace(cfg.train, param_dtype="float32",
                                compute_dtype="float32")
    return cfg.replace(model=model, train=train)
