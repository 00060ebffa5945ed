"""The arithmetic of a ``kimi_k2`` configuration (DeepSeek-V3's layout:
MLA in every layer, a dense first layer, then a sigmoid-routed MoE
beside a shared expert; this card holds ``num_local_experts`` of the
router's ``n_routed_experts``), over the plain numbers of its file.

``prefill_flops`` counts what one prefill of ``S`` tokens must compute:
MLA's projections (q through its latent, the kv latent and rope key,
the latent's expansion into k_nope and v, the output), attention's two
causal products at their true head dims (q . k at nope + rope, p . v
at v_head_dim), the dense layer's SwiGLU, and in each MoE layer the
router, the shared expert and ``held`` assignments through a held
expert (a share of the S x top_k; by default the share the router
would give a card of uniform experts); the head at the last position.
Norms, rope and the softmax are not counted.

``decode_bytes`` counts what one batch-1 decode step must move at a
cache of ``ctx`` positions: every layer's MLA weights and norms, the
dense SwiGLU, each MoE layer's router and bias, shared expert and the
held experts its token is routed to (top_k x num_local_experts /
n_routed_experts of them on average, for a router of uniform experts),
the head and the final norm, and the latent cache read (c_kv and k_pe
at every position of every layer).

``k3_bound`` is the least time of one prefill's K3 call, counted at the
unpadded head dims (the kernel runs v padded to the q / k dim, and both
to its next instance), so a share of it shows the padding's waste."""
from __future__ import annotations

from typing import Dict, Optional

from portbench.yardstick.bounds import valid_pairs
from portbench.yardstick.peaks import BF16_FLOPS, HBM_BPS


def _width(cfg: Dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["torch_dtype"]]


def mla_params(cfg: Dict) -> int:
    """One layer's MLA weights (the norms' scales included)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    rq, rkv = cfg["q_lora_rank"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    return (d * rq + rq + rq * H * (dn + dr) + d * (rkv + dr) + rkv
            + rkv * H * (dn + dv) + H * dv * d)


def expert_params(cfg: Dict) -> int:
    """One routed expert's SwiGLU."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def shared_params(cfg: Dict) -> int:
    return cfg["n_shared_experts"] * expert_params(cfg)


def dense_params(cfg: Dict) -> int:
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"]


def router_params(cfg: Dict) -> int:
    return (cfg["hidden_size"] + 1) * cfg["n_routed_experts"]


def held_share(cfg: Dict) -> float:
    """The share of assignments a uniform router sends to held experts."""
    return cfg["num_local_experts"] / cfg["n_routed_experts"]


def _layers(cfg: Dict):
    """(dense layers, MoE layers)."""
    n = cfg["num_hidden_layers"]
    dense = min(cfg["first_k_dense_replace"], n)
    return dense, n - dense


def attention_flops(cfg: Dict, S: int) -> float:
    """One layer's two causal products over ``S`` positions."""
    H = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return 2.0 * H * (qk + cfg["v_head_dim"]) * valid_pairs(S, S, True, None)


def prefill_flops(cfg: Dict, S: int, held: Optional[float] = None) -> float:
    """One prefill of ``S`` tokens; ``held``: assignments through a held
    expert (default ``S * top_k * held_share``)."""
    if held is None:
        held = S * cfg["num_experts_per_tok"] * held_share(cfg)
    dense, moe = _layers(cfg)
    mixer = 2.0 * S * mla_params(cfg) + attention_flops(cfg, S)
    total = 2.0 * cfg["hidden_size"] * cfg["vocab_size"]
    total += dense * (mixer + 2.0 * S * dense_params(cfg))
    total += moe * (mixer + 2.0 * S * (router_params(cfg)
                                       + shared_params(cfg))
                    + 2.0 * held * expert_params(cfg))
    return total


def decode_bytes(cfg: Dict, ctx: float) -> float:
    """One batch-1 decode step at a cache of ``ctx`` positions."""
    d, w = cfg["hidden_size"], _width(cfg)
    dense, moe = _layers(cfg)
    n = dense + moe
    routed = cfg["num_experts_per_tok"] * held_share(cfg)
    total = w * (cfg["vocab_size"] * d + d)           # head, final norm
    total += w * n * (mla_params(cfg) + 2 * d)         # MLA, layer norms
    total += w * dense * dense_params(cfg)
    total += w * moe * (router_params(cfg) + shared_params(cfg)
                        + routed * expert_params(cfg))
    total += w * n * ctx * (cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"])
    return total


def k3_bound(cfg: Dict, S: int) -> float:
    """Seconds of one prefill's K3 call at the unpadded head dims: q and
    k read at nope + rope, v read and the output written at v_head_dim,
    against the two products' FLOPs over the bf16 peak."""
    H = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    nbytes = _width(cfg) * S * H * (2 * qk + 2 * cfg["v_head_dim"])
    return max(nbytes / HBM_BPS, attention_flops(cfg, S) / BF16_FLOPS)
