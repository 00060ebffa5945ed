"""Model FLOPs.

``param_counts`` / ``num_active_params`` / ``model_flops`` are frozen
copies of ``repro_torch.configs.base.ModelConfig.param_counts`` /
``num_active_params`` and ``repro_torch.launch.roofline.model_flops``,
over the plain numbers of a configuration file (a CPU test holds them
to the originals). They count the embedding table as a matmul and miss
RWKV-6's channel-mix receptance and decay LoRA, so the metrics take
``matmul_params``, which counts what each token multiplies, and add
attention's products and the WKV scan's."""
from __future__ import annotations

from typing import Dict

from portbench.yardstick.bounds import valid_pairs


def _glu(cfg: Dict) -> bool:
    return cfg.get("hidden_act", "silu") in ("silu", "gelu")


def param_counts(cfg: Dict) -> Dict[str, float]:
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["vocab_size"]
    counts = {"embed": v * d}
    if not cfg.get("tie_word_embeddings", False):
        counts["lm_head"] = v * d
    layer = 0
    if cfg["family"] == "rwkv6":
        layer += 4 * d * d + 6 * d + d * d
        layer += 2 * d * f
    else:
        hq = cfg["num_attention_heads"] * cfg["head_dim"]
        hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
        layer += d * hq + 2 * d * hkv + hq * d
        n_mat = 3 if _glu(cfg) else 2
        if cfg.get("num_local_experts"):
            layer += cfg["num_local_experts"] * n_mat * d * f
            layer += d * cfg["num_local_experts"]
        else:
            layer += n_mat * d * f
    layer += 2 * d
    counts["layers"] = layer * cfg["num_hidden_layers"]
    counts["final_norm"] = d
    return counts


def num_active_params(cfg: Dict) -> int:
    n = sum(param_counts(cfg).values())
    if not cfg.get("num_local_experts"):
        return int(n)
    n_mat = 3 if _glu(cfg) else 2
    dead = (cfg["num_local_experts"] - cfg["num_experts_per_tok"]) \
        * n_mat * cfg["hidden_size"] * cfg["intermediate_size"]
    return int(n - dead * cfg["num_hidden_layers"])


def model_flops(cfg: Dict, kind: str, global_batch: int,
                seq_len: int) -> float:
    """6*N*D (train) / 2*N*D; D = tokens processed, one a sequence for a
    decode step."""
    n = num_active_params(cfg)
    tokens = global_batch if kind == "decode" else global_batch * seq_len
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


# ---------------------------------------------------------------------------
# what the metrics count
# ---------------------------------------------------------------------------

def matmul_params(cfg: Dict) -> int:
    """Weights one token multiplies in one layer (the router and the
    experts it is sent to included; the embedding gather and the head
    not)."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    if cfg["family"] == "rwkv6":
        lora = cfg.get("decay_lora_rank", 64)
        return 5 * d * d + 2 * d * lora + 2 * d * f + d * d
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
    n = d * hq + 2 * d * hkv + hq * d
    n_mat = 3 if _glu(cfg) else 2
    if cfg.get("num_local_experts"):
        n += cfg["num_experts_per_tok"] * n_mat * d * f
        n += d * cfg["num_local_experts"]
    else:
        n += n_mat * d * f
    return n


def mixer_flops(cfg: Dict, seq: int) -> float:
    """FLOPs of one layer's sequence mixing over one causal sequence of
    ``seq`` tokens, beyond its projections: attention's two products
    over the kept pairs, or the WKV recurrence (per token and head a
    rank-one update and a readout of an hs x hs state, 4 FLOPs an
    entry)."""
    if cfg["family"] == "rwkv6":
        hs = cfg["head_size"]
        return 4.0 * seq * cfg["hidden_size"] * hs
    return 4.0 * cfg["num_attention_heads"] * cfg["head_dim"] * \
        valid_pairs(seq, seq, True, cfg.get("sliding_window"))


def prefill_flops(cfg: Dict, seq: int) -> float:
    """One prefill of one ``seq``-token prompt: every layer's products
    and mixing, and the head at the last position only."""
    L = cfg["num_hidden_layers"]
    return (2.0 * matmul_params(cfg) * seq * L + mixer_flops(cfg, seq) * L
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"])


def train_flops(cfg: Dict, batch: int, seq: int) -> float:
    """One training step: forward and backward (3x the forward) of every
    layer and of the head over every token; recomputation not counted."""
    L = cfg["num_hidden_layers"]
    fwd = (2.0 * matmul_params(cfg) * seq * L + mixer_flops(cfg, seq) * L
           + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * seq)
    return 3.0 * fwd * batch
