"""The arithmetic of a ``granitemoehybrid`` configuration (Granite-4.0-H:
Mamba-2 and GQA attention layers, each followed by a routed MoE beside a
shared expert, a tied head), over the plain numbers of its file.

``prefill_flops`` counts what one prefill of ``S`` tokens must compute:
every projection; the SSD's products in the chunked form the port runs
(chunk 64: the chunk's C B^T, its masked product with the inputs, the
read of the carried state and the state's update; the decays'
elementwise work not counted); attention's two causal products; the
router, the top-k experts on every token (not the capacity's padding,
and the dropped assignments as if kept) and the shared expert; the head
at the last position. Convolutions, norms and gates are not counted.

``decode_bytes`` counts what one batch-1 decode step must move if it
read only the experts its token is routed to: every layer's mixer
weights, router, top-k experts and shared expert, the tied head, the
norms, and each Mamba layer's state read and written (the fp32 SSM
state and the conv histories in the served dtype). The attention
layers' KV cache is left out (16 KiB a position for all four layers of
the published model: under 0.3 % of the step at the cell's contexts),
so the bound is a floor."""
from __future__ import annotations

from typing import Dict

SSD_CHUNK = 64


def _width(cfg: Dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[cfg["torch_dtype"]]


def _mamba(cfg: Dict):
    d = cfg["hidden_size"]
    di = cfg["mamba_expand"] * d
    return di, di // cfg["mamba_d_head"], cfg["mamba_d_head"], \
        cfg["mamba_d_state"], cfg["mamba_d_conv"]


def mixer_params(cfg: Dict, kind: str) -> int:
    """The weights of one layer's mixer (``mamba`` or ``attention``)."""
    d = cfg["hidden_size"]
    if kind == "mamba":
        di, H, _, N, W = _mamba(cfg)
        return d * (2 * di + 2 * N + H) + di * d + W * (di + 2 * N) \
            + di + 2 * N + di + 3 * H
    hq = cfg["num_attention_heads"] * cfg["head_dim"]
    hkv = cfg["num_key_value_heads"] * cfg["head_dim"]
    return d * hq + 2 * d * hkv + hq * d


def routed_params(cfg: Dict) -> int:
    """The router, one token's top-k experts and the shared expert."""
    d, f, E = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_local_experts"]
    fs = cfg.get("shared_intermediate_size") or 0
    return d * E + cfg["num_experts_per_tok"] * 3 * d * f + 3 * d * fs


def ssd_flops(cfg: Dict, S: int) -> float:
    """The chunked SSD's products over ``S`` positions of one layer."""
    _, H, P, N, _ = _mamba(cfg)
    Q = SSD_CHUNK
    return S * (2 * Q * N + 2 * Q * H * P + 4 * N * H * P)


def prefill_flops(cfg: Dict, S: int) -> float:
    """One prefill of ``S`` tokens (see the module's note)."""
    d = cfg["hidden_size"]
    total = 2.0 * d * cfg["vocab_size"]
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        total += 2.0 * S * (mixer_params(cfg, kind) + routed_params(cfg))
        if kind == "mamba":
            total += ssd_flops(cfg, S)
        else:
            hd = cfg["num_attention_heads"] * cfg["head_dim"]
            total += 2.0 * S * S * hd        # QK^T and PV, causal halves
    return total


def decode_bytes(cfg: Dict) -> float:
    """One batch-1 decode step that reads only its routed experts (see
    the module's note)."""
    d, w = cfg["hidden_size"], _width(cfg)
    total = w * (cfg["vocab_size"] * d + d)          # tied head, final norm
    for kind in cfg["layer_types"][:cfg["num_hidden_layers"]]:
        total += w * (mixer_params(cfg, kind) + routed_params(cfg) + 2 * d)
        if kind == "mamba":
            di, H, P, N, W = _mamba(cfg)
            total += 2 * (4 * H * P * N + w * (W - 1) * (di + 2 * N))
    return total
