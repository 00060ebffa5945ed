"""Random weights of a ``kimi_k2`` configuration (Kimi-K2, DeepSeek-V3's
layout), drawn from ``--seed`` on the device in the served dtype, in the
port's parameter layout: ``weights.py``'s scheme (one ``torch.randn``
over a flat buffer a layer, on a generator seeded from (seed, layer),
the tensors views of it; then one small draw for the vectors), with the
layers of this family and the card's share of the experts.

Every layer's mixer is MLA: ``wq_a`` (d, q_lora_rank), ``q_norm``,
``wq_b`` (q_lora_rank, heads x (nope + rope)), ``wkv_a`` (d, kv_lora_rank +
rope), ``kv_norm``, ``wkv_b`` (kv_lora_rank, heads x (nope + v)) and
``wo`` (heads x v, d), each head's columns together. The first
``first_k_dense_replace`` layers' ``ffn`` is a dense SwiGLU of
``intermediate_size``; every later one is the router over all
``n_routed_experts`` with its selection bias (``router_bias``), the
``num_local_experts`` experts this card holds (experts 0 ..
num_local_experts - 1 of the router's, each of
``moe_intermediate_size``) and the shared expert (``shared_gate`` /
``shared_up`` / ``shared_down``, ``n_shared_experts`` x
``moe_intermediate_size`` wide). The head is untied (``lm_head``).

Matrices are N(0, 1/fan_in), the embedding N(0, 1) as ``weights.py``
draws Mixtral's, norm scales 1 + 0.1 N(0, 1) and the router's bias
``ROUTER_BIAS_STD`` N(0, 1) (``assumed`` in the configuration file: the
published bias is learned to balance the experts' load, which a random
one cannot do. At full size on the card a bias of 0.1, half the sigmoid
scores' spread, piled the prompts onto a few experts: 62-65 % of the
held experts' prefill assignments dropped at capacity 1.25. At 0.01 the
bias moves picks among near ties and drops as many as no bias does,
36-39 %, from each layer's skew over 8 experts of about 40 tokens each)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.weights import (EMBED, FINAL, HEAD, _draw, _generator, _norm,
                               served_dtype)

#: the scale of the router's selection bias
ROUTER_BIAS_STD = 0.01


def mla_dims(cfg: Dict) -> Tuple[int, int, int, int, int, int]:
    """(heads, q_lora_rank, kv_lora_rank, nope, rope, v) head dims."""
    return (cfg["num_attention_heads"], cfg["q_lora_rank"],
            cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def is_dense(cfg: Dict, li: int) -> bool:
    return li < cfg["first_k_dense_replace"]


def _mixer_specs(cfg: Dict) -> List[Tuple[str, tuple, float]]:
    d = cfg["hidden_size"]
    H, rq, rkv, dn, dr, dv = mla_dims(cfg)
    return [("wq_a", (d, rq), d ** -0.5),
            ("wq_b", (rq, H * (dn + dr)), rq ** -0.5),
            ("wkv_a", (d, rkv + dr), d ** -0.5),
            ("wkv_b", (rkv, H * (dn + dv)), rkv ** -0.5),
            ("wo", (H * dv, d), (H * dv) ** -0.5)]


def _ffn_specs(cfg: Dict, li: int) -> List[Tuple[str, tuple, float]]:
    d = cfg["hidden_size"]
    if is_dense(cfg, li):
        f = cfg["intermediate_size"]
        return [("w_gate", (d, f), d ** -0.5), ("w_up", (d, f), d ** -0.5),
                ("w_down", (f, d), f ** -0.5)]
    f, E = cfg["moe_intermediate_size"], cfg["num_local_experts"]
    fs = cfg["n_shared_experts"] * f
    return [("router", (d, cfg["n_routed_experts"]), d ** -0.5),
            ("w_gate", (E, d, f), d ** -0.5), ("w_up", (E, d, f), d ** -0.5),
            ("w_down", (E, f, d), f ** -0.5),
            ("shared_gate", (d, fs), d ** -0.5),
            ("shared_up", (d, fs), d ** -0.5),
            ("shared_down", (fs, d), fs ** -0.5)]


def draw_layer(cfg: Dict, seed: int, li: int, device, dtype=None) -> Dict:
    """Layer ``li``'s parameters in the port's layout."""
    dtype = dtype or served_dtype(cfg)
    d = cfg["hidden_size"]
    _, rq, rkv, _, _, _ = mla_dims(cfg)
    mspecs, fspecs = _mixer_specs(cfg), _ffn_specs(cfg, li)
    mats, g = _draw(mspecs + fspecs, seed, li, device, dtype)
    E = cfg["n_routed_experts"]
    vec = torch.randn((4 * d + rq + rkv + E,), generator=g, device=device,
                      dtype=dtype)
    mixer = {k: mats[k] for k, _, _ in mspecs}
    mixer["q_norm"] = vec[4 * d:4 * d + rq].mul(0.1).add_(1.0)
    mixer["kv_norm"] = vec[4 * d + rq:4 * d + rq + rkv].mul(0.1).add_(1.0)
    ffn = {k: mats[k] for k, _, _ in fspecs}
    if not is_dense(cfg, li):
        ffn["router_bias"] = vec[4 * d + rq + rkv:].mul(ROUTER_BIAS_STD)
    return {"norm1": _norm(cfg, vec[0:2 * d].view(2, d)),
            "norm2": _norm(cfg, vec[2 * d:4 * d].view(2, d)),
            "mixer": mixer, "ffn": ffn}


def draw_embed(cfg: Dict, seed: int, device, dtype=None) -> torch.Tensor:
    dtype = dtype or served_dtype(cfg)
    return _draw([("embed", (cfg["vocab_size"], cfg["hidden_size"]), 1.0)],
                 seed, EMBED, device, dtype)[0]["embed"]


def draw_head(cfg: Dict, seed: int, device, dtype=None) -> torch.Tensor:
    dtype = dtype or served_dtype(cfg)
    d = cfg["hidden_size"]
    return _draw([("lm_head", (d, cfg["vocab_size"]), d ** -0.5)],
                 seed, HEAD, device, dtype)[0]["lm_head"]


def draw_final_norm(cfg: Dict, seed: int, device, dtype=None):
    dtype = dtype or served_dtype(cfg)
    g = _generator(seed, FINAL, device)
    vec = torch.randn((2, cfg["hidden_size"]), generator=g, device=device,
                      dtype=dtype)
    return _norm(cfg, vec)


def draw_params(cfg: Dict, seed: int, device, dtype=None) -> Dict:
    """The whole parameter tree, as the program takes it."""
    dtype = dtype or served_dtype(cfg)
    return {"embed": draw_embed(cfg, seed, device, dtype),
            "layers": [draw_layer(cfg, seed, li, device, dtype)
                       for li in range(cfg["num_hidden_layers"])],
            "final_norm": draw_final_norm(cfg, seed, device, dtype),
            "lm_head": draw_head(cfg, seed, device, dtype)}
