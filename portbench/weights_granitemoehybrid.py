"""Random weights of a ``granitemoehybrid`` configuration (Granite-4.0-H),
drawn from ``--seed`` on the device in the served dtype, in the port's
parameter layout: ``weights.py``'s scheme (one ``torch.randn`` over a
flat buffer a layer, on a generator seeded from (seed, layer), the
tensors views of it; then small draws for the vectors), with the
layers of this family.

A Mamba-2 layer's mixer holds the projections of ``in_proj`` split as
the port keeps them (``z_proj``, ``x_proj``, ``bc_proj``, ``dt_proj``),
the depthwise conv split alike (``conv_w`` over x, ``conv_w_bc`` over B
and C, each with its bias), ``a_log``, ``dt_bias``, ``d_skip``, the gated
norm's ``norm`` and ``out_proj``; an attention layer's ``wq`` .. ``wo``.
Every layer's ``ffn`` is the router, the 72 experts and the shared
expert (``shared_gate`` / ``shared_up`` / ``shared_down``). The
embedding is the head (tied), so there is no ``lm_head``.

The vectors follow Mamba-2's initialisation ranges (``assumed`` in the
configuration file): A uniform in [1, 16] per head, dt log-uniform in
[1e-3, 1e-1] (floored at 1e-4) stored as its inverse softplus; D, the
norm scales and the gated norm's weight 1 + 0.1 N(0, 1); the conv
biases 0.1 N(0, 1).

The embedding is also the head, so a token's own row meets itself in
the logits: with x12 on the way in, an embedding of a trained model's
scale (0.1) makes the last token's own logit win by some 37 standard
deviations of the others, and every served token a repeat of the last
one, which no precision could change. At ``EMBED_STD`` = 0.004 the
residual stream is the branches' (x0 under 3 % of it after 40 layers)
and the own logit lies about 2 standard deviations up, so the greedy
choice is a real contest among the vocabulary's top logits."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.weights import (EMBED, FINAL, _draw, _generator, _norm,
                               served_dtype)

#: the scale of the embedding's normal draw
EMBED_STD = 0.004


def mamba_dims(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head size, state size, conv width)."""
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    P = cfg["mamba_d_head"]
    H = di // P
    if H != cfg["mamba_n_heads"] or cfg["mamba_n_groups"] != 1:
        raise ValueError(f"Mamba heads {cfg['mamba_n_heads']} x "
                         f"{P} != d_inner {di}, or more than one B/C group")
    return di, H, P, cfg["mamba_d_state"], cfg["mamba_d_conv"]


def layer_kind(cfg: Dict, li: int) -> str:
    """``mamba`` or ``attention``."""
    return cfg["layer_types"][li]


def _ffn_specs(cfg: Dict) -> List[Tuple[str, tuple, float]]:
    """The router and experts, then the shared expert where
    ``shared_intermediate_size`` gives one."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    fs, E = cfg["shared_intermediate_size"], cfg["num_local_experts"]
    specs = [("router", (d, E), d ** -0.5),
             ("w_gate", (E, d, f), d ** -0.5), ("w_up", (E, d, f), d ** -0.5),
             ("w_down", (E, f, d), f ** -0.5)]
    if fs:
        specs += [("shared_gate", (d, fs), d ** -0.5),
                  ("shared_up", (d, fs), d ** -0.5),
                  ("shared_down", (fs, d), fs ** -0.5)]
    return specs


def _mixer_specs(cfg: Dict, kind: str) -> List[Tuple[str, tuple, float]]:
    d = cfg["hidden_size"]
    if kind == "mamba":
        di, H, _, N, W = mamba_dims(cfg)
        return [("z_proj", (d, di), d ** -0.5), ("x_proj", (d, di), d ** -0.5),
                ("bc_proj", (d, 2 * N), d ** -0.5),
                ("dt_proj", (d, H), d ** -0.5),
                ("conv_w", (W, di), W ** -0.5),
                ("conv_w_bc", (W, 2 * N), W ** -0.5),
                ("out_proj", (di, d), di ** -0.5)]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    return [("wq", (d, H * dh), d ** -0.5), ("wk", (d, KV * dh), d ** -0.5),
            ("wv", (d, KV * dh), d ** -0.5),
            ("wo", (H * dh, d), (H * dh) ** -0.5)]


def draw_layer(cfg: Dict, seed: int, li: int, device, dtype=None) -> Dict:
    """Layer ``li``'s parameters in the port's layout."""
    dtype = dtype or served_dtype(cfg)
    d, kind = cfg["hidden_size"], layer_kind(cfg, li)
    mspecs, fspecs = _mixer_specs(cfg, kind), _ffn_specs(cfg)
    mats, g = _draw(mspecs + fspecs, seed, li, device, dtype)
    vec = torch.randn((4, d), generator=g, device=device, dtype=dtype)
    layer = {"norm1": _norm(cfg, vec[0:2]), "norm2": _norm(cfg, vec[2:4]),
             "mixer": {k: mats[k] for k, _, _ in mspecs},
             "ffn": {k: mats[k] for k, _, _ in fspecs}}
    if kind != "mamba":
        return layer
    di, H, _, N, _ = mamba_dims(cfg)
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    small = torch.randn((2 * di + 2 * N + H,), **f32)
    a = torch.rand((H,), **f32).mul_(15.0).add_(1.0)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(torch.rand((H,), **f32) * (hi - lo) + lo).clamp_(min=1e-4)
    mixer = layer["mixer"]
    mixer["conv_b"] = small[:di].mul(0.1).to(dtype)
    mixer["norm"] = small[di:2 * di].mul(0.1).add_(1.0).to(dtype)
    mixer["conv_b_bc"] = small[2 * di:2 * di + 2 * N].mul(0.1).to(dtype)
    mixer["d_skip"] = small[2 * di + 2 * N:].mul(0.1).add_(1.0).to(dtype)
    mixer["a_log"] = torch.log(a).to(dtype)
    mixer["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    return layer


def draw_embed(cfg: Dict, seed: int, device, dtype=None) -> torch.Tensor:
    dtype = dtype or served_dtype(cfg)
    return _draw([("embed", (cfg["vocab_size"], cfg["hidden_size"]),
                   EMBED_STD)], seed, EMBED, device, dtype)[0]["embed"]


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
            "final_norm": draw_final_norm(cfg, seed, device, dtype)}
