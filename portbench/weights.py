"""Random weights of a configuration, drawn from ``--seed`` on the
device in the served dtype, in the port's parameter layout (one dict a
layer, as ``repro_torch.models.model.init_params`` lays them out).

Each layer is one ``torch.randn`` over a flat buffer (plus one small
draw for its vectors), on a generator seeded from (seed, layer), and
its tensors are views of that buffer: a few large calls, and any one
layer can be drawn again alone. The reference draws the layers it needs
again from the same seed, one at a time, and upcasts them; it takes
nothing from the program."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

EMBED, HEAD, FINAL = -1, -2, -3      # tags of the non-layer draws


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit torch seed from (seed, tags); any whole ``seed``."""
    words = [int(seed) % 2**64] + [int(t) % 2**64 for t in tags]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def served_dtype(cfg: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["torch_dtype"]]


def _generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def _views(flat: torch.Tensor, specs) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape, scale in specs:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        t.mul_(scale)
        out[name] = t
    assert off == flat.numel()
    return out


def _draw(specs, seed: int, tag: int, device, dtype, dist="normal"):
    g = _generator(seed, tag, device)
    n = sum(math.prod(s) for _, s, _ in specs)
    if dist == "normal":
        flat = torch.randn(n, generator=g, device=device, dtype=dtype)
    else:
        flat = torch.rand(n, generator=g, device=device, dtype=dtype)
    return _views(flat, specs), g


def _matrix_specs(cfg: Dict) -> List[Tuple[str, tuple, float]]:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    if cfg["family"] == "rwkv6":
        r = cfg["decay_lora_rank"]
        return [("wr", (d, d), d ** -0.5), ("wk", (d, d), d ** -0.5),
                ("wv", (d, d), d ** -0.5), ("wg", (d, d), d ** -0.5),
                ("wo", (d, d), d ** -0.5),
                ("w_lora_a", (d, r), d ** -0.5),
                ("w_lora_b", (r, d), 0.1 * r ** -0.5),
                ("wk_cm", (d, f), d ** -0.5), ("wv_cm", (f, d), f ** -0.5),
                ("wr_cm", (d, d), d ** -0.5)]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    E = cfg["num_local_experts"]
    return [("wq", (d, H * dh), d ** -0.5), ("wk", (d, KV * dh), d ** -0.5),
            ("wv", (d, KV * dh), d ** -0.5), ("wo", (H * dh, d),
                                               (H * dh) ** -0.5),
            ("router", (d, E), d ** -0.5),
            ("w_gate", (E, d, f), d ** -0.5), ("w_up", (E, d, f), d ** -0.5),
            ("w_down", (E, f, d), f ** -0.5)]


def _norm(cfg: Dict, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Norm parameters from a (2, d) normal draw: scale 1 + 0.1 N, and for
    a LayerNorm a bias 0.1 N."""
    scale = vec[0].mul(0.1).add_(1.0)
    if cfg["family"] == "rwkv6":
        return {"scale": scale, "bias": vec[1].mul(0.1)}
    return {"scale": scale}


def draw_layer(cfg: Dict, seed: int, li: int, device,
               dtype=None) -> Dict:
    """Layer ``li``'s parameters in the port's layout."""
    dtype = dtype or served_dtype(cfg)
    d = cfg["hidden_size"]
    mats, g = _draw(_matrix_specs(cfg), seed, li, device, dtype)
    vec = torch.randn((2 + 2 + 2, d), generator=g, device=device,
                      dtype=dtype)
    layer = {"norm1": _norm(cfg, vec[0:2]), "norm2": _norm(cfg, vec[2:4])}
    if cfg["family"] == "rwkv6":
        hs = cfg["head_size"]
        H = d // hs
        mu = torch.rand((7, d), generator=g, device=device, dtype=dtype)
        w0 = torch.rand((H, hs), generator=g, device=device,
                        dtype=torch.float32).mul_(4.0).sub_(6.0).to(dtype)
        mixer = dict(mats)
        for i, name in enumerate(("mu_w", "mu_r", "mu_k", "mu_v", "mu_g",
                                  "mu_k_cm", "mu_r_cm")):
            mixer[name] = mu[i]
        mixer["w0"] = w0
        mixer["u"] = vec[4].mul(0.5).view(H, hs)
        mixer["ln_x"] = vec[5].mul(0.1).add_(1.0)
        layer["mixer"] = mixer
        return layer
    layer["mixer"] = {k: mats[k] for k in ("wq", "wk", "wv", "wo")}
    layer["ffn"] = {k: mats[k] for k in ("router", "w_gate", "w_up",
                                         "w_down")}
    return layer


def draw_embed(cfg: Dict, seed: int, device, dtype=None):
    dtype = dtype or served_dtype(cfg)
    return _draw([("embed", (cfg["vocab_size"], cfg["hidden_size"]), 1.0)],
                 seed, EMBED, device, dtype)[0]["embed"]


def draw_head(cfg: Dict, seed: int, device, dtype=None):
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


def draw_params(cfg: Dict, seed: int, device,
                dtype=None) -> Dict:
    """The whole parameter tree, as the program takes it."""
    dtype = dtype or served_dtype(cfg)
    return {"embed": draw_embed(cfg, seed, device, dtype),
            "layers": [draw_layer(cfg, seed, li, device, dtype)
                       for li in range(cfg["num_hidden_layers"])],
            "final_norm": draw_final_norm(cfg, seed, device, dtype),
            "lm_head": draw_head(cfg, seed, device, dtype)}
