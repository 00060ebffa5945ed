"""Plain float32 reference of Kimi-K2 (``kimi_k2``: DeepSeek-V3's
layout), as ``transformers``' DeepSeek-V3 modelling computes it, run
over whole sequences with no cache, on a card's share of the experts:

  x = embed(tokens)
  x = x + mla(rms_norm(x))
  x = x + ffn(rms_norm(x))
  logits = rms_norm(x) @ lm_head

``mla`` in its expanded form: c_q = rms_norm(x W_q_a); q = c_q W_q_b,
per head [q_nope (128) | q_pe (64)]; [c_kv | k_pe] = x W_kv_a, c_kv =
rms_norm(c_kv); per head [k_nope | v] = c_kv W_kv_b; q_pe and k_pe
roped (k_pe once, for every head) as DeepSeek-V3's rotary embedding
does it: the pairs (x[2i], x[2i+1]) regrouped as evens then odds and
rotated half against half at YaRN's frequency i; scores (q . [k_nope |
k_pe]) * 192^-0.5 * mscale(mscale_all_dim)^2 under a causal mask, in
blocks of query rows; the heads' outputs through W_o.

``ffn`` is a dense SwiGLU in the first ``first_k_dense_replace`` layers
and otherwise the MoE: s = sigmoid(x W_r) in float32, the top-k of s +
bias chosen, their unbiased s normalised (+1e-20, as published) and
times ``routed_scaling_factor``; SwiGLU experts computed only on the
tokens routed to them, beside the shared SwiGLU expert on every token.

Departures from the published model: the weights are random, drawn from
the seed (``weights_kimi_k2.py``); the layer holds the card's share of
the experts (``num_local_experts`` of the router's ``n_routed_experts``,
experts 0 on) and adds only their part, as the program does (the
card's share under expert parallelism); and, as in
``reference/moe.py``, the prompt's positions are routed under the
prompt's capacity (``ceil4(T * top_k * capacity_factor /
n_routed_experts)`` per expert, assignments kept in token order), which
the port's prefill applies and the published model (dropless) does not;
the served positions are routed without one, as the port decodes.
Everything else is as published: every width, all 61 layers, the whole
vocabulary, the norms' epsilon."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights_kimi_k2 as W
from portbench.reference.common import f32, mm, rms_norm, strict_fp32

BLOCK_Q = 256


def capacity(cfg: Dict, n_tokens: int) -> int:
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    c = int(n_tokens * k * cfg["capacity_factor"] / E)
    return min(max(4, -(-c // 4) * 4), n_tokens)


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(cfg: Dict, device) -> torch.Tensor:
    """DeepSeek-V3's YaRN inverse frequencies of the rope dims, in
    float64."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    rs = cfg["rope_scaling"]
    extra = base ** -(torch.arange(0, dim, 2, dtype=torch.float64,
                                   device=device) / dim)

    def corr(turns):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (turns * 2 * math.pi)) / (2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device)
             - low) / (high - low)).clamp(0, 1)
    return extra / rs["factor"] * ramp + extra * (1 - ramp)


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return qk ** -0.5 * mscale(rs["factor"], rs["mscale_all_dim"]) ** 2


def rope(cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (T, heads, dr) at positions 0..T-1: regrouped (evens, odds) and
    rotated half against half, as the published modelling does."""
    T, h, dr = x.shape
    rs = cfg["rope_scaling"]
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * yarn_inv_freq(cfg, x.device)[None, :]
    m = mscale(rs["factor"], rs["mscale"]) \
        / mscale(rs["factor"], rs["mscale_all_dim"])
    cos = (ang.cos() * m).float()[:, None, :]
    sin = (ang.sin() * m).float()[:, None, :]
    x = x.view(T, h, dr // 2, 2).transpose(-1, -2).reshape(T, h, dr)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla(cfg: Dict, p: Dict, x: torch.Tensor, control):
    T = x.shape[0]
    H, _, rkv, dn, dr, dv = W.mla_dims(cfg)
    eps = cfg["rms_norm_eps"]
    c_q = rms_norm(mm(x, p["wq_a"], control), p["q_norm"], eps)
    q = mm(c_q, p["wq_b"], control).view(T, H, dn + dr)
    kv = mm(x, p["wkv_a"], control)
    c_kv = rms_norm(kv[:, :rkv], p["kv_norm"], eps)
    kvb = mm(c_kv, p["wkv_b"], control).view(T, H, dn + dv)
    k_pe = rope(cfg, kv[:, None, rkv:])
    q = torch.cat([q[..., :dn], rope(cfg, q[..., dn:])], dim=-1)
    k = torch.cat([kvb[..., :dn], k_pe.expand(T, H, dr)], dim=-1)
    v = kvb[..., dn:]
    pos = torch.arange(T, device=x.device)
    out = torch.empty(T, H, dv, device=x.device)
    for q0 in range(0, T, BLOCK_Q):
        s = torch.einsum("qhd,khd->hqk", q[q0:q0 + BLOCK_Q], k) \
            * softmax_scale(cfg)
        ok = pos[q0:q0 + BLOCK_Q, None] >= pos[None, :]
        s = s.masked_fill(~ok[None], -math.inf)
        out[q0:q0 + BLOCK_Q] = torch.einsum("hqk,khd->qhd",
                                            torch.softmax(s, dim=-1), v)
    return mm(out.reshape(T, H * dv), p["wo"], control)


def swiglu(x, w_gate, w_up, w_down, control):
    return mm(F.silu(mm(x, w_gate, control)) * mm(x, w_up, control),
              w_down, control)


def route(cfg: Dict, p: Dict, x: torch.Tensor):
    """(weights (T, k), expert ids (T, k)) of the sigmoid router."""
    s = torch.sigmoid(x @ p["router"])
    top_i = torch.topk(s + p["router_bias"], cfg["num_experts_per_tok"],
                       dim=-1).indices
    top_w = s.gather(-1, top_i)
    if cfg["norm_topk_prob"]:
        top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_w * cfg["routed_scaling_factor"], top_i


def moe(cfg: Dict, p: Dict, x: torch.Tensor, n_prompt: int, control,
        held: Optional[range] = None, shared: bool = True):
    """The held experts' part of the routed sum (``held``: the router's
    ids of the experts ``p`` holds, in order; by default the first
    ``num_local_experts``) plus, with ``shared``, the shared expert."""
    k = cfg["num_experts_per_tok"]
    held = held if held is not None else range(cfg["num_local_experts"])
    top_w, top_i = route(cfg, p, x)
    keep = torch.ones_like(top_i, dtype=torch.bool)
    C = capacity(cfg, n_prompt)
    flat = top_i[:n_prompt].reshape(-1)
    kp = keep[:n_prompt].reshape(-1)
    for e in held:
        idx = (flat == e).nonzero()[:, 0]
        kp[idx[C:]] = False
    keep[:n_prompt] = kp.view(n_prompt, k)
    out = (swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"],
                  control) if shared else torch.zeros_like(x))
    for j, e in enumerate(held):
        t, slot = ((top_i == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        y = swiglu(x[t], p["w_gate"][j], p["w_up"][j], p["w_down"][j],
                   control)
        out.index_add_(0, t, y * top_w[t, slot][:, None])
    return out


def ffn(cfg: Dict, li: int, p: Dict, x: torch.Tensor, n_prompt: int,
        control):
    if W.is_dense(cfg, li):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], control)
    return moe(cfg, p, x, n_prompt, control)


def served_logits(cfg: Dict, seed: int,
                  seqs: List[Tuple[np.ndarray, np.ndarray]], device,
                  control=None) -> List[torch.Tensor]:
    """For each (prompt, served tokens): the float32 logits at the
    positions that predicted each served token, (n_served, vocab). With
    ``control`` every product in float8 (``common.mm``)."""
    strict_fp32()
    eps = cfg["rms_norm_eps"]
    embed = W.draw_embed(cfg, seed, device)
    xs, n_prompt = [], []
    for prompt, served in seqs:
        toks = np.concatenate([prompt, served[:-1]]).astype(np.int64)
        xs.append(embed[torch.as_tensor(toks, device=device)].float())
        n_prompt.append(len(prompt))
    del embed
    with torch.no_grad():
        for li in range(cfg["num_hidden_layers"]):
            p = f32(W.draw_layer(cfg, seed, li, device))
            for j, x in enumerate(xs):
                x = x + mla(cfg, p["mixer"],
                            rms_norm(x, p["norm1"]["scale"], eps), control)
                x = x + ffn(cfg, li, p["ffn"],
                            rms_norm(x, p["norm2"]["scale"], eps),
                            n_prompt[j], control)
                xs[j] = x
            del p
        fn = f32(W.draw_final_norm(cfg, seed, device))
        head = W.draw_head(cfg, seed, device).float()
        out = []
        for x, P in zip(xs, n_prompt):
            hid = rms_norm(x[P - 1:], fn["scale"], eps)
            out.append(mm(hid, head, control))
    return out
