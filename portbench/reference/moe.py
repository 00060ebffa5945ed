"""Plain float32 reference of the sparse-MoE transformer (Mixtral):
RMSNorm, GQA attention with rotate-half RoPE under a causal (windowed)
mask, a top-k softmax router with renormalised gates and SwiGLU
experts, run over whole sequences with no cache.

The port's prefill drops the assignments of a prompt past each
expert's capacity (``ceil4(T * top_k * capacity_factor / E)``, in token
order) and decodes dropless; the reference does the same: the prompt's
positions are routed under the prompt's capacity, the served positions
without one."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.reference.common import f32, mm, rms_norm, strict_fp32

BLOCK_Q = 1024


def capacity(cfg: Dict, n_tokens: int) -> int:
    k, E = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    c = int(n_tokens * k * cfg["capacity_factor"] / E)
    return min(max(4, -(-c // 4) * 4), n_tokens)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, heads, dh), positions 0..T-1, first half / second half."""
    T, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                        device=x.device) / dh))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] \
        * inv[None, :]
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg: Dict, p: Dict, x: torch.Tensor, control: bool):
    T = x.shape[0]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q = rope(mm(x, p["wq"], control).view(T, H, dh), cfg["rope_theta"])
    k = rope(mm(x, p["wk"], control).view(T, KV, dh), cfg["rope_theta"])
    v = mm(x, p["wv"], control).view(T, KV, dh)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    window = cfg.get("sliding_window")
    pos = torch.arange(T, device=x.device)
    out = torch.empty(T, H, dh, device=x.device)
    for q0 in range(0, T, BLOCK_Q):
        qs = q[q0:q0 + BLOCK_Q]
        s = torch.einsum("qhd,khd->hqk", qs, k) / math.sqrt(dh)
        qp = pos[q0:q0 + BLOCK_Q, None]
        ok = qp >= pos[None, :]
        if window is not None:
            ok &= (qp - pos[None, :]) < window
        s = s.masked_fill(~ok[None], -math.inf)
        out[q0:q0 + BLOCK_Q] = torch.einsum("hqk,khd->qhd",
                                            torch.softmax(s, dim=-1), v)
    return mm(out.reshape(T, H * dh), p["wo"], control)


def moe(cfg: Dict, p: Dict, x: torch.Tensor, n_prompt: int,
        control: bool) -> torch.Tensor:
    T = x.shape[0]
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    gates = torch.softmax(x @ p["router"], dim=-1)
    top_w, top_i = torch.topk(gates, k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    keep = torch.ones_like(top_i, dtype=torch.bool)
    C = capacity(cfg, n_prompt)
    flat = top_i[:n_prompt].reshape(-1)
    kp = keep[:n_prompt].reshape(-1)
    for e in range(E):
        idx = (flat == e).nonzero()[:, 0]
        kp[idx[C:]] = False
    keep[:n_prompt] = kp.view(n_prompt, k)
    out = torch.zeros_like(x)
    for e in range(E):
        t, slot = ((top_i == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        xe = x[t]
        y = torch.nn.functional.silu(mm(xe, p["w_gate"][e], control)) \
            * mm(xe, p["w_up"][e], control)
        y = mm(y, p["w_down"][e], control)
        out.index_add_(0, t, y * top_w[t, slot][:, None])
    return out


def served_logits(cfg: Dict, seed: int,
                  seqs: List[Tuple[np.ndarray, np.ndarray]], device,
                  control: bool = False) -> List[torch.Tensor]:
    """For each (prompt, served tokens): the float32 logits at the
    positions that predicted each served token, (n_served, vocab)."""
    strict_fp32()
    eps = cfg["rms_norm_eps"]
    embed = weights.draw_embed(cfg, seed, device)
    xs, n_prompt = [], []
    for prompt, served in seqs:
        toks = np.concatenate([prompt, served[:-1]]).astype(np.int64)
        xs.append(embed[torch.as_tensor(toks, device=device)].float())
        n_prompt.append(len(prompt))
    del embed
    with torch.no_grad():
        for li in range(cfg["num_hidden_layers"]):
            p = f32(weights.draw_layer(cfg, seed, li, device))
            for j, x in enumerate(xs):
                x = x + attention(cfg, p["mixer"],
                                  rms_norm(x, p["norm1"]["scale"], eps),
                                  control)
                x = x + moe(cfg, p["ffn"],
                            rms_norm(x, p["norm2"]["scale"], eps),
                            n_prompt[j], control)
                xs[j] = x
            del p
        fn = f32(weights.draw_final_norm(cfg, seed, device))
        head = weights.draw_head(cfg, seed, device).float()
        out = []
        for x, P in zip(xs, n_prompt):
            hid = rms_norm(x[P - 1:], fn["scale"], eps)
            out.append(mm(hid, head, control))
    return out
