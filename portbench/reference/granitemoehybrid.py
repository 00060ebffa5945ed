"""Plain float32 reference of Granite-4.0-H (``granitemoehybrid``), as
``transformers``' ``GraniteMoeHybridDecoderLayer`` computes it, run over
whole sequences with no cache:

  x = embed(tokens) * embedding_multiplier
  x = x + residual_multiplier * mixer(rms_norm(x))
  x = x + residual_multiplier * (moe(h) + shared(h)),  h = rms_norm(x)
  logits = rms_norm(x) @ embed^T / logits_scaling

``mixer`` is Mamba-2 or NoPE GQA attention, as ``layer_types`` says.
Attention scales its scores by ``attention_multiplier`` under a causal
mask. The Mamba-2 mixer projects z, x, B, C and dt, runs x and B, C
through a causal depthwise conv of width ``mamba_d_conv`` with its bias
and SiLU, and computes the SSD in its quadratic masked form
(arXiv:2405.21060, section 3):

  y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < r <= t} dt_r A) dt_s x_s
        + D x_t,    dt = softplus(dt_raw + dt_bias),  A = -exp(A_log)

per head, in blocks of query positions, then the gated RMSNorm
(``rms_norm(y * silu(z))`` over the whole ``d_inner``, one group) and
the output projection. The MoE's router takes float32 logits, a softmax
over its top-k logits (the full softmax's top-k renormalised: the same
weights), and SwiGLU experts computed only on the tokens routed to
them; the shared SwiGLU expert runs on every token.

Departures from the published model: the weights are random, drawn
from the seed (``weights_granitemoehybrid.py``); and, as in
``reference/moe.py``, the prompt's positions are routed under the
prompt's capacity (``ceil4(T * top_k * capacity_factor / E)`` per
expert, assignments kept in token order), which the port's prefill
applies and the published model (dropless) does not; the served
positions are routed without one, as the port decodes. Everything
else is as published: every width, all 72 experts, the whole
vocabulary, the norms' epsilon."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights_granitemoehybrid as W
from portbench.reference.common import f32, mm, rms_norm, strict_fp32
from portbench.reference.moe import capacity

BLOCK_Q = 256


def attention(cfg: Dict, p: Dict, x: torch.Tensor, control):
    T = x.shape[0]
    H, KV, dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    q = mm(x, p["wq"], control).view(T, H, dh)
    k = mm(x, p["wk"], control).view(T, KV, dh)
    v = mm(x, p["wv"], control).view(T, KV, dh)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    pos = torch.arange(T, device=x.device)
    out = torch.empty(T, H, dh, device=x.device)
    for q0 in range(0, T, BLOCK_Q):
        s = torch.einsum("qhd,khd->hqk", q[q0:q0 + BLOCK_Q], k) \
            * cfg["attention_multiplier"]
        ok = pos[q0:q0 + BLOCK_Q, None] >= pos[None, :]
        s = s.masked_fill(~ok[None], -math.inf)
        out[q0:q0 + BLOCK_Q] = torch.einsum("hqk,khd->qhd",
                                            torch.softmax(s, dim=-1), v)
    return mm(out.reshape(T, H * dh), p["wo"], control)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """x (T, C); w (W, C): out_t = silu(sum_i w_i x_{t-W+1+i} + b), zeros
    before the sequence."""
    Wd, T = w.shape[0], x.shape[0]
    xp = torch.cat([x.new_zeros(Wd - 1, x.shape[1]), x])
    return F.silu(sum(xp[i:i + T] * w[i] for i in range(Wd)) + b)


def ssd(xs, dt, A, Bm, Cm, D):
    """The SSD's quadratic masked form. xs (T, H, P), dt (T, H), A (H,),
    Bm / Cm (T, N), D (H,) -> y (T, H, P)."""
    T = xs.shape[0]
    cum = torch.cumsum(dt * A, dim=0)                 # (T, H), decreasing
    u = xs * dt[..., None]                            # dt_s x_s
    y = torch.empty_like(xs)
    for t0 in range(0, T, BLOCK_Q):
        t1 = min(T, t0 + BLOCK_Q)
        seg = cum[t0:t1, None, :] - cum[None, :t1, :]    # (Q, S, H)
        ok = (torch.arange(t0, t1, device=xs.device)[:, None]
              >= torch.arange(t1, device=xs.device)[None, :])
        decay = torch.exp(seg.masked_fill(~ok[..., None], -math.inf))
        m = (Cm[t0:t1] @ Bm[:t1].T)[..., None] * decay   # (Q, S, H)
        y[t0:t1] = torch.einsum("tsh,shp->thp", m, u[:t1])
    return y + D[:, None] * xs


def mamba(cfg: Dict, p: Dict, x: torch.Tensor, control):
    di, H, P, N, _ = W.mamba_dims(cfg)
    T = x.shape[0]
    z = mm(x, p["z_proj"], control)
    xs = causal_conv(mm(x, p["x_proj"], control), p["conv_w"], p["conv_b"])
    bc = causal_conv(mm(x, p["bc_proj"], control), p["conv_w_bc"],
                     p["conv_b_bc"])
    dt = F.softplus(mm(x, p["dt_proj"], control) + p["dt_bias"])
    y = ssd(xs.view(T, H, P), dt, -torch.exp(p["a_log"]), bc[:, :N],
            bc[:, N:], p["d_skip"]).reshape(T, di)
    y = rms_norm(y * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return mm(y, p["out_proj"], control)


def swiglu(x, w_gate, w_up, w_down, control):
    return mm(F.silu(mm(x, w_gate, control)) * mm(x, w_up, control),
              w_down, control)


def moe(cfg: Dict, p: Dict, x: torch.Tensor, n_prompt: int, control):
    """The routed experts plus the shared one (where the configuration
    has one)."""
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
    out = (swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"],
                  control) if "shared_gate" in p else torch.zeros_like(x))
    for e in range(E):
        t, slot = ((top_i == e) & keep).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        y = swiglu(x[t], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                   control)
        out.index_add_(0, t, y * top_w[t, slot][:, None])
    return out


def served_logits(cfg: Dict, seed: int,
                  seqs: List[Tuple[np.ndarray, np.ndarray]], device,
                  control=None) -> List[torch.Tensor]:
    """For each (prompt, served tokens): the float32 logits at the
    positions that predicted each served token, (n_served, vocab). With
    ``control`` every product in float8 (``common.mm``)."""
    strict_fp32()
    eps, r = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    embed = W.draw_embed(cfg, seed, device)
    xs, n_prompt = [], []
    for prompt, served in seqs:
        toks = np.concatenate([prompt, served[:-1]]).astype(np.int64)
        xs.append(embed[torch.as_tensor(toks, device=device)].float()
                  * cfg["embedding_multiplier"])
        n_prompt.append(len(prompt))
    del embed
    with torch.no_grad():
        for li in range(cfg["num_hidden_layers"]):
            p = f32(W.draw_layer(cfg, seed, li, device))
            mixer = mamba if W.layer_kind(cfg, li) == "mamba" else attention
            for j, x in enumerate(xs):
                x = x + r * mixer(cfg, p["mixer"],
                                  rms_norm(x, p["norm1"]["scale"], eps),
                                  control)
                x = x + r * moe(cfg, p["ffn"],
                                rms_norm(x, p["norm2"]["scale"], eps),
                                n_prompt[j], control)
                xs[j] = x
            del p
        fn = f32(W.draw_final_norm(cfg, seed, device))
        head = W.draw_embed(cfg, seed, device).float().T
        out = []
        for x, P in zip(xs, n_prompt):
            hid = rms_norm(x[P - 1:], fn["scale"], eps)
            out.append(mm(hid, head, control) / cfg["logits_scaling"])
    return out
