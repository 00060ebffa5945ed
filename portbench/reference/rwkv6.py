"""Plain float32 reference of RWKV-6 as the port computes it: per layer
a LayerNorm, the time mix (token shift lerped with fixed mu, the
decay ``w = exp(-exp(w0 + tanh(x_w A) B))``, the WKV recurrence
``y_t = r_t (S_{t-1} + u k_t v_t^T)``, ``S_t = diag(w_t) S_{t-1} +
k_t v_t^T``, a per-head GroupNorm (eps 64e-5) and the silu gate),
another LayerNorm and the channel mix (``sigmoid(x_r W_r) *
(relu(x_k W_k)^2 W_v)``); run over whole sequences from a zero state.

The recurrence is evaluated exactly in chunks of ``CHUNK`` positions:
within a chunk every decay factor is ``exp`` of a difference of
cumulative log decays (never positive), across chunks the state is
carried. All requests of a check run as one right-padded batch (the
model is causal, so the padding changes no earlier position)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench import weights
from portbench.reference.common import f32, layer_norm, mm, strict_fp32

CHUNK = 16
GN_EPS = 64e-5


def shift(x: torch.Tensor) -> torch.Tensor:
    """(B, T, d): position t gets x[t-1], position 0 zeros."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u):
    """r, k, v, logw (B, T, H, hs) float32, u (H, hs); zero start state.
    Returns y (B, T, H, hs)."""
    B, T, H, hs = r.shape
    pad = (-T) % CHUNK
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    S = torch.zeros(B, H, hs, hs, device=r.device)
    L = CHUNK
    strict = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                   device=r.device), -1)
    ys = []
    for c0 in range(0, T + pad, L):
        rb, kb, vb, lw = (t[:, c0:c0 + L].transpose(1, 2)
                          for t in (r, k, v, logw))        # (B,H,L,hs)
        cum = lw.cumsum(2)
        prev = cum - lw
        # A[t, i] = sum_c r[t,c] k[i,c] exp(prev[t,c] - cum[i,c]), i < t
        expo = prev[:, :, :, None, :] - cum[:, :, None, :, :]
        expo = expo.masked_fill(~strict[None, None, :, :, None], -torch.inf)
        A = torch.einsum("bhtc,bhic,bhtic->bhti", rb, kb, expo.exp())
        A = A + torch.diag_embed((rb * kb * u[None, :, None, :]).sum(-1))
        y = A @ vb + (rb * prev.exp()) @ S
        S = S * cum[:, :, -1, :, None].exp() + \
            (kb * (cum[:, :, -1:, :] - cum).exp()).transpose(-1, -2) @ vb
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, dim=1)[:, :T]


def group_norm(y: torch.Tensor, scale: torch.Tensor, H: int):
    B, T, d = y.shape
    yh = y.view(B, T, H, d // H)
    mean = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)
    return ((yh - mean) * torch.rsqrt(var + GN_EPS)).view(B, T, d) * scale


def time_mix(cfg: Dict, p: Dict, x: torch.Tensor, control: bool):
    B, T, d = x.shape
    hs = cfg["head_size"]
    H = d // hs
    xp = shift(x)

    def lerp(mu):
        return x + (xp - x) * mu
    xw, xr, xk, xv, xg = (lerp(p[m]) for m in
                          ("mu_w", "mu_r", "mu_k", "mu_v", "mu_g"))
    logw = -torch.exp(p["w0"].reshape(-1)
                      + torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"])
    r = mm(xr, p["wr"], control).view(B, T, H, hs)
    k = mm(xk, p["wk"], control).view(B, T, H, hs)
    v = mm(xv, p["wv"], control).view(B, T, H, hs)
    g = F.silu(mm(xg, p["wg"], control))
    y = wkv(r, k, v, logw.view(B, T, H, hs), p["u"]).reshape(B, T, d)
    return mm(group_norm(y, p["ln_x"], H) * g, p["wo"], control)


def channel_mix(p: Dict, x: torch.Tensor, control: bool):
    xp = shift(x)
    xk = x + (xp - x) * p["mu_k_cm"]
    xr = x + (xp - x) * p["mu_r_cm"]
    kk = F.relu(mm(xk, p["wk_cm"], control)) ** 2
    return torch.sigmoid(mm(xr, p["wr_cm"], control)) * \
        mm(kk, p["wv_cm"], control)


def served_logits(cfg: Dict, seed: int,
                  seqs: List[Tuple[np.ndarray, np.ndarray]], device,
                  control: bool = False) -> List[torch.Tensor]:
    """For each (prompt, served tokens): the float32 logits at the
    positions that predicted each served token, (n_served, vocab)."""
    strict_fp32()
    if not seqs:
        return []
    eps = cfg["layer_norm_epsilon"]
    toks = [np.concatenate([p, s[:-1]]).astype(np.int64) for p, s in seqs]
    T = max(len(t) for t in toks)
    ids = np.zeros((len(toks), T), dtype=np.int64)
    for j, t in enumerate(toks):
        ids[j, :len(t)] = t
    embed = weights.draw_embed(cfg, seed, device)
    x = embed[torch.as_tensor(ids, device=device)].float()
    del embed
    with torch.no_grad():
        for li in range(cfg["num_hidden_layers"]):
            p = f32(weights.draw_layer(cfg, seed, li, device))
            n1, n2 = p["norm1"], p["norm2"]
            x = x + time_mix(cfg, p["mixer"],
                             layer_norm(x, n1["scale"], n1["bias"], eps),
                             control)
            x = x + channel_mix(p["mixer"],
                                layer_norm(x, n2["scale"], n2["bias"], eps),
                                control)
            del p
        fn = f32(weights.draw_final_norm(cfg, seed, device))
        head = weights.draw_head(cfg, seed, device).float()
        out = []
        for j, (prompt, served) in enumerate(seqs):
            P, n = len(prompt), len(served)
            hid = layer_norm(x[j, P - 1:P - 1 + n], fn["scale"], fn["bias"],
                             eps)
            out.append(mm(hid, head, control))
    return out
