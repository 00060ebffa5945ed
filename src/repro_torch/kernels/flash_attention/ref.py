"""Plain PyTorch attention: the counterpart of the flash kernel, used on
CPU tensors and as its oracle on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh). Returns (B, Sq, H, dh).
    GQA via head repetition (q head h reads kv head h // G); the whole
    (Sq, Skv) score matrix is materialized and softmaxed in fp32."""
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / dh ** 0.5
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kf.float()) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window is not None:
        ok &= (q_pos - k_pos) < window
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p.to(vf.dtype), vf)
