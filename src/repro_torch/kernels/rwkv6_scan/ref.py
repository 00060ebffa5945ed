"""Plain PyTorch versions of the RWKV-6 WKV scan: the counterpart of
the hand-written kernel (``csrc/rwkv6_scan.cu``), used on CPU tensors
and as its oracle on the card.

``rwkv6_ref`` is the exact sequential recurrence (the reference's
``repro/kernels/rwkv6_scan/ref.py``); ``rwkv6_scan_plain`` is the
kernel's own function, the body of the reference's ``_rwkv_kernel`` as a
loop over chunks."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              log_w: torch.Tensor, s0: torch.Tensor,
              u: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (BH, S, hs); s0: (BH, hs, hs); u: (BH, hs) or None.
    Sequential: y_t = r_t S_{t-1} (+ r_t diag(u) k_t^T v_t);
                S_t = diag(w_t) S_{t-1} + k_t^T v_t."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], log_w[:, t]
        outer = kt[:, :, None] * vt[:, None, :]          # (BH, hs, hs)
        y = torch.einsum("bk,bkv->bv", rt, s)
        if u is not None:
            y = y + torch.einsum("bk,bk,bkv->bv", rt, u, outer)
        s = s * torch.exp(lwt)[:, :, None] + outer
        ys.append(y)
    return torch.stack(ys, dim=1), s


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, s0: torch.Tensor, *, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, hs) inputs, S % chunk == 0, no bonus term; returns fp32
    (y (BH, S, hs), final state (BH, hs, hs)). Inside a chunk the
    pairwise decay D[t,i,c] = exp(cum_{t-1,c} - cum_{i,c}) (i < t) is
    materialized; every exponent is <= 0."""
    BH, S, hs = r.shape
    if S % chunk:
        raise ValueError(f"rwkv6_scan_plain: S={S} is not a multiple of "
                         f"chunk={chunk}")
    r, k, v, log_w = (t.float() for t in (r, k, v, log_w))
    st = s0.float()
    idx = torch.arange(chunk, device=r.device)
    mask = (idx[None, :] < idx[:, None])[None, :, :, None]    # i < t
    ys = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lw = (t[:, c0:c0 + chunk] for t in (r, k, v, log_w))
        cum = torch.cumsum(lw, dim=1)                  # inclusive
        cum_tm1 = cum - lw
        dlog = cum_tm1[:, :, None, :] - cum[:, None, :, :]
        d = torch.exp(torch.where(mask, dlog, torch.full_like(dlog,
                                                              NEG_INF)))
        a = torch.sum(rc[:, :, None, :] * kc[:, None, :, :] * d, dim=-1)
        y_intra = a @ vc
        y_inter = (rc * torch.exp(cum_tm1)) @ st
        ys.append(y_intra + y_inter)
        decay_out = torch.exp(cum[:, -1:, :] - cum)    # (BH, Lc, hs), <= 1
        st = st * torch.exp(cum[:, -1, :])[:, :, None] + \
            (kc * decay_out).transpose(1, 2) @ vc
    return torch.cat(ys, dim=1), st
