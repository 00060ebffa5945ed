"""Plain PyTorch versions of the Mamba-2 chunked SSD scan: the
counterpart of the hand-written kernel (``csrc/ssd_scan.cu``), used on
CPU tensors, in training and as its oracle on the card.

``mamba_ssd_chunked`` is the reference's loop over chunks (the JAX
package's ``mamba_ssd_chunked``, einsums outside any Pallas kernel);
``ssd_scan_plain`` takes any sequence length, as the kernel does, by
padding the tail with zeros (zero inputs write nothing into the state,
zero log decays decay nothing)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
#: the chunk of the plain loop; the kernel's is its own (64 as well)
CHUNK = 64


def mamba_ssd_chunked(xh, B_, C_, log_a, h0, chunk: int):
    """xh: (B,S,H,P) dt-scaled inputs; B_,C_: (B,S,N); log_a: (B,S,H) <=0;
    h0: (B,H,P,N). Returns y (B,S,H,P), h_final. A loop over chunks (the
    reference's scan); every decay exponent is a difference of inclusive
    cumulative log decays, <= 0."""
    S = xh.shape[1]
    assert S % chunk == 0, (S, chunk)
    idx = torch.arange(chunk, device=xh.device)
    tri = idx[None, :] <= idx[:, None]                   # i <= t
    h = h0
    ys = []
    for c0 in range(0, S, chunk):
        xb, Bb, Cb, ab = (t[:, c0:c0 + chunk] for t in (xh, B_, C_, log_a))
        cum = torch.cumsum(ab, dim=1)                     # (B,Lc,H)
        dlog = cum[:, :, None, :] - cum[:, None, :, :]    # [t,i,h]
        dlog = torch.where(tri[None, :, :, None], dlog,
                           torch.full_like(dlog, NEG_INF))
        scores = torch.einsum("btn,bin->bti", Cb, Bb)     # (B,Lc,Lc)
        M = scores[:, :, :, None] * torch.exp(dlog)       # (B,Lc,Lc,H)
        y_intra = torch.einsum("btih,bihp->bthp", M, xb)
        y_inter = torch.einsum("btn,bhpn->bthp", Cb, h) * \
            torch.exp(cum)[..., None]
        decay_out = torch.exp(cum[:, -1:, :] - cum)       # (B,Lc,H)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + \
            torch.einsum("bihp,bin->bhpn", xb * decay_out[..., None], Bb)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h


def ssd_scan_plain(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
                   log_a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mamba_ssd_chunked`` at any S: the tail padded to a multiple of
    CHUNK with zeros, the padded rows of y dropped."""
    S = xh.shape[1]
    pad = (-S) % CHUNK
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B_, C_, log_a = (F.pad(t, (0, 0, 0, pad)) for t in (B_, C_, log_a))
    y, h = mamba_ssd_chunked(xh, B_, C_, log_a, h0, CHUNK)
    return (y[:, :S] if pad else y), h
