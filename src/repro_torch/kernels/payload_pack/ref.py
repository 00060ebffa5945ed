"""Plain PyTorch versions of the payload pack / unpack kernels.

Buffers are ``(R, s_j)`` uint8 tensors: one row per endpoint. A packed
row is ``[buf_0 | zeros to p_0 | buf_1 | zeros to p_1 | ...]`` with
``p_j >= s_j``. The wrappers in ``ops.py`` run these on CPU tensors, and
``chip_smoke.py`` holds the CUDA kernels against them on the card."""
from __future__ import annotations

from typing import List, Sequence

import torch


def pack_plain(bufs: Sequence[torch.Tensor],
               padded: Sequence[int]) -> torch.Tensor:
    """(R, s_j) buffers -> (R, sum padded) with zero pad bytes."""
    rows = bufs[0].shape[0]
    out = torch.zeros((rows, sum(padded)), dtype=torch.uint8,
                      device=bufs[0].device)
    off = 0
    for b, p in zip(bufs, padded):
        out[:, off:off + b.shape[1]] = b
        off += p
    return out


def unpack_plain(packed: torch.Tensor, sizes: Sequence[int],
                 padded: Sequence[int]) -> List[torch.Tensor]:
    """(R, >= sum padded) -> list of (R, s_j), each a copy."""
    out, off = [], 0
    for s, p in zip(sizes, padded):
        out.append(packed[:, off:off + s].clone())
        off += p
    return out
