"""Payload packing — the port's serialized mode.

protobuf serialization on gRPC is a CPU-side copy into one contiguous
wire buffer. Here the analogous trade is: pay one extra HBM copy to
coalesce N iovec buffers into one transfer (serialized), or move the N
buffers one by one with no copy (non-serialized). ``pack``/``unpack``
run through the payload_pack kernels (K1, K2) on CUDA tensors and their
plain versions on CPU tensors, with no padding, so the packed buffer
equals the concatenation of the buffers for any sizes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import payload_pack


def pack(bufs: Sequence[torch.Tensor]
         ) -> Tuple[torch.Tensor, Tuple[Tuple[int, ...], ...]]:
    """Concatenate per-endpoint buffer rows into one contiguous buffer.

    bufs: sequence of (..., size_i) uint8. Returns (packed (..., sum),
    metadata of original trailing shapes)."""
    meta = tuple((int(b.shape[-1]),) for b in bufs)
    packed, _ = payload_pack.pack(bufs, pad=False)
    return packed, meta


def unpack(packed: torch.Tensor, meta: Tuple[Tuple[int, ...], ...]
           ) -> List[torch.Tensor]:
    return payload_pack.unpack(packed, [m[0] for m in meta], pad=False)
