"""Public wrappers of the payload pack / unpack kernels (K1, K2).

``pack(bufs)`` coalesces uint8 buffers of shape ``(..., s_j)`` (one row
per leading index, the same leading shape for all) into one
``(..., sum p_j)`` buffer and returns ``(packed, sizes)``; ``unpack``
splits it back into ``(..., s_j)`` copies. As in the reference's
``ops.pack``, each buffer is zero-padded to the 128-byte lane
(``p_j = s_j`` rounded up to a multiple of 128). ``pad=False`` packs with
no padding (``p_j = s_j``): ``core.serialization`` asks for that, so its
output equals a plain concatenation for any sizes.

On CPU tensors both run the plain versions of ``ref.py``; on CUDA tensors
they launch ``csrc/payload_pack.cu`` or raise. The reference's
``interpret`` knob has no counterpart."""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.payload_pack.ref import pack_plain, unpack_plain

LANE = 128
#: buffers one launch takes (kMaxEntries of csrc/payload_pack.cu)
MAX_ENTRIES = 512

_fns = {}


def _kernel(name: str):
    """``pp_pack`` / ``pp_unpack`` of csrc/payload_pack.cu, built on
    first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("payload_pack"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        _fns[name] = fn
    return fn


def _padded(sizes: Sequence[int], pad: bool) -> List[int]:
    return [s + (-s) % LANE for s in sizes] if pad else list(sizes)


def _as_rows(t: torch.Tensor, rows: int, what: str) -> torch.Tensor:
    """``(..., n)`` -> an ``(rows, n)`` view the kernel can address."""
    if t.dtype != torch.uint8:
        raise TypeError(f"payload_pack: {what} is {t.dtype}; the kernel "
                        f"moves uint8 bytes")
    try:
        v = t.view(rows, t.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"payload_pack: {what} of shape {tuple(t.shape)} "
                         f"and strides {t.stride()} is not a strided set "
                         f"of rows") from e
    if v.shape[1] > 1 and v.stride(1) != 1:
        raise ValueError(f"payload_pack: {what} must be contiguous in its "
                         f"last dim, got strides {t.stride()}")
    return v


def _launch(name: str, packed: torch.Tensor, bufs: Sequence[torch.Tensor],
            sizes: Sequence[int], padded: Sequence[int]) -> bool:
    """One launch over every buffer and row. ``packed`` and ``bufs`` are
    ``(R, *)`` views on one CUDA device. False when there was nothing to
    move, and so no launch."""
    if packed.device.type != "cuda":
        raise ValueError(f"payload_pack: tensors on {packed.device}; the "
                         f"wrappers take CPU or CUDA tensors")
    if len(bufs) > MAX_ENTRIES:
        raise ValueError(f"payload_pack: {len(bufs)} buffers in one call; "
                         f"the kernel's table holds {MAX_ENTRIES}")
    rows = packed.shape[0]
    if rows > 65535:
        raise ValueError(f"payload_pack: {rows} rows; the grid takes "
                         f"65535")
    for b in bufs:
        if b.device != packed.device:
            raise ValueError(f"payload_pack: buffers on {b.device} and "
                             f"{packed.device}; the kernel needs one "
                             f"CUDA device")
    total = sum(padded)
    if rows == 0 or total == 0:
        return False
    table, off = [], 0
    for b, s, p in zip(bufs, sizes, padded):
        table += [b.data_ptr(), b.stride(0), s, p, off]
        off += p
    table = (ctypes.c_longlong * len(table))(*table)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(packed.data_ptr(), packed.stride(0), total, rows,
                            len(bufs), table, stream)
    if err != 0:
        raise _build.KernelError(f"payload_pack {name} launch failed: "
                                 f"cudaError {err}")
    return True


def pack(bufs: Sequence[torch.Tensor], *, pad: bool = True
         ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Returns (packed uint8, original sizes). The metadata keeps the true
    sizes for ``unpack``."""
    if not bufs:
        raise ValueError("payload_pack.pack: no buffers")
    lead = tuple(bufs[0].shape[:-1])
    for b in bufs:
        if tuple(b.shape[:-1]) != lead:
            raise ValueError(f"payload_pack.pack: leading shapes differ: "
                             f"{lead} and {tuple(b.shape[:-1])}")
    sizes = tuple(int(b.shape[-1]) for b in bufs)
    padded = _padded(sizes, pad)
    rows = math.prod(lead)
    if bufs[0].device.type == "cpu":
        out = pack_plain([b.reshape(rows, s) for b, s in zip(bufs, sizes)],
                         padded)
        return out.reshape(lead + (sum(padded),)), sizes
    out = torch.empty(lead + (sum(padded),), dtype=torch.uint8,
                      device=bufs[0].device)
    views = [_as_rows(b, rows, f"buffer {j}") for j, b in enumerate(bufs)]
    if _launch("pp_pack", out.view(rows, sum(padded)), views, sizes,
               padded):
        pack.launches += 1
    return out, sizes


def unpack(packed: torch.Tensor, sizes: Sequence[int], *, pad: bool = True
           ) -> List[torch.Tensor]:
    """(..., >= sum p_j) -> list of (..., s_j) copies."""
    sizes = [int(s) for s in sizes]
    if not sizes:
        raise ValueError("payload_pack.unpack: no sizes")
    padded = _padded(sizes, pad)
    lead = tuple(packed.shape[:-1])
    rows = math.prod(lead)
    if packed.shape[-1] < sum(padded):
        raise ValueError(f"payload_pack.unpack: packed rows hold "
                         f"{packed.shape[-1]} bytes, the sizes need "
                         f"{sum(padded)}")
    if packed.device.type == "cpu":
        outs = unpack_plain(packed.reshape(rows, packed.shape[-1]), sizes,
                            padded)
        return [o.reshape(lead + (s,)) for o, s in zip(outs, sizes)]
    outs = [torch.empty(lead + (s,), dtype=torch.uint8, device=packed.device)
            for s in sizes]
    if _launch("pp_unpack", _as_rows(packed, rows, "packed"),
               [o.view(rows, s) for o, s in zip(outs, sizes)], sizes,
               padded):
        unpack.launches += 1
    return outs


def to_card(arrays: Sequence[np.ndarray]) -> List[torch.Tensor]:
    """Host uint8 arrays -> copies on the current CUDA device. Raises
    ``RuntimeError`` when no card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("the payload_pack kernels run on a CUDA card, "
                           "and none is visible (torch.cuda.is_available() "
                           "is False)")
    dev = torch.device("cuda", torch.cuda.current_device())
    return [torch.tensor(np.asarray(a, dtype=np.uint8), device=dev)
            for a in arrays]


#: kernel launches since the last reset (CPU calls launch nothing)
pack.launches = 0
unpack.launches = 0
