"""Public wrapper of the RWKV-6 WKV scan kernel (K4).

``rwkv6_scan`` behaves as the reference's wrapper: it pads S to a
multiple of the chunk with zeros (zero k and v add nothing to the state,
zero log_w decays nothing) and adds the bonus-u diagonal
``sum(r k u) v`` outside the chunked scan. On CPU tensors the scan is
``rwkv6_scan_plain``; on CUDA tensors it launches the hand-written
Hopper kernel (``csrc/rwkv6_scan.cu``) or raises. The reference's
``interpret`` knob has no counterpart, and there is no autograd: the
reference's kernel defines no VJP either."""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_plain

#: head sizes and the largest chunk csrc/rwkv6_scan.cu is built for
HEAD_SIZES = (16, 32, 64)
MAX_CHUNK = 64

_fwd = None


def _kernel():
    """The C entry of csrc/rwkv6_scan.cu, built on first use."""
    global _fwd
    if _fwd is None:
        fn = _build.load("rwkv6_scan").rwkv6_scan_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _check(r, k, v, log_w, s0, chunk: int) -> None:
    BH, S, hs = r.shape
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("s0", s0)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} is {t.dtype}; the kernel "
                            f"takes float32")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan: {name} must be contiguous and "
                             f"start on a 16-byte boundary (the kernel "
                             f"loads 16-byte vectors)")
    if k.shape != r.shape or v.shape != r.shape or log_w.shape != r.shape \
            or s0.shape != (BH, hs, hs):
        raise ValueError(f"rwkv6_scan: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_w "
                         f"{tuple(log_w.shape)}, s0 {tuple(s0.shape)} do "
                         f"not form (BH, S, hs) x 4 and (BH, hs, hs)")
    if hs not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: head size {hs} not in {HEAD_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"rwkv6_scan: chunk {chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide S={S}")


def _launch(r, k, v, log_w, s0, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(r, k, v, log_w, s0, chunk)
    BH, S, hs = r.shape
    y = torch.empty_like(r)
    sT = torch.empty_like(s0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), s0.data_ptr(), y.data_ptr(),
                        sT.data_ptr(), BH, S, hs, chunk, stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: cudaError "
                           f"{err}")
    rwkv6_scan.launches += 1
    return y, sT


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, s0: torch.Tensor,
               u: Optional[torch.Tensor] = None, *, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/log_w: (BH, S, hs); s0: (BH, hs, hs); u: (BH, hs) or None.
    Returns fp32 (y (BH, S, hs), final state (BH, hs, hs))."""
    S = r.shape[1]
    chunk = min(chunk, max(8, S))
    pad = (-S) % chunk
    if pad:
        r2, k2, v2, lw2 = (F.pad(t, (0, 0, 0, pad))
                           for t in (r, k, v, log_w))
    else:
        r2, k2, v2, lw2 = r, k, v, log_w
    if r.device.type == "cpu":
        y, sT = rwkv6_scan_plain(r2, k2, v2, lw2, s0, chunk=chunk)
    else:
        y, sT = _launch(r2, k2, v2, lw2, s0, chunk)
    if pad:
        y = y[:, :S]
    if u is not None:
        diag = torch.sum(r * k * u[:, None, :], dim=-1, keepdim=True)
        y = y + diag * v
    return y, sT


#: kernel launches since the last reset (CPU calls launch nothing)
rwkv6_scan.launches = 0
