"""Public wrapper of the Mamba-2 chunked SSD scan kernel (K6).

``ssd_scan(xh, B_, C_, log_a, h0)`` has the contract of
``mamba_ssd_chunked`` at any sequence length: the dt-scaled inputs
``xh`` (B, S, H, P), the shared B and C (B, S, N), the log decays
``log_a`` (B, S, H) <= 0 and the state ``h0`` (B, H, P, N), all fp32, in;
``y`` (B, S, H, P) and the final state out. On CPU tensors it is
``ssd_scan_plain``; on CUDA tensors it launches the hand-written Hopper
kernel (``csrc/ssd_scan.cu``: two launches a call, whatever S is, the
ragged tail masked inside) or raises. The kernel has no backward: on the
card an input that requires a gradient is refused (train through
``mamba_ssd_chunked``)."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

#: the head size and the state sizes csrc/ssd_scan.cu is built for
HEAD_SIZE = 64
STATE_SIZES = (16, 32, 64, 128)
#: the kernel's chunk: its scratch holds C.B, one (CHUNK, CHUNK) tile a
#: chunk, beside the cumulative log decays (B, S, H)
CHUNK = 64

_fn = None


def _kernel():
    """The C entry of csrc/ssd_scan.cu, built on first use."""
    global _fn
    if _fn is None:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p]
        _fn = fn
    return _fn


def _check(xh, B_, C_, log_a, h0) -> None:
    """Every input fp32 on one CUDA device; xh, B_ and C_ with a
    contiguous last axis, 16-byte aligned, and their other strides
    multiples of 4 (the kernel copies 16-byte pieces); log_a any
    strides; h0 contiguous and aligned."""
    for name, t in (("xh", xh), ("B_", B_), ("C_", C_), ("log_a", log_a),
                    ("h0", h0)):
        if t.device.type != "cuda" or t.device != xh.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}; the kernel "
                             f"needs every input on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_scan: {name} is {t.dtype}; the kernel "
                            f"takes float32")
    if xh.dim() != 4:
        raise ValueError(f"ssd_scan: xh {tuple(xh.shape)} is not "
                         f"(B, S, H, P)")
    Bn, S, H, P = xh.shape
    N = B_.shape[-1]
    if B_.shape != (Bn, S, N) or C_.shape != (Bn, S, N) \
            or log_a.shape != (Bn, S, H) or h0.shape != (Bn, H, P, N):
        raise ValueError(f"ssd_scan: shapes xh {tuple(xh.shape)}, B_ "
                         f"{tuple(B_.shape)}, C_ {tuple(C_.shape)}, log_a "
                         f"{tuple(log_a.shape)}, h0 {tuple(h0.shape)} do "
                         f"not form (B, S, H, P), (B, S, N) x 2, (B, S, H) "
                         f"and (B, H, P, N)")
    if P != HEAD_SIZE or N not in STATE_SIZES or S < 1:
        raise ValueError(f"ssd_scan: head size {P} (the kernel takes "
                         f"{HEAD_SIZE}), state size {N} (it takes "
                         f"{STATE_SIZES}), S {S} (at least 1)")
    for name, t in (("xh", xh), ("B_", B_), ("C_", C_)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % 4 for s in t.stride()[:-1]):
            raise ValueError(f"ssd_scan: {name} must have a contiguous "
                             f"last axis, start on a 16-byte boundary and "
                             f"step its other axes in 16-byte multiples "
                             f"(strides {t.stride()})")
    if not h0.is_contiguous() or h0.data_ptr() % 16:
        raise ValueError("ssd_scan: h0 must be contiguous and start on a "
                         "16-byte boundary")


def _launch(xh, B_, C_, log_a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(xh, B_, C_, log_a, h0)
    Bn, S, H, _ = xh.shape
    N = B_.shape[-1]
    y = torch.empty(xh.shape, dtype=torch.float32, device=xh.device)
    h = torch.empty(h0.shape, dtype=torch.float32, device=xh.device)
    cb = torch.empty((Bn, -(-S // CHUNK), CHUNK, CHUNK),
                     dtype=torch.float32, device=xh.device)
    cum = torch.empty((Bn, S, H), dtype=torch.float32, device=xh.device)
    strides = (ctypes.c_longlong * 10)(
        *xh.stride()[:3], *B_.stride()[:2], *C_.stride()[:2],
        *log_a.stride())
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(xh.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                        log_a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                        h.data_ptr(), cb.data_ptr(), cum.data_ptr(), Bn, S,
                        H, N, strides, stream)
    if err != 0:
        raise _build.KernelError(f"ssd_scan kernel launch failed: "
                                 f"cudaError {err}")
    ssd_scan.launches += 1
    return y, h


def ssd_scan(xh: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
             log_a: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, S, H, 64) dt-scaled inputs; B_, C_: (B, S, N); log_a: (B,
    S, H) <= 0; h0: (B, H, 64, N); fp32. Returns fp32 (y (B, S, H, 64),
    final state (B, H, 64, N))."""
    ts = (xh, B_, C_, log_a, h0)
    if all(t.device.type == "cpu" for t in ts):
        return ssd_scan_plain(*ts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("ssd_scan: an input requires a gradient, and the "
                         "kernel has no backward: train through "
                         "mamba_ssd_chunked")
    return _launch(*ts)


#: calls that launched the kernel since the last reset (two launches
#: each; CPU calls launch nothing)
ssd_scan.launches = 0
