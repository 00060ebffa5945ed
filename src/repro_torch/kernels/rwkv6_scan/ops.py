"""Public wrapper of the RWKV-6 WKV scan kernel (K4).

``rwkv6_scan`` behaves as the reference's wrapper: it pads S to a
multiple of the chunk with zeros (zero k and v add nothing to the state,
zero log_w decays nothing) and adds the bonus-u diagonal
``sum(r k u) v`` outside the chunked scan. On CPU tensors the scan is
``rwkv6_scan_plain``; on CUDA tensors it launches the hand-written
Hopper kernel (``csrc/rwkv6_scan.cu``) or raises. The reference's
``interpret`` knob has no counterpart, and the kernel has no backward:
the reference's kernel defines no VJP either, so on the card an input
that requires a gradient is refused (train through ``rwkv6_chunked``,
as the reference does). Beside the reference's
``(BH, S, hs)`` layout it takes the model's ``(B, S, H, hs)``, which the
kernel reads through strides (see ``rwkv6_scan``)."""
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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_void_p]
        _fwd = fn
    return _fwd


def _check(r, k, v, log_w, s0, chunk: int) -> None:
    """Either layout of ``rwkv6_scan``: (BH, S, hs) inputs, contiguous,
    or (B, S, H, hs) ones with a contiguous head axis and 16-byte
    strides; s0 contiguous either way."""
    four = r.dim() == 4
    S, hs = r.shape[1], r.shape[-1]
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("s0", s0)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} is {t.dtype}; the kernel "
                            f"takes float32")
        if not four or name == "s0":
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"rwkv6_scan: {name} must be contiguous "
                                 f"and start on a 16-byte boundary (the "
                                 f"kernel loads 16-byte vectors)")
        elif t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % 4 for s in t.stride()[:3]):
            raise ValueError(f"rwkv6_scan: {name} must have a contiguous "
                             f"head axis, start on a 16-byte boundary and "
                             f"step batch, sequence and head in 16-byte "
                             f"multiples (strides {t.stride()})")
    lead = (r.shape[0], r.shape[2]) if four else r.shape[:1]
    if k.shape != r.shape or v.shape != r.shape or log_w.shape != r.shape \
            or s0.shape != (*lead, hs, hs):
        layout = ("(B, S, H, hs) x 4 and (B, H, hs, hs)" if four
                  else "(BH, S, hs) x 4 and (BH, hs, hs)")
        raise ValueError(f"rwkv6_scan: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_w "
                         f"{tuple(log_w.shape)}, s0 {tuple(s0.shape)} do "
                         f"not form {layout}")
    if hs not in HEAD_SIZES:
        raise ValueError(f"rwkv6_scan: head size {hs} not in {HEAD_SIZES}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"rwkv6_scan: chunk {chunk} must lie in "
                         f"[1, {MAX_CHUNK}] and divide S={S}")


def _launch(r, k, v, log_w, s0, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Either layout (see ``_check``); y is allocated contiguous in the
    inputs' layout. (BH, S, hs) goes to the kernel as (BH, S, 1, hs)."""
    _check(r, k, v, log_w, s0, chunk)
    y = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    sT = torch.empty_like(s0)
    four = [t if t.dim() == 4 else t.unsqueeze(2) for t in (r, k, v, log_w, y)]
    B, S, H, hs = four[0].shape
    strides = (ctypes.c_longlong * 15)(
        *(s for t in four for s in t.stride()[:3]))
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_w.data_ptr(), s0.data_ptr(), y.data_ptr(),
                        sT.data_ptr(), B, S, H, hs, chunk, strides, stream)
    if err != 0:
        raise _build.KernelError(f"rwkv6_scan kernel launch failed: "
                                 f"cudaError {err}")
    rwkv6_scan.launches += 1
    return y, sT


def _fold(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hs) -> (B * H, S, hs), a copy."""
    B, S, H, hs = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hs)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, s0: torch.Tensor,
               u: Optional[torch.Tensor] = None, *, chunk: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two layouts:

    - the reference's: r/k/v/log_w (BH, S, hs); s0 (BH, hs, hs); u
      (BH, hs) or None; returns fp32 (y (BH, S, hs), state (BH, hs, hs));
    - the model's: r/k/v/log_w (B, S, H, hs), which may be strided views
      with a contiguous head axis; s0 (B, H, hs, hs); u (H, hs) or None;
      returns fp32 (y (B, S, H, hs), state (B, H, hs, hs)). On the card
      the kernel reads and writes this layout through its strides, with
      no fold copy; on the CPU the inputs are folded to (B * H, S, hs)
      for ``rwkv6_scan_plain`` and the results unfolded."""
    if r.device.type != "cpu" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, log_w, s0, u)):
        raise ValueError("rwkv6_scan: an input requires a gradient, and "
                         "the kernel has no backward (the reference's "
                         "kernel defines no VJP either): train with "
                         "use_rwkv_kernel off, through rwkv6_chunked")
    four = r.dim() == 4
    S = r.shape[1]
    chunk = min(chunk, max(8, S))
    pad = (-S) % chunk
    if pad:
        widths = (0, 0, 0, 0, 0, pad) if four else (0, 0, 0, pad)
        r2, k2, v2, lw2 = (F.pad(t, widths) for t in (r, k, v, log_w))
    else:
        r2, k2, v2, lw2 = r, k, v, log_w
    if r.device.type == "cpu" and four:
        B, Sp, H, hs = r2.shape
        y, sT = rwkv6_scan_plain(*map(_fold, (r2, k2, v2, lw2)),
                                 s0.reshape(B * H, hs, hs), chunk=chunk)
        y = y.reshape(B, H, Sp, hs).transpose(1, 2)
        sT = sT.reshape(B, H, hs, hs)
    elif r.device.type == "cpu":
        y, sT = rwkv6_scan_plain(r2, k2, v2, lw2, s0, chunk=chunk)
    else:
        y, sT = _launch(r2, k2, v2, lw2, s0.contiguous() if four else s0,
                        chunk)
    if pad:
        y = y[:, :S]
    if u is not None:
        diag = torch.sum(r * k * (u if four else u[:, None, :]), dim=-1,
                         keepdim=True)
        y = y + diag * v
    return y, sT


def rwkv6_scan_shard(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, s0: torch.Tensor,
                     u: Optional[torch.Tensor] = None, *, chunk: int = 64
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rwkv6_scan`` on one shard's heads (what a per-shard body calls):
    r/k/v/log_w (B, S, H_local, hs), s0 (B, H_local, hs, hs) and ``u``
    (H_local, hs) hold the same heads. Each head's scan is independent
    of the others', so a shard scans its own heads alone (without a
    mesh, one shard holds every head). On the card it launches K4
    (counted in ``rwkv6_scan.launches``); on the CPU the plain
    version."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan_shard: r {tuple(r.shape)} is not "
                         f"(B, S, H_local, hs)")
    if u is not None and tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"rwkv6_scan_shard: u {tuple(u.shape)} does not "
                         f"hold the shard's heads {tuple(r.shape[2:])}")
    return rwkv6_scan(r, k, v, log_w, s0, u, chunk=chunk)


#: kernel launches since the last reset (CPU calls launch nothing)
rwkv6_scan.launches = 0
