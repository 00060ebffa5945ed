"""Public wrapper of the flash attention kernel.

``flash_attention`` takes the reference's ``(B, S, heads, dh)`` layout.
On a CPU tensor it computes ``attention_plain``; on a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/flash_attention.cu``)
or raises. The backward recomputes through ``attention_plain`` under
autograd, as the reference's custom VJP recomputes through
``attention_ref``; the forward kernel is what serving runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


_fa_fwd = None


def _kernel():
    """The C entry of csrc/flash_attention.cu, built on first use."""
    global _fa_fwd
    if _fa_fwd is None:
        fn = _build.load("flash_attention").fa_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
        _fa_fwd = fn
    return _fa_fwd


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"the kernel needs q, k, v on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            f"kernel takes float32 or bfloat16, all alike")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} must be a 4-d "
                             f"tensor with a contiguous head dim (dh), got "
                             f"{tuple(t.shape)} with strides {t.stride()}")
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary and step its batch, "
                             f"sequence and head strides {t.stride()[:3]} "
                             f"in 16-byte multiples (the kernel loads "
                             f"16-byte vectors)")
    B, Sq, H, dh = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh
            or H % k.shape[2] != 0):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"form (B, Sq, H, dh) / (B, Skv, KV, dh), KV | H")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{_HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} > 65535")


def _launch(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    _check(q, k, v, window)
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Sq, Skv, H, KV, dh, strides, int(bool(causal)),
            int(window) if window is not None else 0,
            float(softcap) if softcap is not None else 0.0,
            float(scale), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, causal, window, softcap, scale)
        return _launch(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_plain(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Skv, KV, dh) -> (B, Sq, H, dh).

    On the card q, k and v may be strided views (heads split out of one
    fused projection, say) as long as dh is contiguous; the output is
    contiguous. The reference's TPU tiling knobs (``block_q``, ``block_k``,
    ``interpret``) have no counterpart: the kernel picks its own tiles
    and masks ragged edges itself."""
    scale = scale if scale is not None else 1.0 / q.shape[-1] ** 0.5
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)


#: kernel launches since the last reset (CPU calls launch nothing)
flash_attention.launches = 0
