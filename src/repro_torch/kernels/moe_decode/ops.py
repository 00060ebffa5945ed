"""Public wrapper of the routed-expert GLU FFN kernel (K5).

``moe_decode_ffn(x, ids, w_gate, w_up, w_down, act, expert_offset)``
computes, for each assignment row ``x[a]`` and its expert ``e =
ids[a]``, ``(act(x[a] W_gate[e]) * (x[a] W_up[e])) W_down[e]``: a
dropless MoE decode's expert FFN over its routed experts alone. The
weights may hold a share of the experts (``expert_offset`` on): a row
routed elsewhere is zero, and the kernel reads no weight for it. On CPU
tensors it is ``moe_decode_plain``; on CUDA tensors it launches the
hand-written Hopper kernel (``csrc/moe_decode.cu``, four launches a
call) or raises.
The expert ids stay on the device and nothing waits for it, so a CUDA
graph that captures the call replays it with whatever ids the graph's
input holds. The kernel has no backward: on the card an input that
requires a gradient is refused."""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_decode.ref import ACTIVATIONS, moe_decode_plain

#: dtypes the kernel is built for, with the values a 16-byte load holds
VALUES_PER_16B = {torch.float32: 4, torch.bfloat16: 8}
#: blocks each product's launch aims for: about one resident set of
#: 8-warp blocks on the card's 132 SMs (1024 read faster than 2048 or
#: 4096 at both of the serve cells' shapes on an H100, PERF.md)
TARGET_BLOCKS = 1024
#: the fewest rows a split of the reduction axis takes: the block's 8
#: warps with 8 rows each in flight
MIN_ROWS = 64
#: columns a block covers: a warp's 32 lanes of 16 bytes
_LANES = 32

_fn = None


def _kernel():
    """The C entry of csrc/moe_decode.cu, built on first use."""
    global _fn
    if _fn is None:
        fn = _build.load("moe_decode").moe_decode_ffn
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def splits(K: int, N: int, rows: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(splits, rows a split) of a product's reduction axis K, for N
    outputs over ``rows`` matrices x assignments: about as many splits
    as bring the launch to ``TARGET_BLOCKS`` blocks, each a multiple of
    ``MIN_ROWS`` rows (the last may hold fewer; one split where K holds
    fewer than ``MIN_ROWS``)."""
    tiles = -(-N // (_LANES * VALUES_PER_16B[dtype])) * rows
    s = max(1, min(-(-TARGET_BLOCKS // tiles), K // MIN_ROWS))
    r = -(-K // (s * MIN_ROWS)) * MIN_ROWS
    return -(-K // r), r


def _check(x, ids, w_gate, w_up, w_down, act) -> None:
    dev = x.device
    for name, t in (("x", x), ("ids", ids), ("w_gate", w_gate),
                    ("w_up", w_up), ("w_down", w_down)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"moe_decode_ffn: {name} is on {t.device}; the "
                             f"kernel needs every input on one CUDA device")
    if x.dtype not in VALUES_PER_16B:
        raise TypeError(f"moe_decode_ffn: x is {x.dtype}; the kernel takes "
                        f"float32 or bfloat16")
    for name, w in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if w.dtype != x.dtype:
            raise TypeError(f"moe_decode_ffn: {name} is {w.dtype} and x "
                            f"{x.dtype}; the kernel takes one dtype")
        if not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"moe_decode_ffn: {name} must be contiguous "
                             f"and start on a 16-byte boundary (the "
                             f"kernel streams 16-byte vectors)")
    if ids.dtype != torch.int64 or ids.dim() != 1 or not ids.is_contiguous():
        raise TypeError(f"moe_decode_ffn: ids must be a contiguous (A,) "
                        f"int64 tensor, not {ids.dtype} {tuple(ids.shape)}")
    if x.dim() != 2 or x.stride(1) != 1:
        raise ValueError(f"moe_decode_ffn: x must be (A, d) with a "
                         f"contiguous last axis (strides {x.stride()})")
    A, d = x.shape
    E, f = w_gate.shape[0], w_gate.shape[-1]
    if A < 1 or ids.shape != (A,) or w_gate.shape != (E, d, f) \
            or w_up.shape != (E, d, f) or w_down.shape != (E, f, d):
        raise ValueError(f"moe_decode_ffn: shapes x {tuple(x.shape)}, ids "
                         f"{tuple(ids.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)} do not form (A, d), "
                         f"(A,), (E, d, f) x 2 and (E, f, d)")
    v = VALUES_PER_16B[x.dtype]
    if d % v or f % v:
        raise ValueError(f"moe_decode_ffn: d {d} and f {f} must be "
                         f"multiples of {v} (16-byte rows of {x.dtype})")
    if act not in ACTIVATIONS:
        raise ValueError(f"moe_decode_ffn: activation {act!r} not in "
                         f"{sorted(ACTIVATIONS)}")


def _launch(x, ids, w_gate, w_up, w_down, act: str,
            expert_offset: int) -> torch.Tensor:
    _check(x, ids, w_gate, w_up, w_down, act)
    A, d = x.shape
    E, f = w_gate.shape[0], w_gate.shape[2]
    s_up, r_up = splits(d, f, 2 * A, x.dtype)
    s_down, r_down = splits(f, d, A, x.dtype)
    n_up = 2 * A * s_up * f
    part = torch.empty(n_up + A * s_down * d, dtype=torch.float32,
                       device=x.device)
    inner = torch.empty((A, f), dtype=x.dtype, device=x.device)
    out = torch.empty((A, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x.data_ptr(), x.stride(0), ids.data_ptr(),
                        w_gate.data_ptr(), w_up.data_ptr(),
                        w_down.data_ptr(), part.data_ptr(), inner.data_ptr(),
                        part[n_up:].data_ptr(), out.data_ptr(), A, d, f,
                        s_up, r_up, s_down, r_down, expert_offset, E,
                        list(ACTIVATIONS).index(act),
                        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise _build.KernelError(f"moe_decode kernel launch failed: "
                                 f"cudaError {err}")
    moe_decode_ffn.launches += 1
    return out


def moe_decode_ffn(x: torch.Tensor, ids: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor,
                   act: str = "silu", expert_offset: int = 0
                   ) -> torch.Tensor:
    """x: (A, d) assignment rows (a row stride of 0 lets the k
    assignments of one token share its row on the card); ids: (A,) int64
    expert of each row; w_gate, w_up: (E, d, f); w_down: (E, f, d),
    experts ``expert_offset`` .. + E - 1 (a row routed to another is
    zero); act: ``silu`` or ``gelu`` (tanh). Returns (A, d) in the
    weights' dtype."""
    ts = (x, ids, w_gate, w_up, w_down)
    if all(t.device.type == "cpu" for t in ts):
        return moe_decode_plain(x, ids, w_gate, w_up, w_down, act,
                                expert_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("moe_decode_ffn: an input requires a gradient, "
                         "and the kernel has no backward")
    return _launch(x, ids, w_gate, w_up, w_down, act, expert_offset)


#: calls that launched the kernel since the last reset (four launches
#: each; CPU calls launch nothing)
moe_decode_ffn.launches = 0
