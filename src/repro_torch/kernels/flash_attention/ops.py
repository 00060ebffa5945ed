"""Public wrapper of the flash attention kernel.

``flash_attention`` takes the reference's ``(B, S, heads, dh)`` layout.
On a CPU tensor it computes ``attention_plain``; on a CUDA tensor it
launches the hand-written Hopper kernel (``csrc/flash_attention.cu``)
or raises. The kernel has two paths, chosen by ``kernel_path`` from the
dtype alone: wgmma fed by TMA (bf16) and SIMT (fp32). It is built for
the head dims of ``_HEAD_DIMS`` (64, 80, 112, 128 and 256: every head
dim a config of the registry uses); dh 80 and 112 are read unpadded
(TMA fills the columns past dh with zeros in shared memory, and the
products skip them). Any other dh up to 256 is zero-padded on the host
to the next instance (zero q and k columns leave q k^T unchanged, the
scale stays 1/sqrt(dh) of the real dh, and v's padded columns are
sliced off the output). The backward recomputes through
``attention_plain`` under autograd, as the reference's custom VJP
recomputes through ``attention_ref``; the forward kernel is what
serving runs.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims csrc/flash_attention.cu is instantiated for
_HEAD_DIMS = (64, 80, 112, 128, 256)
#: the kernels of csrc/flash_attention.cu: fp32's and bf16's
PATHS = ("simt", "wgmma")


def padded_head_dim(dh: int) -> int:
    """The instance that runs head dim ``dh``: the least of
    ``_HEAD_DIMS`` that is >= dh (the input is zero-padded up to it).
    Raises ``ValueError`` above 256, which no config uses."""
    for inst in _HEAD_DIMS:
        if inst >= dh:
            return inst
    raise ValueError(f"flash_attention: head dim {dh} > "
                     f"{_HEAD_DIMS[-1]}, the largest the kernel takes")


def kernel_path(dtype: torch.dtype) -> str:
    """The kernel that runs ``dtype``: "wgmma" for bf16 (wgmma fed by
    TMA, at every instance of ``_HEAD_DIMS``; a head dim without one,
    as 16, 32 or 48, runs the next on zero-padded inputs) or "simt" for
    fp32 (on the CUDA cores; TF32 would miss the reference's 2e-5). The
    choice depends on nothing else, and a launch the chosen kernel
    refuses raises: no path stands in for another."""
    return "simt" if dtype == torch.float32 else "wgmma"


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
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} > 65535")


def padded(fn, q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    """``fn`` (the launch, or ``attention_plain`` in the CPU tests) on
    q, k and v zero-padded in dh up to ``padded_head_dim(dh)``, with
    ``scale`` passed as it is (1/sqrt of the real dh), and the padded
    output columns sliced off."""
    dh = q.shape[-1]
    inst = padded_head_dim(dh)
    q, k, v = (F.pad(t, (0, inst - dh)) for t in (q, k, v))
    return fn(q, k, v, causal, window, softcap, scale)[..., :dh].contiguous()


def _launch(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    if padded_head_dim(q.shape[-1]) != q.shape[-1]:
        return padded(_launch, q, k, v, causal, window, softcap, scale)
    _check(q, k, v, window)
    B, Sq, H, dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    path = kernel_path(q.dtype)
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
        raise _build.KernelError(f"flash_attention kernel launch failed "
                                 f"({path} path): cudaError {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    return o


def _forward(q, k, v, causal, window, softcap, scale) -> torch.Tensor:
    """The forward on the inputs' device: plain on the CPU, the kernel
    on the card."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, window, softcap, scale)
    return _launch(q, k, v, causal, window, softcap, scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, softcap, scale)
        return _forward(q, k, v, causal, window, softcap, scale)

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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    # no gradient wanted: the forward alone, without autograd's bookkeeping
    return _forward(q, k, v, causal, window, softcap, scale)


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, head0: int, n_q: int,
                 n_heads: int, n_kv: int):
    """The K/V heads that query heads ``head0 .. head0 + n_q - 1`` (of
    ``n_heads``) read, as (B, S, kv, dh) with kv | n_q, so that local
    query head i meets local KV head i // (n_q // kv). ``k`` / ``v`` hold
    either those queries' own KV heads (split over the mesh like the
    queries) or all ``n_kv`` of them; global query head h reads KV head
    h // (n_heads // n_kv). A group that straddles the shard's edge is
    repeated out to one KV head per query head."""
    if k.shape[2] * n_heads == n_q * n_kv:          # split alike
        return k, v
    rep = n_heads // n_kv
    lo, hi = head0 // rep, (head0 + n_q - 1) // rep + 1
    nk = hi - lo
    if n_q % nk == 0 and all((head0 + i) // rep - lo == i // (n_q // nk)
                             for i in range(n_q)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor([(head0 + i) // rep for i in range(n_q)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def flash_attention_shard(q, k, v, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, *, head0: int,
                          n_heads: int, n_kv: int) -> torch.Tensor:
    """``flash_attention`` on one shard's heads (what a per-shard body
    calls): q holds global query heads ``head0 ..`` of ``n_heads``; k /
    v hold the same heads' KV heads or all ``n_kv`` (``kv_for_heads``).
    On the card it launches K3 through the autograd function, as
    ``flash_attention`` does; on the CPU the plain version."""
    k, v = kv_for_heads(k, v, head0, q.shape[2], n_heads, n_kv)
    return flash_attention(q, k, v, causal, window, softcap, scale)


def flash_attention_sharded(ctx, q, k, v, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None,
                            scale: Optional[float] = None):
    """``flash_attention`` on DTensors over ``ctx``'s mesh (the
    reference's ``shard_map`` around its kernel): q (B, Sq, H, dh) with
    its heads split over ``model`` or whole, k / v (B, Skv, KV, dh) split
    alike or whole. Each rank runs ``flash_attention_shard`` on its
    local heads; the output is laid out as q."""
    from repro_torch.parallel import sharding as sh
    mi = ctx.mesh.mesh_dim_names.index(ctx.model_axis)
    H, KV = q.shape[2], k.shape[2]
    split_heads = q.placements[mi].is_shard(2)
    head0 = (ctx.coordinate(ctx.model_axis) * (H // ctx.n_model_shards)
             if split_heads else 0)
    return sh.shard_map(
        ctx, lambda ql, kl, vl: flash_attention_shard(
            ql, kl, vl, causal, window, softcap, scale, head0=head0,
            n_heads=H, n_kv=KV),
        (q, k, v), (q.placements,),
        split=sh.batch_split(ctx, q) + ((ctx.model_axis,) if split_heads
                                        else ()))


#: kernel launches since the last reset (CPU calls launch nothing), in
#: all and by kernel_path
flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
