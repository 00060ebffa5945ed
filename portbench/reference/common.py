"""Pieces both references share: the float32 setting, the products
(plain, or fake-quantised to float8 e4m3 for the control) and the
norms."""
from __future__ import annotations

import torch

#: largest finite values of the two float8 formats
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def strict_fp32() -> None:
    """float32 products stay float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 (``fmt``) with one absmax scale per slice
    along ``dim`` (per row of activations, per output column of a
    weight; ``dim=None``: one scale for the tensor), back in float32:
    the control's lower precision."""
    amax = (x.abs().amax(dim=dim, keepdim=True) if dim is not None
            else x.abs().amax()).clamp(min=1e-30)
    s = FP8_MAX[fmt] / amax
    return (x * s).to(fmt).float() / s


class _Fp8Matmul(torch.autograd.Function):
    """``a @ w`` as a float8 training step computes it: the forward's
    operands in e4m3, and in the backward the incoming gradient in e5m2
    (per row, or per tensor) multiplied by the forward's e4m3
    operands."""

    @staticmethod
    def forward(ctx, a, w, per_tensor: bool):
        qa = fp8(a, None if per_tensor else -1)
        qw = fp8(w, None if per_tensor else -2)
        ctx.save_for_backward(qa, qw)
        ctx.per_tensor = per_tensor
        return qa @ qw

    @staticmethod
    def backward(ctx, g):
        qa, qw = ctx.saved_tensors
        qg = fp8(g, None if ctx.per_tensor else -1, torch.float8_e5m2)
        ga = (qg @ qw.transpose(-1, -2)).sum_to_size(qa.shape)
        gw = (qa.transpose(-1, -2) @ qg).sum_to_size(qw.shape)
        return ga, gw, None


def mm(a: torch.Tensor, w: torch.Tensor, control) -> torch.Tensor:
    """``a @ w`` in float32; with ``control`` in float8 (``_Fp8Matmul``),
    scaled per row and column (``"fp8"`` or True) or per tensor
    (``"fp8_tensor"``)."""
    if control:
        return _Fp8Matmul.apply(a, w, control == "fp8_tensor")
    return a @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def f32(tree):
    """A parameter tree upcast to float32."""
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()
