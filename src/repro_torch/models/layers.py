"""Shared layers: norms, activations, RoPE, FFN, initializers.

Plain functions on tensors: every module is an ``init_*`` returning a
dict of parameters and an ``apply_*`` consuming it. Dense weights keep
the reference layout ``(d_in, d_out)`` and apply as ``x @ w``, so
parameters convert from the JAX package by copy.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, YarnConfig


def truncated_normal(shape, scale, dtype, *, device,
                     generator: torch.Generator) -> torch.Tensor:
    """A standard normal truncated at +-2, then scaled (as the reference
    draws it: truncate first, scale after)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (x * scale).to(dtype)


def dense_init(d_in, d_out, dtype, *, device, generator, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return truncated_normal((d_in, d_out), scale, dtype, device=device,
                            generator=generator)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the dtype JAX would promote the pair to (``fp32 @
    bf16`` is an fp32 product in JAX, where torch's ``@`` refuses mixed
    dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: int, dtype, *, device) -> dict:
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm, at the config's ``norm_eps``."""
    eps = cfg.norm_eps
    dt = x.dtype
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["scale"].float()).to(dt)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def rms_norm_simple(x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6) -> torch.Tensor:
    """Headwise qk-norm helper (no config)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Profiler ranges
# ---------------------------------------------------------------------------

def profiler_range(name: str):
    """A ``torch.profiler`` range of ``name`` on the host's timeline. It
    is one of function scope: ``record_function``'s user scope would also
    be projected onto the device's timeline, where a device trace counts
    it as device work. ``_RecordFunctionFast`` is private API, checked
    on torch 2.11.0+cu128 and 2.13.0+cpu; ``tests/test_torch_serve_spans.py``
    fails with a plain message where a torch release drops it."""
    return torch._C._profiler._RecordFunctionFast(name)


def profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process (a traced
    run's sub-window)."""
    return torch.autograd.profiler._is_profiler_enabled


def profiled(name: str):
    """The model's own ranges (``model.mamba``): :func:`profiler_range`
    while a profiler records, and nothing entered otherwise."""
    return profiler_range(name) if profiling() else nullcontext()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor: 0.1 mscale ln(factor) + 1 (1 at no
    scaling)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(d_head: int, theta: float,
                          yarn: YarnConfig) -> tuple:
    """(low, high): the dims whose wavelengths make ``beta_fast`` and
    ``beta_slow`` turns over the original context, floored and ceiled,
    within [0, d_head - 1]. The dim of ``b`` turns is d ln(L / (2 pi b))
    / (2 ln theta)."""
    def dim(turns):
        return d_head * math.log(yarn.original_max_position_embeddings
                                 / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    return (max(math.floor(dim(yarn.beta_fast)), 0),
            min(math.ceil(dim(yarn.beta_slow)), d_head - 1))


def rope_frequencies(d_head: int, theta: float, device,
                     yarn: Optional[YarnConfig] = None) -> torch.Tensor:
    """theta^(-2i/d_head) for i < d_head / 2; under YaRN blended with it
    divided by ``yarn.factor`` on a linear ramp from ``low`` (unscaled at
    and below) to ``high`` (divided at and above), in float32 as
    DeepSeek-V3's rotary embedding computes them."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    freqs = 1.0 / (theta ** exps)
    if yarn is None:
        return freqs
    low, high = yarn_correction_range(d_head, theta, yarn)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d_head // 2, dtype=torch.float32, device=device)
             - low) / (high - low)).clamp(0, 1)
    return freqs / yarn.factor * ramp + freqs * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               *, interleaved: bool = False,
               yarn: Optional[YarnConfig] = None) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq). The
    rotate-half split (first half / second half), or with
    ``interleaved`` the pairs (x[2i], x[2i+1]), each rotated at
    frequency i and left in place; under YaRN cos and sin scaled by
    mscale(mscale) / mscale(mscale_all_dim)."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device, yarn)   # (dh/2,)
    angles = positions[..., None].float() * freqs       # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    if yarn is not None:
        m = yarn_mscale(yarn.factor, yarn.mscale) \
            / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
        cos, sin = cos * m, sin * m
    if interleaved:
        xf = x.float().unflatten(-1, (d_head // 2, 2))
        x1, x2 = xf[..., 0], xf[..., 1]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).flatten(-2)
        return out.to(x.dtype)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / FFN
# ---------------------------------------------------------------------------

def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def init_ffn(cfg: ModelConfig, d: int, f: int, dtype, *, device,
             generator) -> dict:
    kw = dict(device=device, generator=generator)
    if cfg.ffn_activation in ("swiglu", "geglu"):
        return {"w_gate": dense_init(d, f, dtype, **kw),
                "w_up": dense_init(d, f, dtype, **kw),
                "w_down": dense_init(f, d, dtype, **kw)}
    return {"w_up": dense_init(d, f, dtype, **kw),
            "w_down": dense_init(f, d, dtype, **kw)}


def apply_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    act = cfg.ffn_activation
    if act in ("swiglu", "geglu"):
        inner = activation("silu" if act == "swiglu" else "gelu",
                           x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        inner = activation(act, x @ p["w_up"])
    return inner @ p["w_down"]


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)
