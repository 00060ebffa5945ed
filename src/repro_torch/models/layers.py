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

from repro_torch.configs.base import ModelConfig


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

def rope_frequencies(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, n_heads, d_head); positions: (..., seq). The
    rotate-half split (first half / second half), not interleaved."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)   # (dh/2,)
    angles = positions[..., None].float() * freqs       # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
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
