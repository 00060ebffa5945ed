"""Unified model, single device: dense GQA transformers.

The reference groups layers into *periods* and scans over stacked
period parameters; here the parameters are one dict per layer
(``params["layers"][i]``, kind ``cfg.layer_pattern[i % period]``) and
the scan is a Python loop. ``models/convert.py`` unstacks the
reference's parameters into this layout.

Modes:
  train   — full-sequence forward; no state
  prefill — full-sequence forward; returns per-layer states (KV)
  decode  — single token with per-layer states

Parameters are used as they are: the caller casts them to the compute
dtype once (``cast_floats``), where the reference casts on every call.
Mamba / RWKV layers and MoE FFNs are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_ffn, apply_norm, dense_init,
                                       init_ffn, init_norm, softcap,
                                       truncated_normal)

Params = Dict[str, Any]
States = List[Params]

_NOT_PORTED = {
    "mamba": "Mamba layers are not ported yet (ROADMAP.md, Queue 1: "
             "models/ssm.py)",
    "rwkv": "RWKV-6 layers are not ported yet (ROADMAP.md, Queue 1: "
            "models/ssm.py, with kernel K4 rwkv6_scan of Queue 2)",
    "moe": "MoE FFNs are not ported yet (ROADMAP.md, Queue 1: "
           "models/moe.py)",
}


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    for kind in cfg.layer_pattern:
        if kind != "attn":
            raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED[kind]}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {_NOT_PORTED['moe']}")


def cast_floats(tree, dtype: torch.dtype):
    """Cast fp32 tensors of a parameter tree to the compute dtype (the
    reference's per-call ``cast_floats``, done once by the caller)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.dtype == torch.float32 else tree
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


# =========================================================================
# Init
# =========================================================================

def _init_layer(cfg: ModelConfig, dtype, *, device, generator) -> Params:
    kw = dict(device=device, generator=generator)
    return {"norm1": init_norm(cfg, cfg.d_model, dtype, device=device),
            "norm2": init_norm(cfg, cfg.d_model, dtype, device=device),
            "mixer": attn_lib.init_attention(cfg, cfg.attention, dtype,
                                             **kw),
            "ffn": init_ffn(cfg, cfg.d_model, cfg.d_ff, dtype, **kw)}


def init_params(acfg: ArchConfig, *, device, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters drawn on ``device``. ``dtype`` (default: the
    config's param dtype) is applied tensor by tensor as each is drawn,
    so initialising in bf16 holds at most one fp32 tensor at a time."""
    cfg = acfg.model
    check_supported(cfg)
    dtype = dtype or dtype_of(acfg.train.param_dtype)
    kw = dict(device=device, generator=generator)
    params: Params = {
        "embed": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02,
                                  dtype, **kw),
        "layers": [_init_layer(cfg, dtype, **kw)
                   for _ in range(cfg.num_layers)],
        "final_norm": init_norm(cfg, cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(cfg.d_model, cfg.vocab_size, dtype,
                                       **kw)
    return params


# =========================================================================
# Layer application
# =========================================================================

def _apply_layer(cfg: ModelConfig, li: int, p: Params, x: torch.Tensor,
                 state: Optional[Params], mode: str,
                 positions: Optional[torch.Tensor],
                 max_seq: Optional[int], use_flash: bool
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """One layer. Returns (x, new_state)."""
    window = cfg.window_at(li % cfg.pattern_period)
    att = cfg.attention
    h = apply_norm(cfg, p["norm1"], x)
    new_state: Optional[Params] = None
    fwd = (attn_lib.attention_forward_flash if use_flash
           else attn_lib.attention_forward)
    if mode == "decode":
        h, cache = attn_lib.attention_decode(p["mixer"], att, h,
                                             state["mixer"], window=window)
        new_state = {"mixer": cache}
    elif mode == "prefill":
        h, kv = fwd(p["mixer"], att, h, positions, window=window,
                    causal=att.causal, return_kv=True)
        new_state = {"mixer": _cache_from_prefill(kv, window, max_seq)}
    else:
        h = fwd(p["mixer"], att, h, positions, window=window,
                causal=att.causal)
    x = x + h.to(x.dtype)
    h2 = apply_ffn(cfg, p["ffn"], apply_norm(cfg, p["norm2"], x))
    x = x + h2.to(x.dtype)
    return x, new_state


def _cache_from_prefill(kv, window: Optional[int],
                        max_seq: int) -> KVCache:
    """Lay prefill K/V out as a ring buffer of Sc slots (slot = pos % Sc)."""
    k, v = kv
    B, S, KV, dh = k.shape
    Sc = min(max_seq, window) if window is not None else max_seq
    if Sc < S:      # windowed: keep the last Sc positions, ring layout
        k = torch.roll(k[:, -Sc:], S % Sc, dims=1)
        v = torch.roll(v[:, -Sc:], S % Sc, dims=1)
    elif Sc > S:    # room to grow: unwritten slots are masked by position
        kp, vp = k.new_zeros((B, Sc, KV, dh)), v.new_zeros((B, Sc, KV, dh))
        kp[:, :S], vp[:, :S] = k, v
        k, v = kp, vp
    return KVCache(k=k, v=v, index=S)


# =========================================================================
# Full model
# =========================================================================

def _embed_in(cfg, params, tokens, embeds, compute_dtype):
    if cfg.frontend is not None:
        assert embeds is not None, f"{cfg.name} needs frontend embeds"
        return embeds.to(compute_dtype)
    return params["embed"][tokens.long()].to(compute_dtype)


def forward(acfg: ArchConfig, params: Params, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            states: Optional[States] = None,
            mode: str = "train",
            max_seq: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[States]]:
    """Returns (hidden (B,S,d) after final norm, new_states).

    ``max_seq``: prefill only — KV-cache slot count to allocate (defaults
    to the prefill length itself, i.e. no room to decode further).
    """
    cfg = acfg.model
    check_supported(cfg)
    compute_dtype = dtype_of(acfg.train.compute_dtype)
    B, S = (tokens.shape if tokens is not None else embeds.shape[:2])
    if mode == "prefill" and max_seq is None:
        max_seq = S
    x = _embed_in(cfg, params, tokens, embeds, compute_dtype)
    positions = None  # decode: attention reads positions from its cache
    if mode != "decode":
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    new_states: Optional[States] = [] if mode != "train" else None
    for li, p in enumerate(params["layers"]):
        st = states[li] if states is not None else None
        x, ns = _apply_layer(cfg, li, p, x, st, mode, positions, max_seq,
                             acfg.train.use_flash_kernel)
        if new_states is not None:
            new_states.append(ns)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, new_states


def logits_fn(acfg: ArchConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    cfg = acfg.model
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = hidden @ head.to(hidden.dtype)
    return softcap(logits, cfg.final_logit_softcap)


# =========================================================================
# State init (decode)
# =========================================================================

def init_states(acfg: ArchConfig, batch: int, max_seq: int, *,
                device) -> States:
    """Fresh per-layer states (empty KV caches)."""
    cfg = acfg.model
    check_supported(cfg)
    cache_dtype = dtype_of(acfg.train.compute_dtype)
    return [{"mixer": attn_lib.init_cache(
                cfg.attention, batch, max_seq,
                cfg.window_at(li % cfg.pattern_period), cache_dtype,
                device=device)}
            for li in range(cfg.num_layers)]
