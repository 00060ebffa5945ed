"""Unified model, single device: dense / GQA / MoE transformers, RWKV-6
and the Mamba / attention hybrid.

The reference groups layers into *periods* and scans over stacked
period parameters; here the parameters are one dict per layer
(``params["layers"][i]``, kind ``cfg.layer_pattern[i % period]``) and
the scan is a Python loop. ``models/convert.py`` unstacks the
reference's parameters into this layout.

Modes:
  train   — full-sequence forward; no state; each layer under activation
            checkpointing when ``acfg.train.remat`` is set
  prefill — full-sequence forward; returns per-layer states (KV / RWKV /
            Mamba)
  decode  — single token with per-layer states

``forward`` casts the fp32 tensors of ``params`` to the compute dtype on
every call, as the reference does, so training differentiates through
the cast into fp32 master weights. Serving passes parameters already in
the compute dtype (``init_params(..., dtype=...)``), for which the cast
is a no-op: it is paid once, at init.

``forward`` returns the MoE router's load-balance loss summed over the
layers beside the hidden states, as the reference does; training adds
it to the cross-entropy. Nothing here reads ``cfg.n_periods``: a
served model may be cut to a depth that is not a whole number of
periods (the parameters are a list of layers).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (apply_ffn, apply_norm, dense_init,
                                       init_ffn, init_norm, softcap,
                                       truncated_normal)

Params = Dict[str, Any]
States = List[Params]


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def cast_floats(tree, dtype: torch.dtype):
    """Cast fp32 tensors of a parameter tree to the compute dtype
    (mixed precision: fp32 masters live in the optimizer)."""
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

def _init_layer(cfg: ModelConfig, li: int, dtype, *, device,
                generator) -> Params:
    pos = li % cfg.pattern_period
    kind = cfg.layer_pattern[pos]
    kw = dict(device=device, generator=generator)
    p: Params = {"norm1": init_norm(cfg, cfg.d_model, dtype, device=device),
                 "norm2": init_norm(cfg, cfg.d_model, dtype, device=device)}
    if kind == "rwkv":   # the channel-mix lives inside the rwkv param set
        p["mixer"] = ssm_lib.init_rwkv6(cfg, cfg.ssm, dtype, **kw)
        return p
    if kind == "mamba":
        p["mixer"] = ssm_lib.init_mamba(cfg, cfg.ssm, dtype, **kw)
    else:
        p["mixer"] = attn_lib.init_attention(cfg, cfg.attention, dtype,
                                             **kw)
    if cfg.moe_at(pos):
        p["ffn"] = moe_lib.init_moe(cfg, cfg.moe, dtype, **kw)
    else:
        p["ffn"] = init_ffn(cfg, cfg.d_model, cfg.d_ff, dtype, **kw)
    return p


def init_params(acfg: ArchConfig, *, device, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random parameters drawn on ``device``. ``dtype`` (default: the
    config's param dtype) is applied tensor by tensor as each is drawn,
    so initialising in bf16 holds at most one fp32 tensor at a time."""
    cfg = acfg.model
    dtype = dtype or dtype_of(acfg.train.param_dtype)
    kw = dict(device=device, generator=generator)
    params: Params = {
        "embed": truncated_normal((cfg.vocab_size, cfg.d_model), 0.02,
                                  dtype, **kw),
        "layers": [_init_layer(cfg, li, dtype, **kw)
                   for li in range(cfg.num_layers)],
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
                 max_seq: Optional[int], use_flash: bool,
                 use_rwkv_kernel: bool
                 ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """One layer. Returns (x, new_state, aux_loss)."""
    pos = li % cfg.pattern_period
    kind = cfg.layer_pattern[pos]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(cfg, p["norm1"], x)
    if kind == "rwkv":
        h, new_state = _rwkv_time_mix(cfg, p, h, state, mode,
                                      use_rwkv_kernel)
    elif kind == "mamba":
        h, new_state = _mamba_mix(cfg, p, h, state, mode)
    else:
        h, new_state = _attention(cfg, li, p, h, state, mode, positions,
                                  max_seq, use_flash)
    x = x + h.to(x.dtype)
    h2 = apply_norm(cfg, p["norm2"], x)
    if kind == "rwkv":   # the channel mix in place of the FFN
        h2, cm_new = ssm_lib.rwkv6_channel_mix(p["mixer"], h2, state)
        if new_state is not None:
            new_state["shift_cm"] = cm_new
    elif cfg.moe_at(pos):
        # decode is dropless (serving must not drop a live token's experts)
        h2, aux = moe_lib.apply_moe(cfg, cfg.moe, p["ffn"], h2,
                                    dropless=(mode == "decode"))
    else:
        h2 = apply_ffn(cfg, p["ffn"], h2)
    x = x + h2.to(x.dtype)
    return x, new_state, aux


def _attention(cfg: ModelConfig, li: int, p: Params, h: torch.Tensor,
               state: Optional[Params], mode: str,
               positions: Optional[torch.Tensor], max_seq: Optional[int],
               use_flash: bool) -> Tuple[torch.Tensor, Optional[Params]]:
    window = cfg.window_at(li % cfg.pattern_period)
    att = cfg.attention
    fwd = (attn_lib.attention_forward_flash if use_flash
           else attn_lib.attention_forward)
    if mode == "decode":
        h, cache = attn_lib.attention_decode(p["mixer"], att, h,
                                             state["mixer"], window=window)
        return h, {"mixer": cache}
    if mode == "prefill":
        h, kv = fwd(p["mixer"], att, h, positions, window=window,
                    causal=att.causal, return_kv=True)
        return h, {"mixer": _cache_from_prefill(kv, window, max_seq)}
    return fwd(p["mixer"], att, h, positions, window=window,
               causal=att.causal), None


def _rwkv_time_mix(cfg: ModelConfig, p: Params, h: torch.Tensor,
                   state: Optional[Params], mode: str, use_kernel: bool
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill / train: chunked (K4 with ``use_kernel``); decode: the
    exact one-token recurrence."""
    mixer_state = state["mixer"] if state is not None else None
    if mode == "decode":
        h, s = ssm_lib.rwkv6_time_mix_step(cfg, cfg.ssm, p["mixer"], h,
                                           mixer_state)
    else:
        h, s = ssm_lib.rwkv6_time_mix(cfg, cfg.ssm, p["mixer"], h,
                                      mixer_state, use_kernel=use_kernel)
    return h, ({"mixer": s} if mode != "train" else None)


def _mamba_mix(cfg: ModelConfig, p: Params, h: torch.Tensor,
               state: Optional[Params], mode: str
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill / train: the chunked SSD; decode: the exact one-token
    recurrence."""
    mixer_state = state["mixer"] if state is not None else None
    if mode == "decode":
        h, s = ssm_lib.mamba_step(cfg, cfg.ssm, p["mixer"], h, mixer_state)
    else:
        h, s = ssm_lib.mamba_forward(cfg, cfg.ssm, p["mixer"], h,
                                     mixer_state)
    return h, ({"mixer": s} if mode != "train" else None)


#: the products ``dots_saveable`` keeps (matmuls and einsums reach
#: autograd as these)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy(policy: str) -> dict:
    """``checkpoint`` arguments for the reference's ``remat_policy``:
    ``nothing_saveable`` recomputes the whole layer in the backward;
    ``dots_saveable`` (any other value, as in the reference) keeps the
    matmul outputs and recomputes the rest."""
    if policy == "nothing_saveable":
        return {}
    return {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}


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
            ) -> Tuple[torch.Tensor, Optional[States], torch.Tensor]:
    """Returns (hidden (B,S,d) after final norm, new_states, aux_loss):
    aux is the MoE layers' load-balance loss summed over layers (0 for a
    model without MoE).

    ``max_seq``: prefill only — KV-cache slot count to allocate (defaults
    to the prefill length itself, i.e. no room to decode further).
    """
    cfg = acfg.model
    compute_dtype = dtype_of(acfg.train.compute_dtype)
    if compute_dtype != torch.float32:
        params = cast_floats(params, compute_dtype)
    B, S = (tokens.shape if tokens is not None else embeds.shape[:2])
    if mode == "prefill" and max_seq is None:
        max_seq = S
    x = _embed_in(cfg, params, tokens, embeds, compute_dtype)
    positions = None  # decode: attention reads positions from its cache
    if mode != "decode":
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layer = _apply_layer
    if mode == "train" and acfg.train.remat:
        layer = functools.partial(ckpt.checkpoint, _apply_layer,
                                  use_reentrant=False,
                                  **_remat_policy(acfg.train.remat_policy))
    new_states: Optional[States] = [] if mode != "train" else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for li, p in enumerate(params["layers"]):
        st = states[li] if states is not None else None
        x, ns, aux_l = layer(cfg, li, p, x, st, mode, positions, max_seq,
                             acfg.train.use_flash_kernel,
                             acfg.train.use_rwkv_kernel)
        aux = aux + aux_l
        if new_states is not None:
            new_states.append(ns)
    x = apply_norm(cfg, params["final_norm"], x)
    return x, new_states, aux


def logits_fn(acfg: ArchConfig, params: Params,
              hidden: torch.Tensor) -> torch.Tensor:
    cfg = acfg.model
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = hidden @ head.to(hidden.dtype)
    return softcap(logits, cfg.final_logit_softcap)


def loss_fn(acfg: ArchConfig, params: Params, hidden: torch.Tensor,
            labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Chunked (over seq) cross-entropy, so (B,S,V) logits never fully
    materialize: each chunk's logits in fp32, labels of -1 masked out,
    the mean over the unmasked ones. labels: (B,S) int. Autograd keeps
    each chunk's fp32 logits for the backward (the reference's scan
    keeps the same residuals)."""
    cfg = acfg.model
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"loss_fn: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    head = head.to(hidden.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = softcap(h @ head, cfg.final_logit_softcap).float()
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = logits.gather(
            -1, y.clamp(min=0).long()[..., None])[..., 0]
        mask = (y >= 0).float()
        tot = tot + torch.sum((lse - true_logit) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp(cnt, min=1.0)


# =========================================================================
# State init (decode)
# =========================================================================

def init_states(acfg: ArchConfig, batch: int, max_seq: int, *,
                device) -> States:
    """Fresh per-layer states: empty KV caches; zero RWKV and Mamba
    states (fp32, as the reference makes them)."""
    cfg = acfg.model
    cache_dtype = dtype_of(acfg.train.compute_dtype)

    def one_layer(li: int) -> Params:
        pos = li % cfg.pattern_period
        if cfg.layer_pattern[pos] == "rwkv":
            s = ssm_lib.init_rwkv_state(cfg, cfg.ssm, batch, device=device)
            return {"mixer": {"S": s["S"], "shift_tm": s["shift_tm"]},
                    "shift_cm": s["shift_cm"]}
        if cfg.layer_pattern[pos] == "mamba":
            return {"mixer": ssm_lib.init_mamba_state(cfg, cfg.ssm, batch,
                                                      device=device)}
        return {"mixer": attn_lib.init_cache(
            cfg.attention, batch, max_seq, cfg.window_at(pos), cache_dtype,
            device=device)}

    return [one_layer(li) for li in range(cfg.num_layers)]
