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
  prefill — full-sequence forward; returns per-layer states (KV / latent
            / RWKV / Mamba)
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

Over a device mesh (``ctx`` from ``parallel.sharding``; default
``NO_MESH``) the parameters are DTensors laid out by
``param_logical_axes`` and the activations between blocks DTensors
pinned by ``_constrain_act``, as the reference pins them. Where the
reference leaves the rest to GSPMD, each block here runs per shard
(``sharding.shard_map``) with its collectives explicit: the fsdp
weights are gathered at use (the parameter-server pull; the gather's
backward reduce-scatters the gradients, the push), attention and the
FFN split their heads and ``d_ff`` over ``model`` (a row-parallel
output is summed by the redistribute after it), the embedding and the
loss split the vocab where it is sharded. The recurrent mixers split
their heads over ``model`` the same way: each rank scans its own heads
(the WKV scan through K4's per-shard entry, the SSD in PyTorch), with
the per-head tensors the reference replicates sliced to those heads.
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
                                       init_ffn, init_norm, profiled,
                                       softcap, truncated_normal)
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import LP, NO_MESH, ParallelCtx

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


def cast_params_for_compute(ctx: ParallelCtx, acfg: ArchConfig,
                            params: Params, dtype) -> Params:
    """cast_floats + re-pin every leaf to its own sharding: the cast
    runs on each rank's shard, so the fsdp gathers after it move
    ``dtype`` bytes (the reference's constraint keeps GSPMD from
    hoisting the gather above the convert)."""
    params = cast_floats(params, dtype)
    if ctx.mesh is None:
        return params
    return _zip_logical(lambda a, lp: ctx.constrain(a, *lp), params,
                        param_logical_axes(acfg))


def _zip_logical(fn, tree, axes):
    """``fn(leaf, lp)`` over a tree and its logical axes, side by side."""
    if isinstance(tree, dict):
        return {k: _zip_logical(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_logical(fn, v, a) for v, a in zip(tree, axes)]
    return fn(tree, axes)


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
    elif cfg.attention.mla:
        p["mixer"] = attn_lib.init_mla(cfg, cfg.attention, dtype, **kw)
    else:
        p["mixer"] = attn_lib.init_attention(cfg, cfg.attention, dtype,
                                             **kw)
    if cfg.moe_layer(li):
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


# ---------------- logical sharding of every parameter ---------------------

def _norm_axes(cfg: ModelConfig) -> Params:
    return ({"scale": LP(None)} if cfg.norm == "rmsnorm"
            else {"scale": LP(None), "bias": LP(None)})


def _layer_axes(acfg: ArchConfig, li: int) -> Params:
    """The reference's axes of period position ``li % period`` without
    its leading ``layers`` axis."""
    cfg = acfg.model
    pos = li % cfg.pattern_period
    kind = cfg.layer_pattern[pos]
    p: Params = {"norm1": _norm_axes(cfg), "norm2": _norm_axes(cfg)}
    if kind == "attn":
        att = cfg.attention
        m = {"wq": LP("fsdp", "heads"), "wk": LP("fsdp", "heads"),
             "wv": LP("fsdp", "heads"), "wo": LP("heads", "fsdp")}
        if att.qkv_bias:
            m.update({"bq": LP("heads"), "bk": LP("heads"),
                      "bv": LP("heads")})
        if att.qk_norm:
            m.update({"q_norm": LP(None), "k_norm": LP(None)})
        p["mixer"] = m
    elif kind == "mamba":
        p["mixer"] = {
            "z_proj": LP("fsdp", "heads"), "x_proj": LP("fsdp", "heads"),
            "bc_proj": LP("fsdp", None), "dt_proj": LP("fsdp", None),
            "conv_w": LP(None, "heads"), "conv_b": LP("heads"),
            "conv_w_bc": LP(None, None), "conv_b_bc": LP(None),
            "a_log": LP(None), "d_skip": LP(None), "dt_bias": LP(None),
            "norm": LP("heads"), "out_proj": LP("heads", "fsdp")}
    elif kind == "rwkv":
        p["mixer"] = {
            "mu_w": LP(None), "mu_r": LP(None), "mu_k": LP(None),
            "mu_v": LP(None), "mu_g": LP(None),
            "w0": LP(None, None), "w_lora_a": LP("fsdp", None),
            "w_lora_b": LP(None, None), "u": LP(None, None),
            "wr": LP("fsdp", "heads"), "wk": LP("fsdp", "heads"),
            "wv": LP("fsdp", "heads"), "wg": LP("fsdp", "heads"),
            "wo": LP("heads", "fsdp"), "ln_x": LP(None),
            "mu_k_cm": LP(None), "mu_r_cm": LP(None),
            "wk_cm": LP("fsdp", "d_ff"), "wv_cm": LP("d_ff", "fsdp"),
            "wr_cm": LP("fsdp", "heads")}
        return p
    if cfg.moe_layer(li):
        es = acfg.parallel.expert_sharding or cfg.moe.expert_sharding
        f = moe_lib.moe_param_logical_axes(
            es, cfg.moe.d_ff_shared is not None)
        if cfg.ffn_activation not in ("swiglu", "geglu"):
            f = {k: v for k, v in f.items() if k != "w_gate"}
    else:
        f = {"w_up": LP("fsdp", "d_ff"), "w_down": LP("d_ff", "fsdp")}
        if cfg.ffn_activation in ("swiglu", "geglu"):
            f["w_gate"] = LP("fsdp", "d_ff")
    p["ffn"] = f
    return p


def vocab_axis(cfg: ModelConfig) -> Optional[str]:
    """Tiny vocabs (hubert's 504-label codebook) cannot shard over the
    16-way model axis, and gain nothing from it: replicated."""
    return "vocab" if (cfg.vocab_size % 16 == 0
                       and cfg.vocab_size >= 4096) else None


def param_logical_axes(acfg: ArchConfig) -> Params:
    """A tree matching ``init_params``' structure; leaves are ``LP``s of
    *logical* axis names (see ``parallel.sharding.logical_to_physical``):
    the reference's axes per layer, without its stacked ``layers``
    axis."""
    cfg = acfg.model
    vocab_ax = vocab_axis(cfg)
    axes: Params = {
        "embed": LP(vocab_ax, "fsdp"),
        "layers": [_layer_axes(acfg, li) for li in range(cfg.num_layers)],
        "final_norm": _norm_axes(cfg),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = LP("fsdp", vocab_ax)
    return axes


def distribute_params(ctx: ParallelCtx, acfg: ArchConfig,
                      params: Params) -> Params:
    """Whole parameters (the same on every rank) as DTensors on their
    placements: each rank keeps its shards, nothing is sent. The
    identity without a mesh."""
    if ctx.mesh is None:
        return params
    return _zip_logical(
        lambda a, lp: sh.place(a, ctx.mesh, ctx.placements(*lp)), params,
        param_logical_axes(acfg))


# =========================================================================
# Layer application
# =========================================================================

def _apply_layer(cfg: ModelConfig, li: int, p: Params, x: torch.Tensor,
                 state: Optional[Params], mode: str,
                 positions: Optional[torch.Tensor],
                 max_seq: Optional[int], use_flash: bool,
                 use_rwkv_kernel: bool, ctx: ParallelCtx = NO_MESH
                 ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """One layer. Returns (x, new_state, aux_loss); under a mesh aux is
    the local value of the mean over the shards (the same on every
    rank)."""
    pos = li % cfg.pattern_period
    kind = cfg.layer_pattern[pos]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(ctx, cfg, p["norm1"], x)
    if kind == "rwkv":
        h, new_state = _rwkv_time_mix(cfg, p, h, state, mode,
                                      use_rwkv_kernel, ctx)
    elif kind == "mamba":
        h, new_state = _mamba_mix(cfg, p, h, state, mode, ctx)
    else:
        h, new_state = _attention(cfg, li, p, h, state, mode, positions,
                                  max_seq, use_flash, ctx)
    x = _constrain_act(ctx, x + _branch(cfg, h, x))
    h2 = _norm(ctx, cfg, p["norm2"], x)
    if kind == "rwkv":   # the channel mix in place of the FFN
        h2, cm_new = _rwkv_channel_mix(ctx, p["mixer"], h2, state)
        if new_state is not None:
            new_state["shift_cm"] = cm_new
    elif cfg.moe_layer(li):
        # decode is dropless (serving must not drop a live token's experts)
        h2, aux = moe_lib.apply_moe(cfg, cfg.moe, p["ffn"], h2,
                                    dropless=(mode == "decode"), ctx=ctx)
    else:
        h2 = _ffn(ctx, cfg, p["ffn"], h2)
    x = _constrain_act(ctx, x + _branch(cfg, h2, x))
    return x, new_state, aux


def _branch(cfg: ModelConfig, h: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
    """A residual branch as it is added to ``x``: times the config's
    ``residual_multiplier`` where it has one."""
    if cfg.residual_multiplier is not None:
        h = h * cfg.residual_multiplier
    return h.to(x.dtype)


def _constrain_act(ctx: ParallelCtx, x: torch.Tensor) -> torch.Tensor:
    """Activations: batch over (pod, data) when divisible, else replicated
    (single-stream decode)."""
    if x.shape[0] % max(ctx.n_batch_shards, 1) == 0:
        return ctx.constrain(x, "batch", None, None)
    return ctx.constrain(x, None, None, None)


def _norm(ctx: ParallelCtx, cfg: ModelConfig, p: Params,
          x: torch.Tensor) -> torch.Tensor:
    """``apply_norm``; under a mesh per shard of the batch (the scale is
    replicated)."""
    if ctx.mesh is None:
        return apply_norm(cfg, p, x)
    keys = sorted(p)
    return sh.shard_map(
        ctx, lambda xl, *w: apply_norm(cfg, dict(zip(keys, w)), xl),
        (x, *(p[k] for k in keys)), (x.placements,),
        split=sh.batch_split(ctx, x))


def _ffn(ctx: ParallelCtx, cfg: ModelConfig, p: Params,
         x: torch.Tensor) -> torch.Tensor:
    """``apply_ffn``; under a mesh tensor-parallel over ``d_ff``: the up
    and gate columns and the down rows of each rank's ``d_ff`` slice
    (fsdp shards gathered first), the partial outputs summed over
    ``model``."""
    if ctx.mesh is None:
        return apply_ffn(cfg, p, x)
    keys = sorted(p)
    w = [ctx.constrain(p[k], *(("d_ff", None) if k == "w_down"
                               else (None, "d_ff"))) for k in keys]
    split = sh.batch_split(ctx, x) + (ctx.model_axis,)
    y = sh.shard_map(
        ctx, lambda xl, *wl: apply_ffn(cfg, dict(zip(keys, wl)), xl),
        (x, *w), (sh.summed_over(ctx, x.placements, (ctx.model_axis,)),),
        split=split)
    return y.redistribute(ctx.mesh, x.placements)


def _attention(cfg: ModelConfig, li: int, p: Params, h: torch.Tensor,
               state: Optional[Params], mode: str,
               positions: Optional[torch.Tensor], max_seq: Optional[int],
               use_flash: bool, ctx: ParallelCtx = NO_MESH
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    window = cfg.window_at(li % cfg.pattern_period)
    att = cfg.attention
    if att.mla:
        return _mla(cfg, p, h, state, mode, positions, max_seq, use_flash,
                    ctx)
    if ctx.mesh is not None:
        return _attention_sharded(ctx, cfg, p, h, state, mode, positions,
                                  max_seq, use_flash, window)
    if mode == "decode":
        h, cache = attn_lib.attention_decode(p["mixer"], att, h,
                                             state["mixer"], window=window)
        return h, {"mixer": cache}
    if mode == "prefill":
        h, kv = attn_lib.attention_forward(
            p["mixer"], att, h, positions, window=window, causal=att.causal,
            return_kv=True, use_flash=use_flash)
        return h, {"mixer": _cache_from_prefill(kv, window, max_seq)}
    return attn_lib.attention_forward(
        p["mixer"], att, h, positions, window=window, causal=att.causal,
        use_flash=use_flash), None


def _mla(cfg: ModelConfig, p: Params, h: torch.Tensor,
         state: Optional[Params], mode: str,
         positions: Optional[torch.Tensor], max_seq: Optional[int],
         use_flash: bool, ctx: ParallelCtx = NO_MESH
         ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Latent attention: the prefill expanded (K3 with ``use_flash``),
    leaving the latent cache; the decode absorbed over it. While a
    profiler records, the range ``model.mla``."""
    if ctx.mesh is not None:
        raise NotImplementedError(f"{cfg.name}: latent attention runs on "
                                  f"one device only")
    att, eps = cfg.attention, cfg.norm_eps
    with profiled("model.mla"):
        if mode == "decode":
            h, cache = attn_lib.mla_decode(p["mixer"], att, h,
                                           state["mixer"], eps=eps)
            return h, {"mixer": cache}
        out = attn_lib.mla_forward(p["mixer"], att, h, positions, eps=eps,
                                   use_flash=use_flash,
                                   return_latent=(mode == "prefill"))
        if mode != "prefill":
            return out, None
        h, latent = out
        return h, {"mixer": attn_lib.mla_cache_from_prefill(latent,
                                                            max_seq)}


def _attention_sharded(ctx: ParallelCtx, cfg: ModelConfig, p: Params,
                       h, state, mode, positions, max_seq, use_flash,
                       window):
    att = cfg.attention
    if mode == "decode":
        h, cache = attn_lib.attention_decode_sharded(
            ctx, p["mixer"], att, h, state["mixer"], window=window)
        return h, {"mixer": cache}
    out = attn_lib.attention_forward_sharded(
        ctx, p["mixer"], att, h, positions, window=window,
        causal=att.causal, use_flash=use_flash,
        return_kv=(mode == "prefill"))
    if mode != "prefill":
        return out, None
    h, (k, v) = out
    return h, {"mixer": _sharded_cache(ctx, k, v, window, max_seq)}


def _sharded_cache(ctx: ParallelCtx, k, v, window: Optional[int],
                   max_seq: int) -> KVCache:
    """Prefill K/V as the ring-buffer cache in the decode layout of
    ``state_logical_axes``: heads whole, the slots split over ``model``
    (or, for one stream, over the whole mesh)."""
    rep = tuple(p if p.is_shard(0) else sh.Replicate()
                for p in k.placements)
    k, v = k.redistribute(ctx.mesh, rep), v.redistribute(ctx.mesh, rep)
    cache = _cache_from_prefill((k.to_local(), v.to_local()), window,
                                max_seq)
    pl = ctx.placements(*_cache_axes(ctx, k.shape[0]))

    def put(t):
        return sh.DTensor.from_local(t, ctx.mesh, rep, run_check=False) \
            .redistribute(ctx.mesh, pl)
    return KVCache(k=put(cache.k), v=put(cache.v), index=k.shape[1])


def _cache_axes(ctx: ParallelCtx, batch: int) -> LP:
    """A KV cache's (B, Sc, KV, dh) axes: see ``state_logical_axes``."""
    single = batch == 1 or batch % max(ctx.n_batch_shards, 1) != 0
    return LP(None if single else "batch",
              "kv_seq_all" if single else "kv_seq", None, None)


def _rwkv_time_mix(cfg: ModelConfig, p: Params, h: torch.Tensor,
                   state: Optional[Params], mode: str, use_kernel: bool,
                   ctx: ParallelCtx = NO_MESH
                   ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill / train: chunked (K4 with ``use_kernel``); decode: the
    exact one-token recurrence."""
    if ctx.mesh is not None:
        return _rwkv_time_mix_sharded(ctx, cfg, p, h, state, mode,
                                      use_kernel)
    mixer_state = state["mixer"] if state is not None else None
    if mode == "decode":
        h, s = ssm_lib.rwkv6_time_mix_step(cfg, cfg.ssm, p["mixer"], h,
                                           mixer_state)
    else:
        h, s = ssm_lib.rwkv6_time_mix(cfg, cfg.ssm, p["mixer"], h,
                                      mixer_state, use_kernel=use_kernel)
    return h, ({"mixer": s} if mode != "train" else None)


def _mamba_mix(cfg: ModelConfig, p: Params, h: torch.Tensor,
               state: Optional[Params], mode: str,
               ctx: ParallelCtx = NO_MESH
               ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Prefill / train: the chunked SSD; decode: the exact one-token
    recurrence. While a profiler records, the range ``model.mamba``."""
    with profiled("model.mamba"):
        if ctx.mesh is not None:
            return _mamba_mix_sharded(ctx, cfg, p, h, state, mode)
        mixer_state = state["mixer"] if state is not None else None
        if mode == "decode":
            h, s = ssm_lib.mamba_step(cfg, cfg.ssm, p["mixer"], h,
                                      mixer_state)
        else:
            h, s = ssm_lib.mamba_forward(cfg, cfg.ssm, p["mixer"], h,
                                         mixer_state)
        return h, ({"mixer": s} if mode != "train" else None)


# ---------------- the recurrent mixers over a mesh ------------------------

#: the time-mix weights of an ``rwkv`` layer (the rest is the channel mix)
_RWKV_TM = ("mu_w", "mu_r", "mu_k", "mu_v", "mu_g", "w0", "w_lora_a",
            "w_lora_b", "u", "wr", "wk", "wv", "wg", "wo", "ln_x")
_RWKV_CM = ("mu_k_cm", "mu_r_cm", "wk_cm", "wv_cm", "wr_cm")


def _local_heads(ctx: ParallelCtx, n_heads: int):
    """(logical axis of the head dims, this rank's heads, its first head):
    the heads split over ``model`` where they divide, else whole on every
    rank."""
    m = ctx.n_model_shards
    if n_heads % m:
        return None, n_heads, 0
    n = n_heads // m
    return "heads", n, ctx.coordinate(ctx.model_axis) * n


def _state_placements(ctx: ParallelCtx, x, head_dim: Optional[int] = None,
                      heads: Optional[str] = None) -> tuple:
    """A state tensor's layout: its dim 0 on the activations' batch
    layout, ``head_dim`` over ``model`` where the heads split."""
    pl = [sh.Shard(0) if p.is_shard(0) else sh.Replicate()
          for p in x.placements]
    if heads is not None and head_dim is not None:
        pl[ctx.mesh.mesh_dim_names.index(ctx.model_axis)] = \
            sh.Shard(head_dim)
    return tuple(pl)


def _recurrent_sharded(ctx: ParallelCtx, h, w: dict, state: Optional[dict],
                       state_pl: dict, heads: Optional[str], body):
    """Run ``body(x, weights, state)`` per shard (the weights' dict on
    each rank's local tensors; ``state`` None or a dict) and wrap its
    (partial output, new state) back: the output summed over ``model``
    where the heads split, each state tensor on ``state_pl``."""
    wk, sk = sorted(w), sorted(state_pl)
    mx = ctx.model_axis
    st = [] if state is None else [
        sh.to_placements(state[k], ctx.mesh, state_pl[k]) for k in sk]

    def run(xl, *rest):
        wl = dict(zip(wk, rest[:len(wk)]))
        sl = dict(zip(sk, rest[len(wk):])) if state is not None else None
        y, ns = body(xl, wl, sl)
        return (y, *(ns[k] for k in sk))
    y_pl = sh.summed_over(ctx, h.placements, (mx,) if heads else ())
    outs = sh.shard_map(ctx, run, (h, *(w[k] for k in wk), *st),
                        (y_pl, *(state_pl[k] for k in sk)),
                        split=sh.batch_split(ctx, h) + ((mx,) if heads
                                                        else ()))
    return (outs[0].redistribute(ctx.mesh, h.placements),
            dict(zip(sk, outs[1:])))


def _rwkv_time_mix_sharded(ctx: ParallelCtx, cfg: ModelConfig, p: Params,
                           h, state, mode: str, use_kernel: bool):
    """The time mix per shard: each rank projects r, k, v, g onto its
    heads (the columns of ``wr`` .. ``wg``), slices the per-head tensors
    the reference replicates (``w0``, ``w_lora_b``, ``u``, ``ln_x``) to
    them, scans them (K4 through
    ``rwkv6_scan_shard`` with ``use_kernel``) and multiplies by its rows
    of ``wo``: a partial sum over ``model``. The per-head GroupNorm
    needs no collective."""
    ssm = cfg.ssm
    hs = ssm.head_size
    heads, n, h0 = _local_heads(ctx, cfg.d_model // hs)
    layout = {"wr": (None, heads), "wk": (None, heads), "wv": (None, heads),
              "wg": (None, heads), "wo": (heads, None)}
    pm = p["mixer"]
    w = {k: ctx.constrain(pm[k], *layout.get(k, (None,) * pm[k].ndim))
         for k in _RWKV_TM}
    c0, c1 = h0 * hs, (h0 + n) * hs
    state_pl = {"S": _state_placements(ctx, h, 1, heads),
                "shift_tm": _state_placements(ctx, h)}

    def body(x, wl, st):
        wl = dict(wl, w0=wl["w0"][h0:h0 + n], u=wl["u"][h0:h0 + n],
                  w_lora_b=wl["w_lora_b"][:, c0:c1], ln_x=wl["ln_x"][c0:c1])
        if mode == "decode":
            return ssm_lib.rwkv6_time_mix_step(cfg, ssm, wl, x, st)
        return ssm_lib.rwkv6_time_mix(cfg, ssm, wl, x, st,
                                      use_kernel=use_kernel)
    mixer = state["mixer"] if state is not None else None
    y, ns = _recurrent_sharded(ctx, h, w, mixer, state_pl, heads, body)
    return y, ({"mixer": ns} if mode != "train" else None)


def _mamba_mix_sharded(ctx: ParallelCtx, cfg: ModelConfig, p: Params, h,
                       state, mode: str):
    """The Mamba mixer per shard: each rank holds its heads' columns of
    ``d_inner`` (``z_proj``, ``x_proj``, the conv, ``norm``) and slices
    the per-head tensors the reference replicates (``dt_proj``'s
    columns, ``a_log``, ``d_skip``, ``dt_bias``); B and C (``bc_proj``,
    the ``bc`` conv) are whole on every rank. The gated RMSNorm's mean
    over the whole ``d_inner`` sums the shards' squares over ``model``;
    ``out_proj``'s rows give a partial sum."""
    ssm = cfg.ssm
    _, H, _ = ssm_lib.mamba_dims(cfg, ssm)
    heads, n, h0 = _local_heads(ctx, H)
    layout = {"z_proj": (None, heads), "x_proj": (None, heads),
              "conv_w": (None, heads), "conv_b": (heads,),
              "norm": (heads,), "out_proj": (heads, None)}
    pm = p["mixer"]
    w = {k: ctx.constrain(v, *layout.get(k, (None,) * v.ndim))
         for k, v in pm.items()}
    group = ctx.group(ctx.model_axis) if heads else None
    state_pl = {"h": _state_placements(ctx, h, 1, heads),
                "conv": _state_placements(ctx, h, 2, heads),
                "conv_bc": _state_placements(ctx, h)}

    def body(x, wl, st):
        wl = dict(wl, dt_proj=wl["dt_proj"][:, h0:h0 + n],
                  a_log=wl["a_log"][h0:h0 + n],
                  d_skip=wl["d_skip"][h0:h0 + n],
                  dt_bias=wl["dt_bias"][h0:h0 + n])
        if mode == "decode":
            return ssm_lib.mamba_step(cfg, ssm, wl, x, st, norm_group=group)
        return ssm_lib.mamba_forward(cfg, ssm, wl, x, st, norm_group=group)
    mixer = state["mixer"] if state is not None else None
    y, ns = _recurrent_sharded(ctx, h, w, mixer, state_pl, heads, body)
    return y, ({"mixer": ns} if mode != "train" else None)


def _rwkv_channel_mix(ctx: ParallelCtx, p: Params, x,
                      state: Optional[Params]):
    """``rwkv6_channel_mix``; under a mesh per shard: ``wk_cm``'s
    columns and ``wv_cm``'s rows of each rank's ``d_ff`` slice give a
    partial sum of the value, ``wr_cm``'s columns (laid out on
    ``heads``) a slice of the receptance. The partial sum is reduced
    (scattered onto the receptance's columns) before the product, then
    the product is gathered whole."""
    if ctx.mesh is None:
        return ssm_lib.rwkv6_channel_mix(p, x, state)
    mx = ctx.model_axis
    mi = ctx.mesh.mesh_dim_names.index(mx)
    layout = {"wk_cm": (None, "d_ff"), "wv_cm": ("d_ff", None),
              "wr_cm": (None, "heads")}
    w = [ctx.constrain(p[k], *layout.get(k, (None,))) for k in _RWKV_CM]
    shift_pl = _state_placements(ctx, x)
    prev = None if state is None else sh.to_placements(
        state["shift_cm"], ctx.mesh, shift_pl)

    def body(xl, *rest):
        return ssm_lib.channel_mix_factors(
            dict(zip(_RWKV_CM, rest[:len(_RWKV_CM)])), xl,
            rest[len(_RWKV_CM)] if prev is not None else None)
    cols = list(x.placements)
    cols[mi] = sh.Shard(2)
    r, v, last = sh.shard_map(
        ctx, body, (x, *w, *([prev] if prev is not None else [])),
        (tuple(cols), sh.summed_over(ctx, x.placements, (mx,)), shift_pl),
        split=sh.batch_split(ctx, x) + (mx,))
    out = r * v.redistribute(ctx.mesh, tuple(cols))
    return out.redistribute(ctx.mesh, x.placements), last


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
    """Lay prefill K/V out as a ring buffer of Sc slots (slot = pos % Sc);
    the position on the device (``KVCache.index``)."""
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
    return KVCache(k=k, v=v, index=torch.full((), S, dtype=torch.int64,
                                              device=k.device))


# =========================================================================
# Full model
# =========================================================================

def _embed_in(ctx, cfg, params, tokens, embeds, compute_dtype):
    if cfg.frontend is not None:
        assert embeds is not None, f"{cfg.name} needs frontend embeds"
        return _constrain_act(ctx, embeds.to(compute_dtype))
    if ctx.mesh is None:
        return params["embed"][tokens.long()].to(compute_dtype)
    # the vocab rows this rank holds; a token elsewhere reads zeros, and
    # the sum over ``model`` takes each row from its one holder
    vocab_ax = vocab_axis(cfg)
    table = ctx.constrain(params["embed"], vocab_ax, None)
    tokens = _constrain_tokens(ctx, tokens)
    split = sh.batch_split(ctx, tokens)
    if vocab_ax is not None:
        split += (ctx.model_axis,)
    off = (ctx.coordinate(ctx.model_axis) * table.to_local().shape[0]
           if vocab_ax is not None else 0)

    def body(tok, tab):
        t = tok.long() - off
        ok = (t >= 0) & (t < tab.shape[0])
        rows = tab[t.clamp(0, tab.shape[0] - 1)]
        return torch.where(ok[..., None], rows, 0).to(compute_dtype)
    x = sh.shard_map(ctx, body, (tokens, table),
                     (sh.summed_over(ctx, tokens.placements,
                                     (ctx.model_axis,) if vocab_ax
                                     else ()),),
                     split=split)
    return _constrain_act(ctx, x)


def _constrain_tokens(ctx: ParallelCtx, t):
    """Token ids or labels (B, S) on the activations' batch layout."""
    if t.shape[0] % max(ctx.n_batch_shards, 1) == 0:
        return ctx.constrain(t, "batch", None)
    return ctx.constrain(t, None, None)


def _head(ctx: ParallelCtx, cfg: ModelConfig, params: Params):
    """The output projection (d, V) gathered over fsdp (vocab still split
    where ``vocab_axis`` shards it); transposed from the embedding when
    tied."""
    vocab_ax = vocab_axis(cfg)
    if cfg.tie_embeddings:
        head = params["embed"]
        return head.T if ctx.mesh is None else \
            ctx.constrain(head, vocab_ax, None)
    return params["lm_head"] if ctx.mesh is None else \
        ctx.constrain(params["lm_head"], None, vocab_ax)


def forward(acfg: ArchConfig, params: Params, *,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            states: Optional[States] = None,
            mode: str = "train",
            max_seq: Optional[int] = None,
            ctx: ParallelCtx = NO_MESH
            ) -> Tuple[torch.Tensor, Optional[States], torch.Tensor]:
    """Returns (hidden (B,S,d) after final norm, new_states, aux_loss):
    aux is the MoE layers' load-balance loss summed over layers (0 for a
    model without MoE).

    ``max_seq``: prefill only — KV-cache slot count to allocate (defaults
    to the prefill length itself, i.e. no room to decode further).
    Under a mesh ``params`` are DTensors (``distribute_params``), the
    hidden states come back a DTensor and aux a plain 0-d tensor.
    """
    cfg = acfg.model
    compute_dtype = dtype_of(acfg.train.compute_dtype)
    if compute_dtype != torch.float32:
        params = cast_params_for_compute(ctx, acfg, params, compute_dtype)
    B, S = (tokens.shape if tokens is not None else embeds.shape[:2])
    if mode == "prefill" and max_seq is None:
        max_seq = S
    x = _embed_in(ctx, cfg, params, tokens, embeds, compute_dtype)
    if cfg.embedding_multiplier is not None:
        x = x * cfg.embedding_multiplier
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
                             acfg.train.use_rwkv_kernel, ctx)
        aux = aux + aux_l
        if new_states is not None:
            new_states.append(ns)
    x = _norm(ctx, cfg, params["final_norm"], x)
    return x, new_states, aux


def logits_fn(acfg: ArchConfig, params: Params, hidden: torch.Tensor,
              ctx: ParallelCtx = NO_MESH) -> torch.Tensor:
    """Under a mesh, a DTensor laid out (batch, None, vocab)."""
    cfg = acfg.model
    head = _head(ctx, cfg, params)
    if ctx.mesh is None:
        return _out_logits(cfg, hidden @ head.to(hidden.dtype))
    tied = cfg.tie_embeddings
    split = sh.batch_split(ctx, hidden)
    vocab_split = vocab_axis(cfg) is not None
    out_pl = list(hidden.placements)
    if vocab_split:
        out_pl[ctx.mesh.mesh_dim_names.index(ctx.model_axis)] = sh.Shard(2)
        split += (ctx.model_axis,)

    def body(h, w):
        w = (w.T if tied else w).to(h.dtype)
        return _out_logits(cfg, h @ w)
    logits = sh.shard_map(ctx, body, (hidden, head), (tuple(out_pl),),
                          split=split)
    b_ax = "batch" if hidden.shape[0] % ctx.n_batch_shards == 0 else None
    return ctx.constrain(logits, b_ax, None, "vocab")


def _out_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """The head's product as the model's logits: divided by the config's
    ``logits_scaling`` where it has one, then soft-capped where it caps."""
    if cfg.logits_scaling is not None:
        logits = logits / cfg.logits_scaling
    return softcap(logits, cfg.final_logit_softcap)


def loss_fn(acfg: ArchConfig, params: Params, hidden: torch.Tensor,
            labels: torch.Tensor, chunk: int = 512,
            ctx: ParallelCtx = NO_MESH) -> torch.Tensor:
    """Chunked (over seq) cross-entropy, so (B,S,V) logits never fully
    materialize: each chunk's logits in fp32, labels of -1 masked out,
    the mean over the unmasked ones. labels: (B,S) int. Autograd keeps
    each chunk's fp32 logits for the backward (the reference's scan
    keeps the same residuals). Under a mesh each rank takes its rows of
    the batch and, where ``vocab_axis`` shards the vocab, its columns:
    the logsumexp and the true logit are summed over ``model``; the
    result is a plain 0-d tensor, the same on every rank."""
    cfg = acfg.model
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"loss_fn: sequence {S} is not a multiple of the "
                         f"chunk {chunk}")
    head = _head(ctx, cfg, params)
    if ctx.mesh is None:
        tot, cnt = _ce_sums(cfg, hidden, labels, head.to(hidden.dtype),
                            chunk)
        return tot / torch.clamp(cnt, min=1.0)
    tied = cfg.tie_embeddings
    labels = _constrain_tokens(ctx, labels)
    split = sh.batch_split(ctx, hidden)
    vocab = None
    if vocab_axis(cfg) is not None and ctx.n_model_shards > 1:
        split += (ctx.model_axis,)
        n_local = head.to_local().shape[0 if tied else 1]
        vocab = (ctx.coordinate(ctx.model_axis) * n_local,
                 ctx.group(ctx.model_axis))

    def body(h, y, w):
        w = (w.T if tied else w).to(h.dtype)
        return _ce_sums(cfg, h, y, w, chunk, vocab)
    # the sums over the batch are per shard; over model they are whole
    pl = sh.summed_over(ctx, [sh.Replicate()] * ctx.mesh.ndim,
                        sh.batch_split(ctx, hidden))
    tot, cnt = sh.shard_map(ctx, body, (hidden, labels, head), (pl, pl),
                            split=split)
    rep = [sh.Replicate()] * ctx.mesh.ndim
    tot, cnt = (t.redistribute(ctx.mesh, rep).to_local() for t in (tot, cnt))
    return tot / torch.clamp(cnt, min=1.0)


def _ce_sums(cfg: ModelConfig, hidden, labels, head, chunk: int,
             vocab=None):
    """(sum of the masked NLL, count of unmasked labels) over the chunks.
    ``vocab``: None, or (first column held, process group) when ``head``
    holds only this rank's columns of the vocab."""
    S = hidden.shape[1]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        h, y = hidden[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        logits = _out_logits(cfg, h @ head).float()
        if vocab is None:
            lse = torch.logsumexp(logits, dim=-1)
            true_logit = logits.gather(
                -1, y.clamp(min=0).long()[..., None])[..., 0]
        else:
            off, group = vocab
            m = sh.all_reduce_max(logits.amax(dim=-1), group)
            se = torch.exp(logits - m[..., None]).sum(dim=-1)
            lse = torch.log(sh.all_reduce_sum(se, group)) + m
            t = y.long() - off
            ok = (t >= 0) & (t < logits.shape[-1])
            mine = logits.gather(
                -1, t.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
            true_logit = sh.all_reduce_sum(torch.where(ok, mine, 0.0),
                                           group)
        mask = (y >= 0).float()
        tot = tot + torch.sum((lse - true_logit) * mask)
        cnt = cnt + torch.sum(mask)
    return tot, cnt


# =========================================================================
# State init (decode)
# =========================================================================

def init_states(acfg: ArchConfig, batch: int, max_seq: int, *,
                device, ctx: ParallelCtx = NO_MESH) -> States:
    """Fresh per-layer states: empty KV caches; zero RWKV and Mamba
    states (fp32, as the reference makes them). Under a mesh, DTensors
    laid out by ``state_logical_axes``."""
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
        if cfg.attention.mla:
            return {"mixer": attn_lib.init_mla_cache(
                cfg.attention, batch, max_seq, cache_dtype, device=device)}
        return {"mixer": attn_lib.init_cache(
            cfg.attention, batch, max_seq, cfg.window_at(pos), cache_dtype,
            device=device)}

    states = [one_layer(li) for li in range(cfg.num_layers)]
    if ctx.mesh is None:
        return states

    def put(a, lp):
        return sh.place(a, ctx.mesh, ctx.placements(*lp))

    def put_tree(st, ax):
        if isinstance(st, KVCache):   # the position a host int (0)
            return KVCache(put(st.k, ax.k), put(st.v, ax.v), 0)
        if isinstance(st, dict):
            return {k: put_tree(v, ax[k]) for k, v in st.items()}
        return put(st, ax)
    axes = state_logical_axes(acfg, batch, ctx)
    return [put_tree(st, ax) for st, ax in zip(states, axes)]


def state_logical_axes(acfg: ArchConfig, batch: int,
                       ctx: ParallelCtx = NO_MESH) -> States:
    """Logical axes for decode states (mirrors ``init_states``; the
    reference's per position, without its ``layers`` axis).

    KV caches shard their SEQUENCE dim (flash-decoding style): over
    'model' for batched decode (batch rides (pod, data)), over the whole
    mesh for single-stream decode (one stream, or a batch the batch
    shards do not divide). KV heads stay replicated."""
    cfg = acfg.model
    single = batch == 1 or batch % max(ctx.n_batch_shards, 1) != 0
    b_ax = None if single else "batch"

    def one_layer(li: int) -> Params:
        kind = cfg.layer_pattern[li % cfg.pattern_period]
        if kind == "attn":
            kv = _cache_axes(ctx, batch)
            return {"mixer": KVCache(k=kv, v=kv, index=LP())}
        if kind == "mamba":
            return {"mixer": {"h": LP(b_ax, "heads", None, None),
                              "conv": LP(b_ax, None, "heads"),
                              "conv_bc": LP(b_ax, None, None)}}
        if kind == "rwkv":
            return {"mixer": {"S": LP(b_ax, "heads", None, None),
                              "shift_tm": LP(b_ax, None)},
                    "shift_cm": LP(b_ax, None)}
        raise ValueError(kind)

    return [one_layer(li) for li in range(cfg.num_layers)]
