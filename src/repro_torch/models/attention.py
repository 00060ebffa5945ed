"""Attention: GQA / qk-norm / sliding-window / logit-softcap, with a
q-blocked plain path for long sequences, a flash path through the
hand-written kernel, and a decode path that reads a ring-buffer KV
cache. Multi-head latent attention (MLA, DeepSeek-V3's) has its own
pair of paths (``mla_forward``, ``mla_decode``) over a latent cache.

Over a mesh (``*_sharded``) each rank runs its share per shard:
training and prefill split the query heads over ``model`` (the
reference's ``heads`` axis) and sum the out-projection's partial rows.
K/V heads are split alike only where ``n_kv_heads`` divides over
``model``; otherwise every rank computes them all from ``wk`` / ``wv``
gathered whole, and each query head meets its own KV head
(``kv_for_heads``). Decode reads a cache whose slots are split over
``model`` and combines the partial softmaxes (flash-decoding).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init,
                                       rms_norm_simple, yarn_mscale)
from repro_torch.parallel import sharding as sh

NEG_INF = -1e30


def init_attention(cfg: ModelConfig, att: AttentionConfig, dtype, *,
                   device, generator) -> dict:
    d = cfg.d_model
    hq, hkv = att.n_heads * att.d_head, att.n_kv_heads * att.d_head
    kw = dict(device=device, generator=generator)
    p = {
        "wq": dense_init(d, hq, dtype, **kw),
        "wk": dense_init(d, hkv, dtype, **kw),
        "wv": dense_init(d, hkv, dtype, **kw),
        "wo": dense_init(hq, d, dtype, **kw),
    }
    if att.qkv_bias:
        p["bq"] = torch.zeros((hq,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv,), dtype=dtype, device=device)
    if att.qk_norm:
        p["q_norm"] = torch.ones((att.d_head,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((att.d_head,), dtype=dtype, device=device)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, S_cache, n_kv, d_head)
    v: torch.Tensor       # (B, S_cache, n_kv, d_head)
    # the *global* write cursor (tokens seen so far); one for the batch.
    # A 0-d int64 tensor on the cache's device, so that a decode step
    # reads no host value and can be replayed as a CUDA graph; a host int
    # over a mesh
    index: torch.Tensor


def _qkv(p: dict, att: AttentionConfig, x: torch.Tensor,
         positions: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,dh), k/v (B,S,KV,dh); qk-norm, then RoPE."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if att.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # -1 heads: a shard's projections hold only its own heads
    q = q.reshape(B, S, -1, att.d_head)
    k = k.reshape(B, S, -1, att.d_head)
    v = v.reshape(B, S, -1, att.d_head)
    if att.qk_norm:
        q = rms_norm_simple(q, p["q_norm"])
        k = rms_norm_simple(k, p["k_norm"])
    if att.use_rope:
        q = apply_rope(q, positions, att.rope_theta)
        k = apply_rope(k, positions, att.rope_theta)
    return q, k, v


def repeat_kv(h: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,KV,dh) -> (B,S,KV*n_rep,dh); kv head j serves q heads
    j*n_rep .. j*n_rep + n_rep - 1."""
    if n_rep == 1:
        return h
    B, S, KV, dh = h.shape
    h = h[:, :, :, None, :].expand(B, S, KV, n_rep, dh)
    return h.reshape(B, S, KV * n_rep, dh)


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive mask (Sq,Skv) in fp32. q_pos (Sq,), kv_pos (Skv,)."""
    ok = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        ok &= (q_pos[:, None] - kv_pos[None, :]) < window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def softmax_scale(att: AttentionConfig) -> float:
    """The scores' scale: the config's, else 1/sqrt(d_head); under YaRN
    times mscale(mscale_all_dim)^2."""
    scale = att.softmax_scale if att.softmax_scale is not None \
        else 1.0 / math.sqrt(att.d_head)
    if att.yarn is not None and att.yarn.mscale_all_dim:
        scale *= yarn_mscale(att.yarn.factor, att.yarn.mscale_all_dim) ** 2
    return scale


def sdpa(q, k, v, bias, *, softcap_val: Optional[float],
         scale: Optional[float] = None) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Skv,H,dh), bias broadcastable to (B,H,Sq,Skv).
    ``scale``: the scores' (default 1/sqrt(dh))."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    if softcap_val is not None:
        scores = torch.tanh(scores / softcap_val) * softcap_val
    scores = scores + bias
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs.to(v.dtype), v)


def attention_forward(p: dict, att: AttentionConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, window: Optional[int],
                      causal: bool, block_q: int = 1024,
                      return_kv: bool = False, use_flash: bool = False):
    """Full-sequence (train / prefill) attention, q-blocked when long;
    with ``use_flash`` the inner softmax-attention runs in the flash
    kernel (CUDA tensors; its plain version on CPU tensors)."""
    B, S, d = x.shape
    q, k, v = _qkv(p, att, x, positions)
    if use_flash:
        # looked up on the package at each call, so that patching it
        # there reaches the model
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal, window, att.logit_softcap,
                              att.softmax_scale)
    else:
        out = _attend(att, q, k, v, positions, window=window,
                      causal=causal, block_q=block_q)
    out = out.reshape(B, S, att.n_heads * att.d_head) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _attend(att: AttentionConfig, q, k, v, positions, *,
            window: Optional[int], causal: bool,
            block_q: int = 1024, scale: Optional[float] = None
            ) -> torch.Tensor:
    """Softmax attention of q (B,S,H,dh) over k/v (B,S,KV,dh), KV | H, in
    fp32 scores; q-blocked when S > block_q. ``scale``: the scores' (by
    default the config's ``softmax_scale``)."""
    S = q.shape[1]
    if scale is None:
        scale = att.softmax_scale
    n_rep = q.shape[2] // k.shape[2]
    kf, vf = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    kv_pos = positions
    if S <= block_q:
        bias = _mask_bias(positions, kv_pos, causal=causal, window=window)
        return sdpa(q, kf, vf, bias[None, None],
                    softcap_val=att.logit_softcap, scale=scale)
    assert S % block_q == 0, (S, block_q)
    blocks = []
    for i in range(S // block_q):
        sl = slice(i * block_q, (i + 1) * block_q)
        bias = _mask_bias(positions[sl], kv_pos, causal=causal,
                          window=window)
        blocks.append(sdpa(q[:, sl], kf, vf, bias[None, None],
                           softcap_val=att.logit_softcap, scale=scale))
    return torch.cat(blocks, dim=1)


def attention_decode(p: dict, att: AttentionConfig, x: torch.Tensor,
                     cache: KVCache, *, window: Optional[int]
                     ) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,d); cache k/v: (B,Sc,KV,dh).

    For windowed layers the cache is a ring buffer of size >= window; for
    full layers Sc is the max context. ``cache.index`` is the global
    token position of the incoming token, a 0-d tensor: the position,
    the ring slot and the mask are computed from it on the device, so
    the launches do not depend on it.
    """
    B, S1, d = x.shape
    assert S1 == 1
    Sc = cache.k.shape[1]
    index = cache.index
    q, k_new, v_new = _qkv(p, att, x, index.to(torch.int32).reshape(1))

    # The new K/V go into the ring-buffer slot IN PLACE (the reference
    # builds a new cache with dynamic_update_slice); the cache belongs to
    # one request's decode state, so nothing else sees the write.
    slot = torch.remainder(index, Sc).reshape(1)
    k, v = cache.k, cache.v
    k.index_copy_(1, slot, k_new.to(k.dtype))
    v.index_copy_(1, slot, v_new.to(v.dtype))

    slots = torch.arange(Sc, dtype=torch.int64, device=x.device)
    out = _decode_attend(att, q, k, v, slots, index, Sc, window=window)
    return out @ p["wo"], KVCache(k=k, v=v, index=index + 1)


def _decode_attend(att: AttentionConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, slots: torch.Tensor, index, Sc: int, *,
                   window: Optional[int], groups=()) -> torch.Tensor:
    """One decode token's attention over cache slots: q (B,1,H,dh); k / v
    (B,n,KV,dh) hold the slots whose global indices in the ring of ``Sc``
    are ``slots`` (n,); ``index`` is the token's position (a 0-d tensor,
    or a host int). Over a mesh each rank holds a share of the slots, and
    the softmax and the output are combined across the process
    ``groups`` (a max, then two sums). Returns (B,1,H*dh), before ``wo``.
    """
    B = q.shape[0]
    # Position of every slot, reconstructed from the ring layout: the
    # most recent position p <= index with p % Sc == slot.
    slot_pos = index - torch.remainder(index - slots, Sc)
    valid = slot_pos >= 0
    if window is not None:
        valid &= (index - slot_pos) < window

    # Grouped layout: q reshaped (B, KV, G, dh), K/V never repeated to H
    # heads. Products accumulate in fp32 from the cache's own values, as
    # the reference's preferred_element_type=fp32 einsums do.
    G = att.n_heads // att.n_kv_heads
    qg = q.reshape(B, att.n_kv_heads, G, att.d_head)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(k.dtype).float(),
                     k.float()) * softmax_scale(att)
    if att.logit_softcap is not None:
        s = torch.tanh(s / att.logit_softcap) * att.logit_softcap
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(valid, zero, NEG_INF)[None, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    for g in groups:
        m = sh.all_reduce_max(m, g)
    e = torch.exp(s - m)
    tot = e.sum(dim=-1, keepdim=True)
    for g in groups:
        tot = sh.all_reduce_sum(tot, g)
    out = torch.einsum("bkgs,bskd->bkgd", (e / tot).to(v.dtype).float(),
                       v.float())
    for g in groups:
        out = sh.all_reduce_sum(out, g)
    return out.to(v.dtype).reshape(B, 1, att.n_heads * att.d_head)


def init_cache(att: AttentionConfig, batch: int, max_seq: int,
               window: Optional[int], dtype, *, device) -> KVCache:
    Sc = min(max_seq, window) if window is not None else max_seq
    shape = (batch, Sc, att.n_kv_heads, att.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros((), dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA)
# ---------------------------------------------------------------------------
#
# As DeepSeek-V3's modelling publishes it, per token x:
#   c_q = RMSNorm(x W_DQ);  q = c_q W_UQ = [q_nope | q_pe] per head
#   [c_kv | k_pe] = x W_DKV;  c_kv = RMSNorm(c_kv);  k_pe roped, one for
#   every head
#   [k_nope | v] = c_kv W_UKV per head
#   o_h = softmax(([q_nope | q_pe] . [k_nope | k_pe]) * scale) v
# The prefill runs that expanded form through K3 (v zero-padded to the
# q / k head dim, the output sliced back). The decode is absorbed: W_UK
# (W_UKV's key columns) folds into the query, q_lat = q_nope W_UK^T, and
# W_UV into the output, o_h = (p . c_kv) W_UV, so the scores read the
# latent cache (c_kv, k_pe) directly and nothing is expanded per
# position.

def init_mla(cfg: ModelConfig, att: AttentionConfig, dtype, *, device,
             generator) -> dict:
    d, H = cfg.d_model, att.n_heads
    rq, rkv, dr = att.q_lora_rank, att.kv_lora_rank, att.qk_rope_head_dim
    dn = att.d_head - dr
    kw = dict(device=device, generator=generator)
    return {"wq_a": dense_init(d, rq, dtype, **kw),
            "q_norm": torch.ones((rq,), dtype=dtype, device=device),
            "wq_b": dense_init(rq, H * att.d_head, dtype, **kw),
            "wkv_a": dense_init(d, rkv + dr, dtype, **kw),
            "kv_norm": torch.ones((rkv,), dtype=dtype, device=device),
            "wkv_b": dense_init(rkv, H * (dn + att.v_head_dim), dtype, **kw),
            "wo": dense_init(H * att.v_head_dim, d, dtype, **kw)}


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S_cache, kv_lora_rank): the normed latent
    k_pe: torch.Tensor    # (B, S_cache, qk_rope_head_dim): the roped key
    # the position of the next token, a 0-d int64 tensor (as KVCache's)
    index: torch.Tensor


def _rope(att: AttentionConfig, x, positions):
    return apply_rope(x, positions, att.rope_theta,
                      interleaved=att.rope_interleaved, yarn=att.yarn)


def _mla_project(p: dict, att: AttentionConfig, x: torch.Tensor,
                 positions: torch.Tensor, eps: float):
    """x (B,S,d) -> q_nope (B,S,H,dn), q_pe (B,S,H,dr) roped, c_kv
    (B,S,r) normed, k_pe (B,S,dr) roped."""
    B, S, _ = x.shape
    r, dr = att.kv_lora_rank, att.qk_rope_head_dim
    c_q = rms_norm_simple(x @ p["wq_a"], p["q_norm"], eps)
    q = (c_q @ p["wq_b"]).reshape(B, S, att.n_heads, att.d_head)
    q_nope, q_pe = q.split([att.d_head - dr, dr], dim=-1)
    kv = x @ p["wkv_a"]
    c_kv = rms_norm_simple(kv[..., :r], p["kv_norm"], eps)
    k_pe = _rope(att, kv[..., None, r:], positions)[:, :, 0]
    return q_nope, _rope(att, q_pe, positions), c_kv, k_pe


def mla_forward(p: dict, att: AttentionConfig, x: torch.Tensor,
                positions: torch.Tensor, *, eps: float,
                use_flash: bool = False, return_latent: bool = False):
    """Full-sequence MLA in the expanded form, causal. With
    ``use_flash`` the softmax-attention runs in K3 on q and k of d_head
    and v zero-padded to it (its output sliced to v_head_dim). With
    ``return_latent`` also (c_kv, k_pe), for the latent cache."""
    B, S, _ = x.shape
    H, dh, dv = att.n_heads, att.d_head, att.v_head_dim
    dr = att.qk_rope_head_dim
    q_nope, q_pe, c_kv, k_pe = _mla_project(p, att, x, positions, eps)
    kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, dh - dr + dv)
    k_nope, v = kv.split([dh - dr, dv], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, dr)], dim=-1)
    scale = softmax_scale(att)
    if use_flash:
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, F.pad(v, (0, dh - dv)), True, None,
                              None, scale)[..., :dv]
    else:
        out = _attend(att, q, k, v, positions, window=None, causal=True,
                      scale=scale)
    out = out.reshape(B, S, H * dv) @ p["wo"]
    return (out, (c_kv, k_pe)) if return_latent else out


def mla_decode(p: dict, att: AttentionConfig, x: torch.Tensor,
               cache: MLACache, *, eps: float
               ) -> tuple[torch.Tensor, MLACache]:
    """One-token absorbed MLA. x: (B,1,d); the token's latent goes into
    its cache slot in place (as ``attention_decode`` writes K/V), then
    the query, with W_UK folded in, scores the latent cache; the
    probabilities' sum of latents meets W_UV. Scores, softmax and sums
    in fp32 over the cache's own values, as ``_decode_attend`` computes
    them; the two folded products take the weights' dtype."""
    B = x.shape[0]
    H, dh, dv = att.n_heads, att.d_head, att.v_head_dim
    r, dr = att.kv_lora_rank, att.qk_rope_head_dim
    index = cache.index
    Sc = cache.c_kv.shape[1]
    q_nope, q_pe, c_new, kpe_new = _mla_project(
        p, att, x, index.to(torch.int32).reshape(1), eps)
    slot = torch.remainder(index, Sc).reshape(1)
    c_kv, k_pe = cache.c_kv, cache.k_pe
    c_kv.index_copy_(1, slot, c_new.to(c_kv.dtype))
    k_pe.index_copy_(1, slot, kpe_new.to(k_pe.dtype))
    w = p["wkv_b"].reshape(r, H, dh - dr + dv)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w[..., :dh - dr])
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
         + torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(), k_pe.float())) \
        * softmax_scale(att)
    slots = torch.arange(Sc, dtype=torch.int64, device=x.device)
    valid = index - torch.remainder(index - slots, Sc) >= 0
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    probs = torch.softmax(s + torch.where(valid, zero, NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", probs, c_kv.float())
    out = torch.einsum("bhr,rhd->bhd", o_lat.to(w.dtype), w[..., dh - dr:])
    out = out.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return out, MLACache(c_kv=c_kv, k_pe=k_pe, index=index + 1)


def init_mla_cache(att: AttentionConfig, batch: int, max_seq: int, dtype,
                   *, device) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, max_seq, att.kv_lora_rank), dtype=dtype,
                         device=device),
        k_pe=torch.zeros((batch, max_seq, att.qk_rope_head_dim),
                         dtype=dtype, device=device),
        index=torch.zeros((), dtype=torch.int64, device=device))


def mla_cache_from_prefill(latent, max_seq: int) -> MLACache:
    """The prefill's (c_kv, k_pe) in a cache of ``max_seq`` slots (the
    unwritten ones masked by position)."""
    c_kv, k_pe = latent
    B, S, _ = c_kv.shape
    if max_seq > S:
        c_kv = F.pad(c_kv, (0, 0, 0, max_seq - S))
        k_pe = F.pad(k_pe, (0, 0, 0, max_seq - S))
    return MLACache(c_kv=c_kv, k_pe=k_pe,
                    index=torch.full((), S, dtype=torch.int64,
                                     device=c_kv.device))


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------

def attention_forward_sharded(ctx, p: dict, att: AttentionConfig, x,
                              positions: torch.Tensor, *,
                              window: Optional[int], causal: bool,
                              use_flash: bool, return_kv: bool = False):
    """``attention_forward`` (or the flash path) over ``ctx``'s mesh. x:
    the activations' DTensor (B,S,d). Returns the output on x's layout
    and, with ``return_kv``, the K/V DTensors (heads split over
    ``model`` where ``n_kv_heads`` divides, else whole)."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_shard, kv_for_heads)
    H, KV, mx = att.n_heads, att.n_kv_heads, ctx.model_axis
    m = ctx.n_model_shards
    heads = "heads" if H % m == 0 else None
    kv_heads = "heads" if heads and KV % m == 0 else None
    head0 = ctx.coordinate(mx) * (H // m) if heads else 0
    layout = {"wq": (None, heads), "wk": (None, kv_heads),
              "wv": (None, kv_heads), "wo": (heads, None), "bq": (heads,),
              "bk": (kv_heads,), "bv": (kv_heads,), "q_norm": (None,),
              "k_norm": (None,)}
    keys = sorted(p)
    w = [ctx.constrain(p[k], *layout[k]) for k in keys]
    B, S = x.shape[:2]

    def body(h, pos, *wl):
        pl = dict(zip(keys, wl))
        q, k, v = _qkv(pl, att, h, pos)
        if use_flash:
            out = flash_attention_shard(q, k, v, causal, window,
                                        att.logit_softcap,
                                        att.softmax_scale, head0=head0,
                                        n_heads=H, n_kv=KV)
        else:
            ks, vs = kv_for_heads(k, v, head0, q.shape[2], H, KV)
            out = _attend(att, q, ks, vs, pos, window=window, causal=causal)
        y = out.reshape(h.shape[0], S, -1) @ pl["wo"]
        return (y, k, v) if return_kv else (y,)

    mi = ctx.mesh.mesh_dim_names.index(mx)
    kv_pl = list(x.placements)
    kv_pl[mi] = sh.Shard(2) if kv_heads else sh.Replicate()
    y_pl = sh.summed_over(ctx, x.placements, (mx,) if heads else ())
    outs = sh.shard_map(ctx, body, (x, positions, *w),
                        (y_pl, tuple(kv_pl), tuple(kv_pl)),
                        split=sh.batch_split(ctx, x) + ((mx,) if heads
                                                        else ()))
    y = outs[0].redistribute(ctx.mesh, x.placements)
    return (y, (outs[1], outs[2])) if return_kv else y


def attention_decode_sharded(ctx, p: dict, att: AttentionConfig, x,
                             cache: KVCache, *, window: Optional[int]
                             ) -> tuple:
    """``attention_decode`` over ``ctx``'s mesh: the cache's slots are
    split over the mesh dims that shard its dim 1 (``state_logical_axes``);
    each rank writes the new K/V if it holds the slot, scores its own
    slots, and the softmax and the output are combined across those
    ranks (a max, then two sums). Weights are gathered whole."""
    keys = sorted(p)
    w = [ctx.constrain(p[k], *([None] * p[k].ndim)) for k in keys]
    names = ctx.mesh.mesh_dim_names
    seq_axes = tuple(names[i] for i, pl in enumerate(cache.k.placements)
                     if pl.is_shard(1))
    Sc = cache.k.shape[1]
    n, idx = 1, 0
    for a in seq_axes:            # nested in mesh-dim order, as DTensor
        idx = idx * ctx.size(a) + ctx.coordinate(a)
        n *= ctx.size(a)
    if Sc % n:
        raise ValueError(f"attention_decode_sharded: {Sc} cache slots do "
                         f"not split evenly over {seq_axes} ({n} ranks)")
    Sl = Sc // n
    off = idx * Sl
    index = int(cache.index)
    groups = [ctx.group(a) for a in seq_axes]

    def body(h, kc, vc, *wl):
        pl = dict(zip(keys, wl))
        pos = torch.full((1,), index, dtype=torch.int32, device=h.device)
        q, k_new, v_new = _qkv(pl, att, h, pos)
        slot = index % Sc
        if off <= slot < off + Sl:
            kc[:, slot - off] = k_new[:, 0].to(kc.dtype)
            vc[:, slot - off] = v_new[:, 0].to(vc.dtype)
        slots = off + torch.arange(Sl, dtype=torch.int64, device=h.device)
        out = _decode_attend(att, q, kc, vc, slots, index, Sc,
                             window=window, groups=groups)
        return out @ pl["wo"]

    y = sh.shard_map(ctx, body, (x, cache.k, cache.v, *w), (x.placements,),
                     split=sh.batch_split(ctx, x) + seq_axes)
    return y, KVCache(k=cache.k, v=cache.v, index=index + 1)
