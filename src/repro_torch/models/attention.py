"""Attention: GQA / qk-norm / sliding-window / logit-softcap, with a
q-blocked plain path for long sequences, a flash path through the
hand-written kernel, and a decode path that reads a ring-buffer KV
cache.

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

from repro_torch.configs.base import AttentionConfig, ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rms_norm_simple
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
    """The scores' scale: the config's, else 1/sqrt(d_head)."""
    if att.softmax_scale is not None:
        return att.softmax_scale
    return 1.0 / math.sqrt(att.d_head)


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
                      return_kv: bool = False):
    """Full-sequence (train / prefill) attention, q-blocked when long."""
    B, S, d = x.shape
    q, k, v = _qkv(p, att, x, positions)
    out = _attend(att, q, k, v, positions, window=window, causal=causal,
                  block_q=block_q)
    out = out.reshape(B, S, att.n_heads * att.d_head) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _attend(att: AttentionConfig, q, k, v, positions, *,
            window: Optional[int], causal: bool,
            block_q: int = 1024) -> torch.Tensor:
    """Softmax attention of q (B,S,H,dh) over k/v (B,S,KV,dh), KV | H, in
    fp32 scores; q-blocked when S > block_q."""
    S = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    kf, vf = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    kv_pos = positions
    if S <= block_q:
        bias = _mask_bias(positions, kv_pos, causal=causal, window=window)
        return sdpa(q, kf, vf, bias[None, None],
                    softcap_val=att.logit_softcap,
                    scale=att.softmax_scale)
    assert S % block_q == 0, (S, block_q)
    blocks = []
    for i in range(S // block_q):
        sl = slice(i * block_q, (i + 1) * block_q)
        bias = _mask_bias(positions[sl], kv_pos, causal=causal,
                          window=window)
        blocks.append(sdpa(q[:, sl], kf, vf, bias[None, None],
                           softcap_val=att.logit_softcap,
                           scale=att.softmax_scale))
    return torch.cat(blocks, dim=1)


def attention_forward_flash(p: dict, att: AttentionConfig, x: torch.Tensor,
                            positions: torch.Tensor, *,
                            window: Optional[int], causal: bool,
                            return_kv: bool = False):
    """attention_forward, but the inner softmax-attention runs in the
    flash kernel (CUDA tensors; its plain version on CPU tensors)."""
    from repro_torch.kernels.flash_attention import flash_attention
    B, S, d = x.shape
    q, k, v = _qkv(p, att, x, positions)
    out = flash_attention(q, k, v, causal, window, att.logit_softcap,
                          att.softmax_scale)
    out = out.reshape(B, S, att.n_heads * att.d_head) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


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

    # Position of every cache slot, reconstructed from the ring layout:
    # the most recent position p <= index with p % Sc == slot.
    slots = torch.arange(Sc, dtype=torch.int64, device=x.device)
    slot_pos = index - torch.remainder(index - slots, Sc)
    valid = slot_pos >= 0
    if window is not None:
        valid &= (index - slot_pos) < window

    # Grouped layout: q reshaped (B, KV, G, dh), K/V never repeated to H
    # heads. Products accumulate in fp32 from the cache's own values, as
    # the reference's preferred_element_type=fp32 einsums do.
    G = att.n_heads // att.n_kv_heads
    qg = q.reshape(B, att.n_kv_heads, G, att.d_head)
    scale = softmax_scale(att)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(k.dtype).float(),
                     k.float()) * scale
    if att.logit_softcap is not None:
        s = torch.tanh(s / att.logit_softcap) * att.logit_softcap
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    s = s + torch.where(valid, zero, NEG_INF)[None, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    out = out.reshape(B, 1, att.n_heads * att.d_head) @ p["wo"]
    return out, KVCache(k=k, v=v, index=index + 1)


def init_cache(att: AttentionConfig, batch: int, max_seq: int,
               window: Optional[int], dtype, *, device) -> KVCache:
    Sc = min(max_seq, window) if window is not None else max_seq
    shape = (batch, Sc, att.n_kv_heads, att.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   index=torch.zeros((), dtype=torch.int64, device=device))


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
    from repro_torch.parallel import sharding as sh
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
    G = att.n_heads // att.n_kv_heads
    scale = softmax_scale(att)

    def body(h, kc, vc, *wl):
        pl = dict(zip(keys, wl))
        B = h.shape[0]
        pos = torch.full((1,), index, dtype=torch.int32, device=h.device)
        q, k_new, v_new = _qkv(pl, att, h, pos)
        slot = index % Sc
        if off <= slot < off + Sl:
            kc[:, slot - off] = k_new[:, 0].to(kc.dtype)
            vc[:, slot - off] = v_new[:, 0].to(vc.dtype)
        slots = off + torch.arange(Sl, dtype=torch.int64, device=h.device)
        slot_pos = index - torch.remainder(index - slots, Sc)
        valid = slot_pos >= 0
        if window is not None:
            valid &= (index - slot_pos) < window
        qg = q.reshape(B, att.n_kv_heads, G, att.d_head)
        s = torch.einsum("bkgd,bskd->bkgs", qg.to(kc.dtype).float(),
                         kc.float()) * scale
        if att.logit_softcap is not None:
            s = torch.tanh(s / att.logit_softcap) * att.logit_softcap
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        s = s + torch.where(valid, zero, NEG_INF)[None, None, None, :]
        mx = s.amax(dim=-1, keepdim=True)
        for g in groups:
            mx = sh.all_reduce_max(mx, g)
        e = torch.exp(s - mx)
        tot = e.sum(dim=-1, keepdim=True)
        for g in groups:
            tot = sh.all_reduce_sum(tot, g)
        out = torch.einsum("bkgs,bskd->bkgd", (e / tot).to(vc.dtype).float(),
                           vc.float())
        for g in groups:
            out = sh.all_reduce_sum(out, g)
        out = out.to(vc.dtype).reshape(B, 1, att.n_heads * att.d_head)
        return out @ pl["wo"]

    y = sh.shard_map(ctx, body, (x, cache.k, cache.v, *w), (x.placements,),
                     split=sh.batch_split(ctx, x) + seq_axes)
    return y, KVCache(k=cache.k, v=cache.v, index=index + 1)
