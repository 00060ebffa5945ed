"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch,
on one device.

Dispatch is the reference's sort formulation (no O(T*E*C) one-hot
dispatch tensor): flatten the (token, expert) assignments, sort them by
expert (stably, so that ties keep flat order), place each in its
expert's slot of an (E, C, d) buffer from the exclusive cumsum of the
per-expert counts, run three batched expert GEMMs, and combine each
token's k outputs with its gate weights. Assignments beyond capacity
C = ceil4(T*k*cf/E) (at least 4, at most T) go to an overflow row and
are dropped; decode is dropless (C = T).

Over a mesh (``ctx``) the block runs per shard, as the reference's
``shard_map`` body does: ``tp`` keeps every expert on every rank and
splits ``d_ff`` over ``model``; ``ep`` splits the experts over
``model``, each rank taking the assignments of its own experts and
parking the rest. Both sum the token outputs over ``model``. With fsdp
the expert weights are gathered over the batch axes on entry (the
parameter-server pull; the gather's backward reduce-scatters the
gradients, the push). Capacity is counted from each shard's own
tokens, so a mesh drops what each data shard would drop alone.

The combine gathers each token's k outputs in flat (token, slot) order
and sums them, where the reference scatter-adds them in sorted order:
the same sum, in an order that does not depend on a device's atomics,
so a prefill on the card gives the same bits every run.

A config with ``d_ff_shared`` adds one shared SwiGLU expert that every
token runs (Granite-4.0-H), summed onto the routed experts' output; over
a mesh its ``d_ff`` is split over ``model`` under either expert
sharding, so its partial sums join the routed ones'. While a profiler
records, :data:`DROPS` counts the assignments past capacity.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import _mm, activation, apply_ffn, \
    dense_init, profiling, truncated_normal
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import LP, NO_MESH, ParallelCtx


def init_moe(cfg: ModelConfig, moe: MoEConfig, dtype, *, device,
             generator: torch.Generator) -> dict:
    """The reference draws each expert tensor as one ``(E*d, f)`` dense
    init (scale 1/sqrt(E*d)) reshaped to ``(E, d, f)``; here expert by
    expert at that scale, so that at full width no fp32 copy of a whole
    tensor is held. The router stays fp32."""
    d, f, E = cfg.d_model, moe.d_ff_expert, moe.num_experts
    kw = dict(device=device, generator=generator)

    def experts(d_in, d_out, fan_in):
        w = torch.empty((E, d_in, d_out), dtype=dtype, device=device)
        for e in range(E):
            w[e] = truncated_normal((d_in, d_out), 1.0 / math.sqrt(fan_in),
                                    dtype, **kw)
        return w

    p = {"router": dense_init(d, E, torch.float32, **kw),
         "w_up": experts(d, f, E * d),
         "w_down": experts(f, d, E * f)}
    if cfg.ffn_activation in ("swiglu", "geglu"):
        p["w_gate"] = experts(d, f, E * d)
    if moe.d_ff_shared is not None:
        fs = moe.d_ff_shared
        p["shared_gate"] = dense_init(d, fs, dtype, **kw)
        p["shared_up"] = dense_init(d, fs, dtype, **kw)
        p["shared_down"] = dense_init(fs, d, dtype, **kw)
    return p


def moe_param_logical_axes(ctx_es: str, shared: bool = False) -> dict:
    """``shared``: the layer has a shared expert, whose ``d_ff`` splits
    over ``model`` under either expert sharding."""
    e = "expert" if ctx_es == "ep" else None
    ff = None if ctx_es == "ep" else "d_ff"
    axes = {"router": LP(None, None),
            "w_up": LP(e, "fsdp", ff),
            "w_gate": LP(e, "fsdp", ff),
            "w_down": LP(e, ff, "fsdp")}
    if shared:
        axes.update(shared_gate=LP("fsdp", "d_ff"),
                    shared_up=LP("fsdp", "d_ff"),
                    shared_down=LP("d_ff", "fsdp"))
    return axes


class DropCount:
    """The prompt assignments routed past their expert's capacity,
    counted while a profiler records (a traced run's sub-window) and
    never otherwise: ``dropped`` adds up on the device and ``routed``
    on the host, so counting never waits for the device, and ``read``
    copies the count to the host, once, after the run. One for the
    process, as the profiler whose window it follows is."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.dropped: Optional[torch.Tensor] = None
        self.routed = 0

    def add(self, keep: torch.Tensor) -> None:
        """``keep``: the (assignments,) kept mask of one dispatch."""
        n = (~keep).sum()
        self.dropped = n if self.dropped is None else self.dropped.add_(n)
        self.routed += keep.numel()

    def read(self) -> Tuple[int, int]:
        """(dropped, routed) so far."""
        return (0 if self.dropped is None else int(self.dropped),
                self.routed)


#: the process's count of prefill assignments past capacity
DROPS = DropCount()


def _capacity(moe: MoEConfig, n_tokens: int, dropless: bool) -> int:
    if dropless:
        return n_tokens  # max per-expert load is n_tokens (top-k distinct)
    c = int(n_tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    c = max(4, -(-c // 4) * 4)     # >=4, multiple of 4
    return min(c, n_tokens)


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int,
                      capacity: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """expert_idx: (A,) flat assignments. Returns (sort order, destination
    row in the (E*C) buffer for each sorted assignment, keep mask). An
    expert's first assignment sits at the count of assignments to lower
    experts (the exclusive cumsum of the counts), found by a search of
    the sorted ids: no atomics, no wait for the host."""
    order = torch.argsort(expert_idx, stable=True)
    sorted_e = expert_idx[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=expert_idx.device,
                               dtype=sorted_e.dtype))
    pos_in_e = torch.arange(expert_idx.shape[0],
                            device=expert_idx.device) - start[sorted_e]
    keep = pos_in_e < capacity
    dest = torch.where(keep, sorted_e * capacity + pos_in_e,
                       n_experts * capacity)             # overflow row
    return order, dest, keep


def _expert_ffn(cfg: ModelConfig, p: dict, buf: torch.Tensor
                ) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d) through the per-expert FFN."""
    glu = cfg.ffn_activation in ("swiglu", "geglu")
    act = "silu" if cfg.ffn_activation == "swiglu" else (
        "gelu" if cfg.ffn_activation == "geglu" else cfg.ffn_activation)
    up = torch.bmm(buf, p["w_up"])
    if glu:
        inner = activation(act, torch.bmm(buf, p["w_gate"])) * up
    else:
        inner = activation(act, up)
    return torch.bmm(inner, p["w_down"])


def _moe_local(cfg: ModelConfig, moe: MoEConfig, p: dict, x: torch.Tensor,
               *, dropless: bool = False, n_local_experts: int = 0,
               expert_offset: int = 0, es: str = "tp"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over tokens x: (T, d). Returns (out (T, d), aux_loss). With
    ``es="ep"`` the weights hold experts ``expert_offset ..
    expert_offset + n_local_experts - 1`` only: the other assignments
    are parked (dropped here, taken by the rank that holds them)."""
    T, d = x.shape
    E, k = moe.num_experts, moe.top_k
    C = _capacity(moe, T, dropless)

    # fp32 @ the router (bf16 under compute casting) is fp32, as in JAX
    logits = _mm(x.float(), p["router"])                 # (T, E)
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(gates, k, dim=-1)          # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)

    flat_e = top_i.reshape(-1)                           # (T*k,)
    flat_t = torch.arange(T * k, device=x.device) // k
    if es == "ep":
        rel = flat_e - expert_offset
        in_range = (rel >= 0) & (rel < n_local_experts)
        eff_e = torch.where(in_range, rel, n_local_experts)   # park
        order, dest_sorted, keep_sorted = _dispatch_indices(
            eff_e, n_local_experts + 1, C)
        keep_sorted &= eff_e[order] < n_local_experts
        dest_sorted = torch.where(keep_sorted, dest_sorted,
                                  n_local_experts * C)
        n_e = n_local_experts
    else:
        order, dest_sorted, keep_sorted = _dispatch_indices(flat_e, E, C)
        n_e = E
    # each assignment's buffer row, in flat (token, slot) order
    dest = torch.empty_like(dest_sorted).index_copy_(0, order, dest_sorted)
    keep = torch.empty_like(keep_sorted).index_copy_(0, order, keep_sorted)

    if not dropless and es != "ep" and profiling():
        DROPS.add(keep)

    # kept rows are distinct; the overflow row only ever receives zeros
    rows = torch.where(keep[:, None], x[flat_t], 0)
    buf = x.new_zeros((n_e * C + 1, d)).index_put((dest,), rows)
    out_buf = _expert_ffn(cfg, p, buf[:n_e * C].reshape(n_e, C, d))
    out_buf = torch.cat([out_buf.reshape(n_e * C, d),
                         out_buf.new_zeros((1, d))])
    w = (top_w.reshape(-1) * keep).to(out_buf.dtype)
    y = (out_buf[dest] * w[:, None]).to(x.dtype).reshape(T, k, d)
    y = torch.sum(y, dim=1)
    if moe.d_ff_shared is not None:
        y = y + apply_ffn(cfg, {"w_gate": p["shared_gate"],
                                "w_up": p["shared_up"],
                                "w_down": p["shared_down"]}, x)

    # Switch-style load-balance aux loss, over every assignment (dropped
    # ones too)
    frac = torch.zeros((E,), dtype=torch.float32, device=x.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    frac = frac / (T * k)
    importance = torch.mean(gates, dim=0)
    aux = E * torch.sum(frac * importance) * moe.aux_loss_weight
    return y, aux


def apply_moe(cfg: ModelConfig, moe: MoEConfig, p: dict, x: torch.Tensor,
              *, dropless: bool = False, ctx: ParallelCtx = NO_MESH
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux scalar). Under a mesh x and
    ``p`` are DTensors; out comes back on x's layout and aux as the
    plain mean over the shards (the same on every rank)."""
    B, S, d = x.shape
    if ctx.mesh is None:
        out, aux = _moe_local(cfg, moe, p, x.reshape(B * S, d),
                              dropless=dropless)
        return out.reshape(B, S, d), aux

    es, mx = ctx.expert_sharding, ctx.model_axis
    la = moe_param_logical_axes(es, moe.d_ff_shared is not None)
    keys = sorted(p)
    # the PS pull: fsdp shards gathered over the batch axes
    w = [ctx.constrain(p[k], *(None if a == "fsdp" else a for a in la[k]))
         for k in keys]
    # a batch the batch shards do not divide (single-stream decode) runs
    # replicated
    x_pl = x.placements
    if B % ctx.n_batch_shards:
        x = ctx.constrain(x, None, None, None)
    split = sh.batch_split(ctx, x) + (mx,)
    n_shards = 1
    for a in split:
        n_shards *= ctx.size(a)
    if es == "ep":
        n_local = moe.num_experts // ctx.n_model_shards
        off = ctx.coordinate(mx) * n_local
    else:
        n_local, off = moe.num_experts, 0

    def body(xl, *wl):
        Bl = xl.shape[0]
        y, aux = _moe_local(cfg, moe, dict(zip(keys, wl)),
                            xl.reshape(Bl * S, d), dropless=dropless,
                            n_local_experts=n_local, expert_offset=off,
                            es=es)
        # the mean over the shards that split the work (the pmean)
        return y.reshape(Bl, S, d), aux / n_shards

    rep = [sh.Replicate()] * ctx.mesh.ndim
    y, aux = sh.shard_map(
        ctx, body, (x, *w),
        (sh.summed_over(ctx, x.placements, (mx,)),
         sh.summed_over(ctx, rep, split)), split=split)
    y = y.redistribute(ctx.mesh, x_pl)
    return y, aux.redistribute(ctx.mesh, rep).to_local()
