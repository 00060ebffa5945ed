"""Roofline analysis of a step against one NVIDIA H100 80GB HBM3 (SXM5,
700 W).

Terms (seconds), all per device:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = wire bytes on the intra-pod axes / NVLINK_BW
                 + wire bytes on the pod axis / POD_BW

The counts come from running the step, eagerly, under ``Counter`` (a
``TorchDispatchMode``), on real tensors or on fake ones (shapes only,
``launch/dryrun.py``):

- FLOPs: ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (matmuls, convolutions, attention);
- bytes: each aten op's tensor inputs plus its outputs (views and
  metadata queries move none; a gather, the rows it returns twice and
  its indices, not the whole table). That is eager mode's unfused traffic: every elementwise op reads
  and writes memory. XLA's "bytes accessed" counts a fused program, so
  the reference's memory term is the smaller for the same step;
- collectives: each c10d op with its group's size and its result bytes,
  summed into ``hlo.CollectiveStats`` with that module's ring factors
  (``_wire_factor``); a group that is the mesh's ``pod`` dim rides the
  pod network.

Per device: an op on plain tensors (the per-shard bodies of
``parallel.sharding.shard_map``) is one rank's own. An op DTensor
dispatches reaches a dispatch mode at its global shape (its local op does
not reach the mode at all), so its FLOPs are divided by the ranks that
split its output (its ``Shard`` and ``Partial`` mesh dims; the ranks of a
``Replicate`` dim each do the whole) and its bytes are its local shards'.

The kernels are invisible: K3 and K4 launch through ``ctypes``, which no
dispatch mode sees. Counting runs the plain paths (``use_flash_kernel``
and ``use_rwkv_kernel`` off), as the reference counts its unrolled
q-block attention (``FORCE_UNROLL_Q``) and not its Pallas call.

Segments: the reference lowers one segment per layer signature because
XLA's cost analysis counts a ``lax.scan`` body once. Python's loop over
layers runs every layer, so nothing is undercounted here, and
``extrapolate_two_point``, ``_period_slice_specs``, ``_cast_pin`` and
``_position_signature``'s role in the scan have no counterpart. The
segments stay because they save time: each distinct layer (kind, MoE,
window) runs once and is multiplied by its count, which is one period
for a 72-layer model instead of 72 layers.

Constants: the H100 SXM5 data sheet: 989e12 bf16 dense FLOP/s, 3.35e12
B/s of HBM3; NVLink 450e9 B/s per direction between the cards of a pod
(the data and model axes); 50e9 B/s per card (400 Gb/s) across pods.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as ckpt
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import hlo as hlo_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import ParallelCtx

PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per direction, intra-pod axes
POD_BW = 50e9                # bytes/s per card across pods (400 Gb/s)

#: gathers: they read the rows they return, not the whole table
_GATHERS = {"index", "index_select", "embedding", "gather"}

#: c10d ops (functional and in-place) and the HLO collective they are
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _nbytes(t) -> int:
    if isinstance(t, sh.DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    """The tensors of an op's arguments or results (nested lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


class Counter(TorchDispatchMode):
    """FLOPs, bytes and collectives of the ops run under it, per device
    (see the module's docstring). ``pod_groups``: the names of the
    process groups whose traffic rides the pod network."""

    def __init__(self, pod_groups=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = hlo_lib.CollectiveStats()
        self.pod_wire_bytes = 0.0
        self.pod_groups = set(pod_groups)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], func, args, kwargs, out)
            return out
        outs = _tensors(out)
        # views, waits and metadata queries (``prim.device`` under fake
        # tensors) move no bytes
        if not outs or name == "wait_tensor" or func.namespace == "prim" \
                or getattr(func, "is_view", False):
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = [o for o in outs if isinstance(o, sh.DTensor)]
            if dt:
                for i, p in enumerate(dt[0].placements):
                    if p.is_shard() or p.is_partial():
                        f /= dt[0].device_mesh.size(i)
            self.flops += f
        moved = sum(_nbytes(t) for t in outs)
        if name in _GATHERS:
            # the rows read equal the rows written; plus the indices
            self.bytes += 2 * moved + sum(
                _nbytes(t) for t in _tensors((args, kwargs))
                if not t.is_floating_point())
        else:
            self.bytes += sum(_nbytes(t) for t in
                              _tensors((args, kwargs))) + moved
        return out

    def _collective(self, kind, func, args, kwargs, out):
        group, size = None, None
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        if "process_group" in named:      # an in-place c10d op's group
            pg = torch._C._distributed_c10d.ProcessGroup.unbox(
                named["process_group"])
            group, size = pg.group_name, pg.size()
        elif "group_name" in named:
            group = named["group_name"]
            size = named.get("group_size")
        if size is None and group is not None:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            size = _resolve_process_group(group).size()
        # the result: a functional op's output, an in-place op's first
        # tensor argument (its output buffer)
        res = _tensors(out) if func._schema.name.startswith(
            "_c10d_functional") else _tensors(args)[:1]
        rb = sum(_nbytes(t) for t in res)
        n = size or 1
        wire = rb * hlo_lib._wire_factor(kind, n) if n > 1 else 0.0
        st = self.collectives
        st.counts[kind] += 1
        st.result_bytes[kind] += rb
        st.wire_bytes[kind] += wire
        st.ops.append((kind, rb, n))
        if group in self.pod_groups:
            self.pod_wire_bytes += wire


@dataclass
class SegmentCost:
    """One segment's counts (``compile_s``: the seconds its counting run
    took, under the reference's name)."""
    name: str
    flops: float
    bytes_accessed: float
    collectives: hlo_lib.CollectiveStats
    compile_s: float
    pod_wire_bytes: float = 0.0

    def scaled(self, k: float) -> "SegmentCost":
        return SegmentCost(self.name, self.flops * k,
                           self.bytes_accessed * k,
                           self.collectives.scaled(k), self.compile_s,
                           self.pod_wire_bytes * k)


def pod_groups(ctx: ParallelCtx) -> Tuple[str, ...]:
    """The process group of the mesh's ``pod`` dim, where it has one."""
    if ctx.mesh is None or "pod" not in ctx.mesh.mesh_dim_names:
        return ()
    return (ctx.group("pod").group_name,)


def count(ctx: ParallelCtx, name: str, fn, *args) -> Tuple[Any, SegmentCost]:
    """Run ``fn(*args)`` under a ``Counter``: (its result, its cost)."""
    c = Counter(pod_groups(ctx))
    t0 = time.time()
    with c:
        out = fn(*args)
    return out, SegmentCost(name, c.flops, c.bytes, c.collectives,
                            time.time() - t0, c.pod_wire_bytes)


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

def _position_signature(cfg, pos: int) -> Tuple:
    return (cfg.layer_pattern[pos], bool(cfg.moe_at(pos)),
            cfg.window_at(pos))


def _place_tree(ctx: ParallelCtx, tree, axes):
    if ctx.mesh is None:
        return tree
    return M._zip_logical(
        lambda a, lp: sh.place(a, ctx.mesh, ctx.placements(*lp)), tree, axes)


def _cast(ctx: ParallelCtx, tree, axes, dtype):
    """``models.model.cast_params_for_compute`` on a part of the tree."""
    return M._zip_logical(lambda a, lp: ctx.constrain(
        a.to(dtype) if a.dtype == torch.float32 else a, *lp), tree, axes)


def _leaves_requiring_grad(tree):
    leaves = [t.detach().requires_grad_() for t in O.tree_leaves(tree)]
    it = iter(leaves)
    return O.tree_map(lambda _: next(it), tree), leaves


def _scalar(t):
    """A 0-d result as a plain tensor, the same on every rank."""
    if isinstance(t, sh.DTensor):
        return t.redistribute(t.device_mesh,
                              [sh.Replicate()] * t.device_mesh.ndim
                              ).to_local()
    return t


def segment_costs(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec, *,
                  device="cpu") -> Dict[str, SegmentCost]:
    """Per-layer segments (one per signature, scaled by its count), the
    embedding and head (with the loss in training) and, in training, the
    optimizer: a train segment runs forward and backward (under remat
    as ``models.model.forward`` runs it), prefill and decode forward
    only. Runs on whatever tensors ``device`` makes: real ones, or fake
    ones under an active ``FakeTensorMode``."""
    cfg = acfg.model
    B, S = shape.global_batch, shape.seq_len
    S_in = 1 if shape.kind == "decode" else S
    cdt = M.dtype_of(acfg.train.compute_dtype)
    pdt = M.dtype_of(acfg.train.param_dtype)
    mode = shape.kind
    segs: Dict[str, SegmentCost] = {}

    def x_in():
        x = torch.zeros((B, S_in, cfg.d_model), dtype=cdt, device=device)
        return M._constrain_act(ctx, x) if ctx.mesh is not None else x

    states = (M.init_states(acfg, B, S, device=device, ctx=ctx)
              if mode == "decode" else None)
    positions = torch.arange(S_in, dtype=torch.int32, device=device)
    sigs: Dict[Tuple, list] = {}
    for li in range(cfg.num_layers):
        sigs.setdefault(_position_signature(cfg, li % cfg.pattern_period),
                        []).append(li)
    layer = M._apply_layer
    if mode == "train" and acfg.train.remat:
        layer = functools.partial(ckpt.checkpoint, M._apply_layer,
                                  use_reentrant=False,
                                  **M._remat_policy(acfg.train.remat_policy))
    for sig, lis in sigs.items():
        li = lis[0]
        name = f"pos{li % cfg.pattern_period}:{sig[0]}" \
            f"{'+moe' if sig[1] else ''}"
        p = _place_tree(ctx, specs_lib.materialize(M._init_layer(
            cfg, li, pdt, device=specs_lib.META, generator=None), device),
                        M._layer_axes(acfg, li))
        x = x_in()
        st = states[li] if states is not None else None

        def run(p, x, st, li=li):
            axes = M._layer_axes(acfg, li)
            if mode != "train":
                with torch.no_grad():
                    return layer(cfg, li, _cast(ctx, p, axes, cdt), x, st,
                                 mode,
                                 None if mode == "decode" else positions,
                                 S, False, False, ctx)
            p, leaves = _leaves_requiring_grad(p)
            x = x.detach().requires_grad_()
            y, _, aux = layer(cfg, li, _cast(ctx, p, axes, cdt), x, None,
                              mode, positions, S, False, False, ctx)
            loss = _scalar((y.float() * y.detach().float()).sum()) + aux
            return torch.autograd.grad(loss, leaves + [x], allow_unused=True)
        _, seg = count(ctx, name, run, p, x, st)
        segs[name] = seg.scaled(len(lis))
    segs["embed_head"] = _embed_head_cost(ctx, acfg, shape, device, cdt, pdt)
    if mode == "train":
        segs["optimizer"] = _optimizer_cost(ctx, acfg, device)
    return segs


def _embed_head_cost(ctx, acfg, shape, device, cdt, pdt) -> SegmentCost:
    cfg = acfg.model
    B = shape.global_batch
    S_in = 1 if shape.kind == "decode" else shape.seq_len
    hp = specs_lib.materialize(M.init_params(
        acfg.replace(model=dataclasses.replace(cfg, num_layers=0)),
        device=specs_lib.META, generator=None, dtype=pdt), device)
    del hp["layers"]
    axes = M.param_logical_axes(acfg)
    axes = {k: axes[k] for k in hp}
    hp = _place_tree(ctx, hp, axes)
    x = torch.zeros((B, S_in, cfg.d_model), dtype=cdt, device=device)
    if ctx.mesh is not None:
        x = M._constrain_act(ctx, x)
    tokens = torch.zeros((B, S_in), dtype=torch.int32, device=device)

    if shape.kind == "train":
        def run(hp, x):
            hp, leaves = _leaves_requiring_grad(hp)
            x = x.detach().requires_grad_()
            h2 = _cast(ctx, hp, axes, cdt)
            e = x
            if cfg.frontend is None:
                e = x + M._embed_in(ctx, cfg, h2, tokens, None, cdt)
            hid = M._norm(ctx, cfg, h2["final_norm"], e)
            loss = M.loss_fn(acfg, h2, hid, tokens, ctx=ctx)
            # a model fed frontend embeds reads no token embedding
            return torch.autograd.grad(loss, leaves + [x], allow_unused=True)
    else:
        @torch.no_grad()
        def run(hp, x):
            h2 = _cast(ctx, hp, axes, cdt)
            hid = M._norm(ctx, cfg, h2["final_norm"], x)
            last = hid if shape.kind == "decode" else hid[:, -1:]
            return M.logits_fn(acfg, h2, last, ctx=ctx)
    return count(ctx, "embed_head", run, hp, x)[1]


def _optimizer_cost(ctx, acfg, device) -> SegmentCost:
    params = M.distribute_params(
        ctx, acfg, specs_lib.materialize(specs_lib.param_specs(acfg), device))
    grads = O.tree_map(lambda t: t.detach().clone(), params)
    opt = O.init_opt_state(acfg.train, params,
                           period=acfg.model.pattern_period)
    return count(ctx, "optimizer", lambda p, g, o: O.apply_updates(
        acfg.train, p, g, o), params, grads, opt)[1]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    """The reference's record; ``ici_wire_bytes`` are the intra-pod
    (NVLink) bytes and ``dcn_wire_bytes`` the pod axis's, under the
    reference's names."""
    arch: str
    shape: str
    mesh: str
    n_chips: int
    flops_per_device: float
    bytes_per_device: float
    ici_wire_bytes: float
    dcn_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_total_flops: float     # global: per-device x cards
    segments: Dict[str, Any] = field(default_factory=dict)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 means compute-bound at
        peak; lower means the dominant non-compute term idles the tensor
        cores."""
        m = max(self.compute_s, self.memory_s, self.collective_s, 1e-30)
        return self.compute_s / m

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_total_flops, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "ici_wire_bytes": self.ici_wire_bytes,
            "dcn_wire_bytes": self.dcn_wire_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
            "model_flops": self.model_flops,
            "hlo_total_flops": self.hlo_total_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "segments": {k: {
                "flops": v.flops, "bytes": v.bytes_accessed,
                "collectives": v.collectives.summary(),
                "compile_s": v.compile_s} for k, v in
                self.segments.items()},
        }


def model_flops(acfg: ArchConfig, shape: ShapeSpec) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.
    Decode: one token per sequence per step."""
    n = acfg.model.num_active_params()
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def build_roofline(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec,
                   mesh_name: str,
                   segs: Dict[str, SegmentCost]) -> Roofline:
    total_flops = total_bytes = pod_bytes = 0.0
    coll = hlo_lib.CollectiveStats()
    for seg in segs.values():
        total_flops += seg.flops
        total_bytes += seg.bytes_accessed
        pod_bytes += seg.pod_wire_bytes
        coll = coll.merged(seg.collectives)
    n_chips = 1 if ctx.mesh is None else ctx.mesh.size()
    ici_bytes = coll.total_wire_bytes - pod_bytes
    return Roofline(
        arch=acfg.model.name, shape=shape.name, mesh=mesh_name,
        n_chips=n_chips,
        flops_per_device=total_flops,
        bytes_per_device=total_bytes,
        ici_wire_bytes=ici_bytes,
        dcn_wire_bytes=pod_bytes,
        compute_s=total_flops / PEAK_FLOPS,
        memory_s=total_bytes / HBM_BW,
        collective_s=ici_bytes / NVLINK_BW + pod_bytes / POD_BW,
        model_flops=model_flops(acfg, shape),
        hlo_total_flops=total_flops * n_chips,
        segments=segs)
