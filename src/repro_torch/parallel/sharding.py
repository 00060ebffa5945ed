"""Logical-axis sharding: one place that decides how every tensor maps
onto the physical mesh, as a small context object passed through the
model (the reference's rules, on ``torch.distributed``).

Physical axes: ("pod",) "data", "model". Logical axes used by the model:

  batch      -> (pod, data)          activations' batch dim
  seq        -> None | data          long-context activation / KV seq dim
  heads      -> model                q-head dim
  kv_heads   -> model | None         KV cache head dim
  d_ff       -> model                FFN hidden (tensor parallel)
  vocab      -> model                embedding / logits vocab dim
  expert     -> model (ep) | None    MoE expert dim
  fsdp       -> (pod, data) if fsdp  weight shard dim (ZeRO-3 / "PS shard")
  layers     -> None                 stacked-scan leading dim

The counterparts of the reference's JAX objects: a ``DeviceMesh`` with
named dims for the ``Mesh``; a tuple of physical axis names (``spec``)
for the ``PartitionSpec``; DTensor placements (``placements``: one
``Shard(dim)`` or ``Replicate()`` per mesh dim) for the
``NamedSharding``; ``redistribute`` (``constrain``) for
``with_sharding_constraint``; and ``shard_map`` below, ``to_local`` /
``from_local`` with the gradient placements stated, for the reference's
``shard_map``. With ``NO_MESH`` every ``constrain`` is the identity and
every tensor stays a plain tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig


class LP(tuple):
    """A tuple of *logical* axis names, one per tensor dim (the
    reference's ``PartitionSpec`` of logical names): a leaf of the
    logical trees, where a plain tuple is a container."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


@dataclass(frozen=True)
class ParallelCtx:
    mesh: Any                        # DeviceMesh with named dims, or None
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp: bool = False
    ps_mode: bool = False
    expert_sharding: str = "tp"      # 'tp' | 'ep'
    seq_shard_prefill: bool = True
    seq_shard_kv_decode: bool = True
    shard_kv_heads: bool = True      # shard KV cache heads over model axis

    # ------------------------------------------------------------------
    def axis(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == "batch":
            return self.batch_axes if len(self.batch_axes) > 1 \
                else self.batch_axes[0]
        if logical in ("heads", "d_ff", "vocab"):
            return self.model_axis
        if logical == "kv_heads":
            return self.model_axis if self.shard_kv_heads else None
        if logical == "expert":
            return self.model_axis if self.expert_sharding == "ep" else None
        if logical == "fsdp":
            return (self.batch_axes if len(self.batch_axes) > 1
                    else self.batch_axes[0]) if self.fsdp else None
        if logical == "seq":
            return "data"
        if logical == "kv_seq":
            # decode KV caches: sequence over the model axis
            # (flash-decoding split; KV heads stay replicated)
            return self.model_axis
        if logical == "kv_seq_all":
            # single-stream long-context decode: sequence over the whole
            # mesh
            return tuple(self.batch_axes) + (self.model_axis,)
        if logical == "layers":
            return None
        raise KeyError(logical)

    def spec(self, *logical: Optional[str]) -> tuple:
        """The physical axes of each tensor dim (the reference's
        ``PartitionSpec`` as a tuple)."""
        return tuple(self.axis(a) for a in logical)

    def placements(self, *logical: Optional[str]) -> tuple:
        """DTensor placements on the mesh, one per mesh dim: ``Shard(i)``
        where tensor dim ``i`` is laid out over that mesh dim, else
        ``Replicate()``. A dim over several mesh dims (``("pod",
        "data")``) is split pod-major, as JAX splits it."""
        return placements_of(self.mesh, self.spec(*logical))

    def constrain(self, x, *logical: Optional[str]):
        """``redistribute`` to the logical layout when a mesh is active,
        else the identity. A plain tensor under a mesh is taken as the
        global value, the same on every rank."""
        if self.mesh is None:
            return x
        pl = self.placements(*logical)
        if isinstance(x, DTensor):
            return x if tuple(x.placements) == pl else \
                x.redistribute(self.mesh, pl)
        return place(x, self.mesh, pl)

    def size(self, axis: str) -> int:
        return mesh_size(self.mesh, axis)

    @property
    def n_batch_shards(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.batch_axes:
            n *= self.size(a)
        return n

    @property
    def n_model_shards(self) -> int:
        if self.mesh is None:
            return 1
        return self.size(self.model_axis)

    def coordinate(self, axis: str) -> int:
        """This rank's index along mesh dim ``axis``."""
        return self.mesh.get_coordinate()[
            self.mesh.mesh_dim_names.index(axis)]

    def group(self, axis: str):
        """The process group of mesh dim ``axis`` through this rank."""
        return self.mesh.get_group(axis)


def mesh_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def placements_of(mesh, spec: Sequence) -> tuple:
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, ax in enumerate(spec):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            out[mesh.mesh_dim_names.index(a)] = Shard(dim)
    return tuple(out)


def make_ctx(cfg: ArchConfig, mesh) -> ParallelCtx:
    batch_axes: Tuple[str, ...] = ("data",)
    if mesh is not None and "pod" in mesh.mesh_dim_names:
        batch_axes = ("pod", "data")
    es = cfg.parallel.expert_sharding or (
        cfg.model.moe.expert_sharding if cfg.model.moe else "tp")
    # EP requires the expert count to divide evenly over the model axis.
    if mesh is not None and es == "ep" and cfg.model.moe is not None:
        if cfg.model.moe.num_experts % mesh_size(mesh, "model") != 0:
            es = "tp"
    return ParallelCtx(
        mesh=mesh,
        batch_axes=batch_axes,
        fsdp=cfg.parallel.fsdp,
        ps_mode=cfg.parallel.ps_mode,
        expert_sharding=es,
        seq_shard_prefill=cfg.parallel.seq_shard_prefill,
        seq_shard_kv_decode=cfg.parallel.seq_shard_kv_decode,
    )


NO_MESH = ParallelCtx(mesh=None)


def map_logical(fn: Callable, tree):
    """``fn`` over the ``LP`` leaves of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, LP):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_logical(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_logical(fn, v) for v in tree)
    return tree


def logical_to_physical(ctx: ParallelCtx, logical_tree):
    """Map a tree of ``LP``-of-*logical*-names to physical specs."""
    return map_logical(lambda lp: ctx.spec(*lp), logical_tree)


def tree_shardings(ctx: ParallelCtx, logical_tree):
    """DTensor placements for a logical tree (requires a mesh)."""
    if ctx.mesh is None:
        raise ValueError("tree_shardings needs a mesh; NO_MESH has none")
    return map_logical(lambda lp: ctx.placements(*lp), logical_tree)


# ---------------------------------------------------------------------------
# Placing tensors, and running code per shard
# ---------------------------------------------------------------------------

def place(x: torch.Tensor, mesh, placements) -> DTensor:
    """The global tensor ``x`` (the same on every rank) as a DTensor on
    ``placements``: each rank keeps its own chunk, nothing is sent."""
    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, tuple(placements))


def to_placements(x: torch.Tensor, mesh, placements) -> DTensor:
    """``x`` on ``placements``: a DTensor redistributed where its layout
    differs, a plain tensor (the global value) placed."""
    placements = tuple(placements)
    if not isinstance(x, DTensor):
        return place(x, mesh, placements)
    return x if tuple(x.placements) == placements else \
        x.redistribute(mesh, placements)


def full(x):
    """The whole value of a DTensor on every rank (a plain tensor as it
    is)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard_map(ctx: ParallelCtx, fn: Callable, args: Sequence,
              out_placements: Sequence, *, split: Sequence[str] = ()):
    """The reference's ``shard_map``: ``fn`` on the local shards of the
    DTensors in ``args`` (other arguments pass as they are), its outputs
    wrapped as DTensors on ``out_placements`` (one tuple per output;
    None leaves an output a plain tensor).

    ``split`` names the mesh dims over which ``fn``'s work is divided
    (each rank computes its own part of the result): there an input
    that is replicated takes a ``Partial`` gradient, since each rank's
    gradient covers only its part; over any other mesh dim every rank
    does the same work and the gradient stays replicated. An output
    that ranks sum over a split dim (a row-parallel product) is
    ``Partial()`` there; the caller redistributes it."""
    names = ctx.mesh.mesh_dim_names
    grad_pl = []
    locals_ = []
    for a in args:
        if not isinstance(a, DTensor):
            locals_.append(a)
            continue
        gp = tuple(Partial() if (p.is_replicate() and names[i] in split)
                   else p for i, p in enumerate(a.placements))
        locals_.append(a.to_local(grad_placements=gp))
    outs = fn(*locals_)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(
        o if pl is None else DTensor.from_local(o, ctx.mesh, tuple(pl),
                                                run_check=False)
        for o, pl in zip(outs, out_placements))
    return wrapped[0] if single else wrapped


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward is the identity: the sum
    is used alike on every rank, so each rank's part takes the whole
    upstream gradient (Megatron's "reduce from the parallel region")."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


class _SumPartials(torch.autograd.Function):
    """Sum over a process group of each rank's partial value, where each
    rank then uses the sum for its own part of the work (its own
    columns): the gradient of the sum is the sum of the ranks'
    gradients, so the backward sums too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    return _SumPartials.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The max over ``group`` of a value that takes no gradient."""
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def batch_split(ctx: ParallelCtx, x: DTensor) -> Tuple[str, ...]:
    """The mesh dims over which the DTensor ``x`` splits its leading
    (batch) dim."""
    names = ctx.mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(x.placements)
                 if p.is_shard(0))


def summed_over(ctx: ParallelCtx, placements, axes: Sequence[str]) -> tuple:
    """``placements`` with the mesh dims ``axes`` made ``Partial()``: the
    layout of a per-shard output that those ranks sum."""
    names = ctx.mesh.mesh_dim_names
    return tuple(Partial() if names[i] in axes else p
                 for i, p in enumerate(placements))
