"""Shape-only stand-ins for every input of a step: the dry run's "data"
(the reference's ``jax.ShapeDtypeStruct`` trees). Each leaf is a tensor
on the ``meta`` device: a shape and a dtype, no storage, drawn by the
model's own ``init_*`` functions, so the trees have the structure the
steps take. ``materialize`` turns a tree into empty tensors on a device;
under a ``FakeTensorMode`` (``launch/dryrun.py``) those are fake tensors,
which DTensor lays out on a mesh of a fake process group without any
memory behind them.

Unlike the reference's trees these are global and unplaced: under a mesh
the dry run lays the parameters out by ``param_logical_axes``
(``models.model.distribute_params``), builds the optimizer state from
them as the trainer does, and places the states and the batch as the
steps' callers do.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.attention import KVCache
from repro_torch.optim import optimizer as O
from repro_torch.parallel.sharding import ParallelCtx

META = "meta"


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(acfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    S_in = 1 if shape.kind == "decode" else S
    out: Dict[str, torch.Tensor] = {}
    if acfg.model.frontend is not None:
        out["embeds"] = _sds((B, S_in, acfg.model.d_model), torch.bfloat16)
    else:
        out["tokens"] = _sds((B, S_in), torch.int32)
    if shape.kind == "train":
        out["labels"] = _sds((B, S_in), torch.int32)
    return out


def param_specs(acfg: ArchConfig, seed: int = 0):
    """``seed`` is the reference's argument; a shape does not depend on
    it."""
    del seed
    return M.init_params(acfg, device=META, generator=None)


def opt_specs(acfg: ArchConfig):
    return O.init_opt_state(acfg.train, param_specs(acfg),
                            period=acfg.model.pattern_period)


def state_specs(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec):
    """Decode-state stand-ins: KV caches sized to the shape's context
    (global shapes; ``ctx`` lays nothing out here)."""
    del ctx
    return M.init_states(acfg, shape.global_batch, shape.seq_len,
                         device=META)


def input_specs(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec
                ) -> Tuple[Any, ...]:
    """Arguments (stand-in trees) of the step function of shape.kind."""
    if shape.kind == "train":
        return (param_specs(acfg), opt_specs(acfg),
                batch_specs(acfg, shape))
    if shape.kind == "prefill":
        return (param_specs(acfg), batch_specs(acfg, shape))
    if shape.kind == "decode":
        b = batch_specs(acfg, shape)
        return (param_specs(acfg), state_specs(ctx, acfg, shape),
                b.get("tokens"), b.get("embeds"))
    raise ValueError(shape.kind)


def materialize(tree, device):
    """Every stand-in of ``tree`` as an empty tensor of its shape and
    dtype on ``device`` (other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, KVCache):
        return KVCache(*(materialize(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(v, device) for v in tree)
    return tree
