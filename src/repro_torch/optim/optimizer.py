"""Optimizers: AdamW, Adafactor (factored second moment), SGD; global-norm
clipping; warmup+cosine schedule; gradient compression with error
feedback.

Plain functions on trees of tensors (nested dicts, lists and tuples, as
``models.model.init_params`` returns them), the counterpart of the
reference's ``jax.tree.map`` code: every update is functional and
returns new parameter and state tensors, so a caller that keeps the old
ones can retry a step from them. Scalars (the step, the learning rate,
the norm) are 0-d tensors on the parameters' device, so nothing here
waits for the card. Compression quantizes the gradient estimate with an
error-feedback residual, as the reference does.

Over a mesh the parameters, gradients and state are DTensors on the
parameters' placements (ZeRO-3: each rank keeps its shard of every
moment). The elementwise updates run on each rank's shard; what the
reference reduces over whole tensors is reduced across the shards: the
global norm, the int8 compression scale, Adafactor's row and column
means and its update RMS.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import TrainConfig
from repro_torch.models.convert import (from_jax_params, map_leaves,
                                        stack_layers, to_jax_params,
                                        to_numpy, unstack_layers)
from repro_torch.parallel.sharding import place

Params = Any


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (nested dicts, lists, tuples),
    with the subtrees of each of ``rest`` at the same places as extra
    arguments (a subtree may be a dict where ``tree`` has a tensor, as
    Adafactor's per-tensor state is)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _pick(like, out, i: int):
    """The ``i``-th entry of the tuples ``tree_map`` left at each leaf."""
    return tree_map(lambda _, o: o[i], like, out)


def _stacked(tree, period: int):
    """A tree with ``layers`` in the reference's stacked layout
    (``models.convert.stack_layers``: copies); any other tree as it is."""
    if isinstance(tree, dict) and "layers" in tree:
        return stack_layers(tree, period, _stack)
    return tree


def _unstacked(tree):
    """The inverse of ``_stacked``."""
    if isinstance(tree, dict) and "blocks" in tree:
        return unstack_layers(tree, _take)
    return tree


# ---------------------------------------------------------------------------
# DTensors: the updates run on each rank's shard
# ---------------------------------------------------------------------------

def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _contiguous_stride(shape) -> Tuple[int, ...]:
    """The stride of a contiguous tensor of ``shape``, as torch gives it
    (a dim of size 0 steps as one of size 1), with no tensor made."""
    stride, step = [], 1
    for n in reversed(shape):
        stride.append(step)
        step *= max(n, 1)
    return tuple(reversed(stride))


def _like(t: torch.Tensor, ref, placements=None, shape=None):
    """The local tensor ``t`` as a DTensor laid out as ``ref`` (or on
    ``placements`` with global ``shape``); ``t`` itself when ``ref`` is a
    plain tensor. Allocates nothing: a stand-in made only to read its
    stride would count as memory under a tracker."""
    if not isinstance(ref, DTensor):
        return t
    placements = tuple(ref.placements) if placements is None else placements
    shape = tuple(ref.shape) if shape is None else tuple(shape)
    return DTensor.from_local(t, ref.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _reduce(t: torch.Tensor, ref, dims=None, op=dist.ReduceOp.SUM):
    """Reduce the local partial ``t`` over the ranks that split the
    tensor dims ``dims`` (all dims when None) of the DTensor ``ref``;
    ``t`` itself for a plain ``ref``."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    for i, p in enumerate(ref.placements):
        if p.is_shard() and (dims is None or p.dim in dims):
            dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def _stack(leaves: List[torch.Tensor]):
    """``torch.stack`` of one period position's layers; DTensors stack
    their shards, each shard dim one further."""
    if not isinstance(leaves[0], DTensor):
        return torch.stack(leaves)
    ref = leaves[0]
    pl = tuple(Shard(p.dim + 1) if p.is_shard() else p
               for p in ref.placements)
    return _like(torch.stack([t.to_local() for t in leaves]), ref, pl,
                 (len(leaves),) + tuple(ref.shape))


def _take(a, i: int):
    """Layer ``i`` of a stacked leaf (the inverse of ``_stack``)."""
    if not isinstance(a, DTensor):
        return a[i]
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p
               for p in a.placements)
    return _like(a.to_local()[i], a, pl, tuple(a.shape[1:]))


def _without_dim(ref, dim: int):
    """(placements, shape) of the DTensor ``ref`` reduced over tensor dim
    ``dim``; (None, None) for a plain tensor."""
    if not isinstance(ref, DTensor):
        return None, None
    dim = dim % ref.ndim
    pl = tuple(Replicate() if p.is_shard(dim) else
               Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p
               for p in ref.placements)
    return pl, tuple(ref.shape[:dim]) + tuple(ref.shape[dim + 1:])


# ---------------------------------------------------------------------------
# Schedule, clipping
# ---------------------------------------------------------------------------

def lr_schedule(cfg: TrainConfig, total_steps: int = 10_000
                ) -> Callable[[torch.Tensor], torch.Tensor]:
    def lr(step: torch.Tensor) -> torch.Tensor:
        # (step+1): step 0 must not have lr == 0 (a dead first step)
        warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1),
                           max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """The norm over every element of every leaf (of every shard)."""
    leaves = [_reduce(torch.sum(torch.square(_local(x).float())), x)
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` to a global norm of at most ``max_norm``, IN PLACE
    (as ``torch.nn.utils.clip_grad_norm_`` does: a second copy of every
    gradient would be the largest allocation of a step); returns
    (grads, the norm before clipping). The values equal the reference's
    functional form."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        _local(g).mul_(scale.to(g.dtype))
    return grads, gn


# ---------------------------------------------------------------------------
# Gradient compression with error feedback
# ---------------------------------------------------------------------------

def compress_grads(grads, residual, mode: Optional[str]):
    """Quantize grads (+ carry error feedback). Returns (grads', residual').
    ``torch.round``, like ``jnp.round``, rounds half to even."""
    if mode is None:
        return grads, residual

    def one(g, r):
        gf = _local(g).float() + _local(r)
        if mode == "bf16":
            q = gf.to(torch.bfloat16).float()
        elif mode == "int8":
            # the scale of the whole tensor, over every shard
            amax = _reduce(gf.abs().max(), g, op=dist.ReduceOp.MAX)
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.round(gf / scale).to(torch.int8).float() * scale
        else:
            raise ValueError(mode)
        return _like(q.to(g.dtype), g), _like(gf - q, g)

    out = tree_map(one, grads, residual)
    return _pick(grads, out, 0), _pick(grads, out, 1)


def _zeros(p: torch.Tensor) -> torch.Tensor:
    if isinstance(p, DTensor):       # on the parameter's placements
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_residual(params, mode: Optional[str]):
    if mode is None:
        return ()
    return tree_map(_zeros, params)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params) -> Dict:
    return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params)}


def adamw_update(cfg: TrainConfig, params, grads, state, step, lr):
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    t = step + 1
    c1 = 1 - b1 ** t
    c2 = 1 - b2 ** t

    def upd(p_, g, m, v):
        # the reference's arithmetic, each new tensor updated in place so
        # that a leaf holds two temporaries, not six
        p, gf = _local(p_), _local(g).float()
        m = torch.mul(_local(m), b1).add_(gf, alpha=1 - b1)
        v = torch.mul(_local(v), b2).addcmul_(gf, gf, value=1 - b2)
        denom = torch.div(v, c2).sqrt_().add_(eps)
        step_ = torch.div(m, c1).div_(denom).add_(p.float(),
                                                  alpha=cfg.weight_decay)
        p = (p - step_.mul_(lr).to(p.dtype)).to(p.dtype)
        return _like(p, p_), _like(m, p_), _like(v, p_)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    return _pick(params, out, 0), {"m": _pick(params, out, 1),
                                   "v": _pick(params, out, 2)}


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored for >=2-D tensors
#
# Not elementwise: it factors and RMS-clips whole tensors, and the
# reference's tensors are its stacked blocks (each per-layer weight with
# a leading period axis). So the update runs on that layout
# (``_stacked``: a copy of the params and grads each step) and the state
# lives in it: a per-layer vector such as a norm scale is factored across
# the layers of its period position, and the update's RMS is taken over
# all of them, as in the reference.
# ---------------------------------------------------------------------------

def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 2 and p.shape[-2] >= 2


def adafactor_init(params, period: int) -> Dict:
    """``period``: the model's ``pattern_period`` (how ``layers`` stack)."""
    device = tree_leaves(params)[0].device

    def zeros(p, dim):
        if not isinstance(p, DTensor):
            shape = p.shape[:dim] + p.shape[dim + 1:] if dim is not None \
                else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=device)
        pl, shape = (_without_dim(p, dim) if dim is not None
                     else (tuple(p.placements), tuple(p.shape)))
        t = _local(p)
        lshape = t.shape[:dim] + t.shape[dim + 1:] if dim is not None \
            else t.shape
        return _like(torch.zeros(lshape, dtype=torch.float32,
                                 device=device), p, pl, shape)

    def one(p):
        if _factored(p):
            return {"vr": zeros(p, p.ndim - 1), "vc": zeros(p, p.ndim - 2)}
        return {"v": zeros(p, None)}
    shapes = tree_map(lambda t: t if isinstance(t, DTensor) else
                      torch.empty(t.shape, device="meta"), params)
    return {"v": tree_map(one, _stacked(shapes, period))}


def adafactor_update(cfg: TrainConfig, params, grads, state, step, lr):
    blocks = state["v"].get("blocks") if isinstance(state["v"], dict) \
        else None
    period = len(blocks) if blocks is not None else 1
    params_s = _stacked(params, period)
    grads_s = _stacked(grads, period)
    t = step + 1
    beta2 = 1.0 - t ** -0.8   # Adafactor's schedule
    eps = 1e-30

    def mean(x, ref, dim=None, pdim=None, keepdim=False):
        """torch.mean over ``dim`` (all when None) of a local shard of
        ``ref``'s layout, across the shards that split ``ref``'s tensor
        dim ``pdim`` (default: ``dim``)."""
        if not isinstance(ref, DTensor):
            return torch.mean(x) if dim is None else \
                torch.mean(x, dim=dim, keepdim=keepdim)
        if dim is None:
            return _reduce(torch.sum(x), ref) / ref.numel()
        pdim = (dim if pdim is None else pdim) % ref.ndim
        return _reduce(torch.sum(x, dim=dim, keepdim=keepdim), ref,
                       (pdim,)) / ref.shape[pdim]

    def upd(p_, g, v):
        p, gf = _local(p_), _local(g).float()
        g2 = gf * gf + eps
        if _factored(p_):
            vr = beta2 * _local(v["vr"]) + (1 - beta2) * mean(g2, p_, -1)
            vc = beta2 * _local(v["vc"]) + (1 - beta2) * mean(g2, p_, -2)
            rmean = mean(vr, p_, -1, pdim=-2, keepdim=True)
            prec = (vr / torch.clamp(rmean, min=eps))[..., None] * \
                vc.unsqueeze(-2)
            u = gf / torch.sqrt(torch.clamp(prec, min=eps))
            nv = {"vr": _like(vr, p_, *_without_dim(p_, -1)),
                  "vc": _like(vc, p_, *_without_dim(p_, -2))}
        else:
            nv = {"v": beta2 * _local(v["v"]) + (1 - beta2) * g2}
            u = gf / torch.sqrt(torch.clamp(nv["v"], min=eps))
            nv = {"v": _like(nv["v"], p_)}
        # update clipping (RMS <= 1)
        rms = torch.sqrt(mean(u * u, p_) + eps)
        u = u / torch.clamp(rms, min=1.0)
        u = u + cfg.weight_decay * p.float()
        return _like((p - lr * u.to(p.dtype)).to(p.dtype), p_), nv

    out = tree_map(upd, params_s, grads_s, state["v"])
    return (_unstacked(_pick(params_s, out, 0)),
            {"v": _pick(params_s, out, 1)})


# ---------------------------------------------------------------------------
# SGD (momentum)
# ---------------------------------------------------------------------------

def sgd_init(params) -> Dict:
    return {"m": tree_map(_zeros, params)}


def sgd_update(cfg: TrainConfig, params, grads, state, step, lr):
    def upd(p_, g, m):
        p = _local(p_)
        m = cfg.beta1 * _local(m) + _local(g).float()
        return _like((p - lr * m.to(p.dtype)).to(p.dtype), p_), _like(m, p_)
    out = tree_map(upd, params, grads, state["m"])
    return _pick(params, out, 0), {"m": _pick(params, out, 1)}


# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "adamw": (adamw_init, adamw_update),
    "adafactor": (adafactor_init, adafactor_update),
    "sgd": (sgd_init, sgd_update),
}


def init_opt_state(cfg: TrainConfig, params, *, period: int) -> Dict:
    """``period``: the model's ``pattern_period``. Only Adafactor's state
    depends on it (see above); a tree without ``layers`` takes 1."""
    init, _ = OPTIMIZERS[cfg.optimizer]
    state = (init(params, period) if cfg.optimizer == "adafactor"
             else init(params))
    device = tree_leaves(params)[0].device
    state["step"] = torch.zeros((), dtype=torch.int32, device=device)
    state["residual"] = init_residual(params, cfg.grad_compression)
    return state


#: the state entries an optimizer keeps in the reference's layout
_REFERENCE_LAYOUT = {"adafactor": ("v",)}


def state_to_reference(opt: Dict, *, period: int) -> Dict:
    """The state of a model's params in the reference's layout, as numpy
    (the tree the reference's ``init_opt_state`` returns). ``period``: the
    model's ``pattern_period``."""
    def one(v):
        if isinstance(v, tuple):                  # the residual, when off
            return v
        if isinstance(v, torch.Tensor):           # the step
            return to_numpy(v)
        if "blocks" in v:                         # kept stacked
            return map_leaves(to_numpy, v)
        return to_jax_params(v, period=period)
    return {k: one(v) for k, v in opt.items()}


def place_state(cfg: TrainConfig, opt: Dict, params, *,
                period: int) -> Dict:
    """Whole optimizer state (``state_from_reference``'s) laid out as
    ``init_opt_state`` lays it out for ``params``: on each moment's
    placements where ``params`` are DTensors (each rank keeps its
    shards), unchanged where they are plain tensors."""
    if not isinstance(tree_leaves(params)[0], DTensor):
        return opt
    layout = init_opt_state(cfg, params, period=period)
    return tree_map(lambda t, ref: place(t, ref.device_mesh, ref.placements)
                    if isinstance(ref, DTensor) else t, opt, layout)


def state_from_reference(cfg: TrainConfig, tree: Dict, *, device) -> Dict:
    """The inverse of ``state_to_reference``: tensors on ``device``."""
    kept = _REFERENCE_LAYOUT.get(cfg.optimizer, ())

    def one(k, v):
        if isinstance(v, tuple):
            return v
        if k in kept or not isinstance(v, dict):
            return map_leaves(lambda a: torch.from_numpy(
                np.array(a, copy=True)).to(device), v)
        return from_jax_params(v, device=device)
    return {k: one(k, v) for k, v in tree.items()}


def apply_updates(cfg: TrainConfig, params, grads, state,
                  total_steps: int = 10_000):
    """One optimizer step. Returns (new params, new state, {grad_norm,
    lr}); ``params`` and ``state`` are left as they were, ``grads`` are
    clipped in place (they are the step's own)."""
    step = state["step"]
    lr = lr_schedule(cfg, total_steps)(step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    grads, residual = compress_grads(grads, state["residual"],
                                     cfg.grad_compression)
    _, update = OPTIMIZERS[cfg.optimizer]
    opt_only = {k: v for k, v in state.items()
                if k not in ("step", "residual")}
    new_params, new_opt = update(cfg, params, grads, opt_only, step, lr)
    new_opt["step"] = step + 1
    new_opt["residual"] = residual
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
