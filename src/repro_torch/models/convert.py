"""Parameters between the JAX package's layout and the port's.

The reference's ``init_params`` returns ``blocks`` stacked over periods
(``blocks["pos{j}"][...][period]``, layer ``period * P + j``); the
port keeps one dict per layer (``layers``). Dense weights share the
``(d_in, d_out)`` layout, so every leaf converts by copy.
``stack_layers`` / ``unstack_layers`` are the one place that knows this
layout: the conversions below and Adafactor's update (which factors
whole stacked tensors, as the reference does) go through them. Both
directions take any tree shaped like the parameters, whose leaves may
themselves be dicts: optimizer state and the compression residual
convert as the parameters do. The reference side is numpy
(``jax.tree.map(np.asarray, params)`` in, numpy out); nothing here
imports jax.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.model import Params


def _zip_map(fn: Callable[[List[Any]], Any], trees: List[Any]) -> Any:
    """``fn`` over the lists of leaves at the same place in ``trees``
    (nested dicts of one structure)."""
    if isinstance(trees[0], dict):
        return {k: _zip_map(fn, [t[k] for t in trees]) for k in trees[0]}
    return fn(trees)


def map_leaves(fn: Callable[[Any], Any], tree) -> Any:
    """``fn`` over the leaves of a tree of nested dicts."""
    return _zip_map(lambda leaves: fn(leaves[0]), [tree])


def stack_layers(tree: Dict[str, Any], period: int,
                 stack: Callable[[List[Any]], Any] = torch.stack
                 ) -> Dict[str, Any]:
    """A params-shaped tree in the reference's layout: the leaves of
    ``layers[j::period]`` joined by ``stack`` (a list of leaves -> one
    leaf with a leading period axis) into ``blocks["pos{j}"]``; the other
    entries as they are. ``period`` is the config's
    ``model.pattern_period``."""
    blocks = {f"pos{j}": _zip_map(stack, tree["layers"][j::period])
              for j in range(period)}
    return {("blocks" if k == "layers" else k): (blocks if k == "layers"
                                                 else v)
            for k, v in tree.items()}


def unstack_layers(tree: Dict[str, Any],
                   take: Callable[[Any, int], Any] = lambda a, i: a[i]
                   ) -> Dict[str, Any]:
    """The inverse of ``stack_layers``: layer ``li`` is ``take(leaf, li //
    period)`` of each leaf of ``blocks["pos{li % period}"]``."""
    blocks = tree["blocks"]
    period = len(blocks)
    first = blocks["pos0"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n = np.shape(first)[0] * period
    layers = [map_leaves(lambda a, i=li // period: take(a, i),
                         blocks[f"pos{li % period}"]) for li in range(n)]
    return {("layers" if k == "blocks" else k): (layers if k == "blocks"
                                                 else v)
            for k, v in tree.items()}


def to_numpy(t) -> np.ndarray:
    """A tensor as a host numpy array. A meta tensor (shape and dtype,
    no data) becomes a zero-stride array of its shape and dtype, which
    holds no memory: enough for a checkpoint's restore target. A DTensor
    is gathered whole (a collective: every rank of its mesh calls)."""
    if isinstance(t, np.ndarray):
        return t
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.is_meta:
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        return np.broadcast_to(np.zeros((), dtype), tuple(t.shape))
    return t.detach().cpu().numpy()


def _stack_on_host(leaves: List[torch.Tensor]) -> np.ndarray:
    # leaf by leaf on the host: a stacked second copy of a tree on the
    # card would not fit beside a full-width training state
    if leaves[0].is_meta:
        return to_numpy(torch.stack(leaves))
    return np.stack([to_numpy(t) for t in leaves])


def from_jax_params(tree: Dict[str, Any], *, device="cpu") -> Params:
    """Tree of numpy arrays in the reference layout -> port layout, as
    tensors on ``device`` (each layer's its own copy)."""
    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)
    layers = unstack_layers(tree, lambda a, i: tensor(np.asarray(a)[i]))
    return {k: (v if k == "layers" else map_leaves(tensor, v))
            for k, v in layers.items()}


def to_jax_params(tree: Params, *, period: int) -> Dict[str, Any]:
    """Port layout -> the reference layout as numpy (the inverse of
    ``from_jax_params``). ``period`` is the config's
    ``model.pattern_period``."""
    return map_leaves(to_numpy, stack_layers(tree, period, _stack_on_host))
