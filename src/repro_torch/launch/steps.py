"""Step functions (train / prefill / decode) shared by the trainer, the
serve engine and their tests: plain functions run eagerly (the reference
jits them; PyTorch needs no counterpart). Prefill and decode run under
``torch.no_grad``.

The train step is functional, as the reference's is when the trainer
passes ``donate=False``: it returns new parameter and optimizer-state
tensors and leaves the ones it was given intact, so a step that fails
can be retried from them.

Every step takes a parallel context (``ctx``, default ``NO_MESH``).
Under a mesh the parameters are DTensors on ``param_shardings`` and the
batch DTensors on ``batch_shardings`` (``data.pipeline.device_batch``);
the train step returns the parameters on the placements it received
them on, as the reference's ``out_shardings`` pin them."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.parallel.sharding import (NO_MESH, ParallelCtx,
                                           tree_shardings)

Params = Any


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def param_shardings(ctx: ParallelCtx, acfg: ArchConfig):
    """The DTensor placements of every parameter (``init_params``' tree)."""
    return tree_shardings(ctx, M.param_logical_axes(acfg))


def batch_shardings(ctx: ParallelCtx, batch: Dict):
    """Placements of each batch entry: rows over the batch axes (when
    they divide the batch), every other dim whole."""
    def one(a):
        b_ax = "batch" if a.shape[0] % ctx.n_batch_shards == 0 else None
        return ctx.placements(b_ax, *([None] * (a.ndim - 1)))
    return {k: one(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_loss_fn(acfg: ArchConfig, ctx: ParallelCtx = NO_MESH):
    """(params, batch) -> (ce + aux, {ce, aux}): aux is the MoE router's
    load-balance loss (0 for a model without MoE); plain 0-d tensors,
    under a mesh too."""
    def loss(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, _, aux = M.forward(acfg, params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"), mode="train",
                                   ctx=ctx)
        ce = M.loss_fn(acfg, params, hidden, batch["labels"], ctx=ctx)
        return ce + aux, {"ce": ce.detach(), "aux": aux.detach()}
    return loss


def loss_and_grads(loss, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Params]:
    """(metrics, gradients shaped like ``params``) of ``loss`` (a
    ``make_loss_fn`` function) at ``params``, which stay untouched. A
    DTensor's gradient comes back on the placements of its parameter:
    the sum over the ranks that shared its work is taken here (the
    gradient push)."""
    leaves = [p.detach().requires_grad_() for p in O.tree_leaves(params)]
    it = iter(leaves)
    total, metrics = loss(O.tree_map(lambda _: next(it), params), batch)
    # a parameter the loss does not read (the token embedding of a model
    # fed frontend embeds, with an untied head) has a zero gradient, as
    # in the reference's jax.grad
    raw = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None
             else g if not hasattr(p, "placements")
             or tuple(g.placements) == tuple(p.placements)
             else g.redistribute(p.device_mesh, p.placements)
             for p, g in zip(leaves, raw)]
    it = iter(grads)
    return metrics, O.tree_map(lambda _: next(it), params)


def make_train_step(acfg: ArchConfig, ctx: ParallelCtx = NO_MESH):
    """(params, opt_state, batch) -> (new_params, new_opt, metrics):
    loss, backward, then ``apply_updates`` under ``no_grad``. metrics:
    ``ce``, ``aux``, ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""
    loss = make_loss_fn(acfg, ctx)

    def step(params: Params, opt_state, batch: Dict[str, torch.Tensor]):
        metrics, grads = loss_and_grads(loss, params, batch)
        with torch.no_grad():
            new_params, new_opt, om = O.apply_updates(acfg.train, params,
                                                      grads, opt_state)
        metrics.update(om)
        metrics["loss"] = metrics["ce"] + metrics["aux"]
        return new_params, new_opt, metrics
    return step


def make_prefill_step(acfg: ArchConfig, max_seq: Optional[int] = None,
                      ctx: ParallelCtx = NO_MESH):
    """(params, batch) -> (states, logits at the last position only)."""

    @torch.no_grad()
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, states, _ = M.forward(
            acfg, params, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill", max_seq=max_seq,
            ctx=ctx)
        logits = M.logits_fn(acfg, params, hidden[:, -1:], ctx=ctx)
        return states, logits
    return prefill


def make_decode_step(acfg: ArchConfig, batch: int,
                     ctx: ParallelCtx = NO_MESH):
    """(params, states, tokens (B, 1), embeds) -> (new_states, logits).
    The states' KV caches are written in place."""

    @torch.no_grad()
    def decode(params: Params, states, tokens, embeds=None):
        assert (tokens if tokens is not None else embeds).shape[0] == batch
        hidden, new_states, _ = M.forward(
            acfg, params, tokens=tokens, embeds=embeds, states=states,
            mode="decode", ctx=ctx)
        logits = M.logits_fn(acfg, params, hidden, ctx=ctx)
        return new_states, logits
    return decode
