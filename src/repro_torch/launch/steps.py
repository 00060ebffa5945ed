"""Step functions (train / prefill / decode) shared by the trainer, the
serve engine and their tests: plain functions run eagerly (the reference
jits them; PyTorch needs no counterpart). Prefill and decode run under
``torch.no_grad``.

The train step is functional, as the reference's is when the trainer
passes ``donate=False``: it returns new parameter and optimizer-state
tensors and leaves the ones it was given intact, so a step that fails
can be retried from them."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O

Params = Any


def make_loss_fn(acfg: ArchConfig):
    """(params, batch) -> (ce + aux, {ce, aux}): aux is the MoE router's
    load-balance loss (0 for a model without MoE)."""
    def loss(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, _, aux = M.forward(acfg, params, tokens=batch.get("tokens"),
                                   embeds=batch.get("embeds"), mode="train")
        ce = M.loss_fn(acfg, params, hidden, batch["labels"])
        return ce + aux, {"ce": ce.detach(), "aux": aux.detach()}
    return loss


def loss_and_grads(loss, params: Params, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Params]:
    """(metrics, gradients shaped like ``params``) of ``loss`` (a
    ``make_loss_fn`` function) at ``params``, which stay untouched."""
    leaves = [p.detach().requires_grad_() for p in O.tree_leaves(params)]
    it = iter(leaves)
    total, metrics = loss(O.tree_map(lambda _: next(it), params), batch)
    it = iter(torch.autograd.grad(total, leaves))
    return metrics, O.tree_map(lambda _: next(it), params)


def make_train_step(acfg: ArchConfig):
    """(params, opt_state, batch) -> (new_params, new_opt, metrics):
    loss, backward, then ``apply_updates`` under ``no_grad``. metrics:
    ``ce``, ``aux``, ``loss``, ``grad_norm``, ``lr`` (0-d tensors)."""
    loss = make_loss_fn(acfg)

    def step(params: Params, opt_state, batch: Dict[str, torch.Tensor]):
        metrics, grads = loss_and_grads(loss, params, batch)
        with torch.no_grad():
            new_params, new_opt, om = O.apply_updates(acfg.train, params,
                                                      grads, opt_state)
        metrics.update(om)
        metrics["loss"] = metrics["ce"] + metrics["aux"]
        return new_params, new_opt, metrics
    return step


def make_prefill_step(acfg: ArchConfig, max_seq: Optional[int] = None):
    """(params, batch) -> (states, logits at the last position only)."""
    @torch.no_grad()
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, states, _ = M.forward(
            acfg, params, tokens=batch.get("tokens"),
            embeds=batch.get("embeds"), mode="prefill", max_seq=max_seq)
        logits = M.logits_fn(acfg, params, hidden[:, -1:])
        return states, logits
    return prefill


def make_decode_step(acfg: ArchConfig, batch: int):
    """(params, states, tokens (B, 1), embeds) -> (new_states, logits).
    The states' KV caches are written in place."""
    @torch.no_grad()
    def decode(params: Params, states, tokens, embeds=None):
        assert (tokens if tokens is not None else embeds).shape[0] == batch
        hidden, new_states, _ = M.forward(
            acfg, params, tokens=tokens, embeds=embeds, states=states,
            mode="decode")
        logits = M.logits_fn(acfg, params, hidden)
        return new_states, logits
    return decode
