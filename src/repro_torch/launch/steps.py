"""Step functions (prefill / decode) shared by the serve engine and its
tests: plain functions run eagerly under ``torch.no_grad`` (the
reference jits them; PyTorch needs no counterpart)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M

Params = Any


def make_prefill_step(acfg: ArchConfig, max_seq: Optional[int] = None):
    """(params, batch) -> (states, logits at the last position only)."""
    @torch.no_grad()
    def prefill(params: Params, batch: Dict[str, torch.Tensor]):
        hidden, states = M.forward(
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
        hidden, new_states = M.forward(
            acfg, params, tokens=tokens, embeds=embeds, states=states,
            mode="decode")
        logits = M.logits_fn(acfg, params, hidden)
        return new_states, logits
    return decode
