"""Plain PyTorch version of the routed-expert GLU FFN: the counterpart of
the hand-written kernel (``csrc/moe_decode.cu``), used on CPU tensors
and as its oracle on the card.

Each assignment's expert weights are gathered and multiplied with
``torch.bmm``, one (1, d) row an assignment, so each routed product is
the row of the dense path's batched product over every expert
(``models/moe.py`` ``_expert_ffn``) that holds this assignment, with the
same rounding points: the two products, the activation, their product
and the down product, each in the weights' dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: the activations a GLU expert takes, as ``models.layers.activation``
#: computes them
ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda t: F.gelu(t, approximate="tanh")}


def moe_decode_plain(x: torch.Tensor, ids: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, act: str) -> torch.Tensor:
    """x: (A, d) assignment rows; ids: (A,) each row's expert; w_gate,
    w_up: (E, d, f); w_down: (E, f, d). Returns (A, d):
    ``(act(x W_gate[e]) * (x W_up[e])) W_down[e]`` row by row."""
    rows = x[:, None, :]
    gate = torch.bmm(rows, w_gate[ids])
    up = torch.bmm(rows, w_up[ids])
    inner = ACTIVATIONS[act](gate) * up
    return torch.bmm(inner, w_down[ids])[:, 0]
