"""Plain PyTorch version of the routed-expert GLU FFN: the counterpart of
the hand-written kernel (``csrc/moe_decode.cu``), used on CPU tensors
and as its oracle on the card.

Each assignment's expert weights are gathered and multiplied with
``torch.bmm``, one (1, d) row an assignment, so each routed product is
the row of the dense path's batched product over every expert
(``models/moe.py`` ``_expert_ffn``) that holds this assignment, with the
same rounding points: the two products, the activation, their product
and the down product, each in the weights' dtype. A row routed to an
expert the weights do not hold (a share of the experts) is zero."""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: the activations a GLU expert takes, as ``models.layers.activation``
#: computes them
ACTIVATIONS = {"silu": F.silu,
               "gelu": lambda t: F.gelu(t, approximate="tanh")}


def moe_decode_plain(x: torch.Tensor, ids: torch.Tensor,
                     w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, act: str,
                     expert_offset: int = 0) -> torch.Tensor:
    """x: (A, d) assignment rows; ids: (A,) each row's expert; w_gate,
    w_up: (E, d, f); w_down: (E, f, d), experts ``expert_offset`` ..
    + E - 1. Returns (A, d): ``(act(x W_gate[e]) * (x W_up[e]))
    W_down[e]`` row by row, zeros for a row whose expert is not held."""
    rel = ids - expert_offset
    held = (rel >= 0) & (rel < w_gate.shape[0])
    rel = rel.clamp(0, w_gate.shape[0] - 1)
    rows = x[:, None, :]
    gate = torch.bmm(rows, w_gate[rel])
    up = torch.bmm(rows, w_up[rel])
    inner = ACTIVATIONS[act](gate) * up
    out = torch.bmm(inner, w_down[rel])[:, 0]
    return torch.where(held[:, None], out, 0)
