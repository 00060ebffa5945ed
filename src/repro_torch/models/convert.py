"""Parameters from the JAX package's layout to the port's.

The reference's ``init_params`` returns ``blocks`` stacked over periods
(``blocks["pos{j}"][...][period]``, layer ``period * P + j``); the
port keeps one dict per layer. Dense weights share the ``(d_in, d_out)``
layout, so every leaf converts by copy. The input is a tree of numpy
arrays (``jax.tree.map(np.asarray, params)``); nothing here imports jax.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.model import Params


def _tensors(tree, index: Optional[int], device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(v, index, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_params(tree: Dict[str, Any], *, device="cpu") -> Params:
    """Tree of numpy arrays in the reference layout -> port params."""
    blocks = tree["blocks"]
    period = len(blocks)
    n_periods = np.asarray(blocks["pos0"]["norm1"]["scale"]).shape[0]
    params: Params = {
        "embed": _tensors(tree["embed"], None, device),
        "layers": [_tensors(blocks[f"pos{li % period}"], li // period,
                            device)
                   for li in range(n_periods * period)],
        "final_norm": _tensors(tree["final_norm"], None, device),
    }
    if "lm_head" in tree:
        params["lm_head"] = _tensors(tree["lm_head"], None, device)
    return params
