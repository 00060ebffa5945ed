"""Atomic checkpointing in the reference's on-disk layout.

Layout:  <dir>/step_<N>.tmp/ -> fsync'd leaf .npy files + manifest.json
         -> atomic rename to <dir>/step_<N>/ (the COMMIT point).
Partially-written checkpoints are never visible under the final name;
``latest_step`` only ever sees committed ones, so a crash mid-save is
recovered by falling back to the previous step.

Leaves are named by their tree path joined with ``$``, as the
reference's ``jax.tree_util.tree_flatten_with_path`` names them: a dict
entry by its key (keys in sorted order, as JAX flattens dicts), a list
or tuple entry by its index. A tree saved here in the reference's
parameter layout (``models.convert.to_jax_params``) therefore restores
in the JAX package, and the other way round. Leaves may be tensors (on
any device) or numpy arrays; bf16 tensors are written as float32, which
numpy can read without JAX's dtype extensions.

Over a mesh the leaves may be DTensors: ``save`` gathers each whole on
every rank (the calls are collective) and one writer, rank 0, writes
the reference's layout; ``restore`` places each array on the target
leaf's placements, each rank keeping its own shards. The files hold no
trace of the mesh, so a run restarts on another mesh or on none (the
reference's elastic restart).
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import place

SEP = "$"


def _writer() -> bool:
    """Whether this process writes: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _flatten_with_names(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_names(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_names(v, prefix + (str(i),))]
    if tree is None:
        return []
    return [(SEP.join(prefix), tree)]


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _unflatten_like(target, leaves):
    """``target``'s structure with its leaves replaced, in
    ``_flatten_with_names`` order, from the iterator ``leaves``."""
    if isinstance(target, dict):
        out = {k: _unflatten_like(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(v, leaves) for v in target)
    if target is None:
        return None
    return next(leaves)


def save(ckpt_dir: str, step: int, tree, extra: Optional[Dict] = None
         ) -> str:
    """Write ``tree`` as ``<ckpt_dir>/step_<step>``: every rank gathers,
    rank 0 writes, and no rank returns before the commit."""
    arrays = [(name, _numpy(leaf))
              for name, leaf in _flatten_with_names(tree)]
    final = os.path.join(ckpt_dir, f"step_{step}")
    if _writer():
        _write(ckpt_dir, step, arrays, extra)
    _barrier()
    return final


def _write(ckpt_dir: str, step: int, arrays, extra) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names = []
    for name, arr in arrays:
        fn = os.path.join(tmp, name + ".npy")
        with open(fn, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        names.append(name)
    manifest = {"step": step, "leaves": names, "extra": extra or {}}
    mf = os.path.join(tmp, "manifest.json")
    with open(mf, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # COMMIT


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for s in _steps(ckpt_dir) if os.path.exists(
        os.path.join(ckpt_dir, f"step_{s}", "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target) -> Tuple[Any, Dict]:
    """Load into the structure of ``target``: each leaf takes the dtype
    of the target's leaf there, and its device where that is a tensor
    (a numpy leaf loads as numpy), and its placements where that is a
    DTensor. Raises ``ValueError`` when the leaf names or a shape
    differ. Returns (tree, extra)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    named = _flatten_with_names(target)
    if {n for n, _ in named} != set(manifest["leaves"]):
        raise ValueError("checkpoint/target structure mismatch: "
                         f"{set(n for n, _ in named) ^ set(manifest['leaves'])}")
    loaded = []
    for name, tgt in named:
        arr = np.load(os.path.join(path, name + ".npy"))
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"checkpoint leaf {name}: shape {arr.shape}, "
                             f"target {tuple(tgt.shape)}")
        if isinstance(tgt, DTensor):
            loaded.append(place(torch.from_numpy(arr).to(tgt.device,
                                                         tgt.dtype),
                                tgt.device_mesh, tgt.placements))
        elif isinstance(tgt, torch.Tensor):
            loaded.append(torch.from_numpy(arr).to(tgt.device, tgt.dtype))
        else:
            loaded.append(arr.astype(tgt.dtype))
    return _unflatten_like(target, iter(loaded)), manifest["extra"]


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Remove all but the ``keep`` newest ``step_N`` directories (the
    writer only)."""
    if not _writer() or not os.path.isdir(ckpt_dir):
        return
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
