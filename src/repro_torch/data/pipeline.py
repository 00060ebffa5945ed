"""Synthetic-but-deterministic data pipeline.

Step-indexed and seeded: batch(step) is a pure function of (seed, step,
shape), so restart/replay after a failure is exact (the fault-tolerance
contract in train.trainer). Token stream is Zipf-distributed (realistic
vocab skew for the embedding-gather traffic the benchmark suite models).

``DataConfig`` and ``host_batch`` are numpy, as in the reference, so
both packages draw the same tokens for the same (seed, step).
``device_batch`` puts a batch on one device, or, under a mesh, its rows
over the batch axes: every rank draws the same global batch and keeps
its own rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.parallel.sharding import NO_MESH, ParallelCtx, place


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2        # vocab skew
    mask_fraction: float = 0.0  # fraction of labels masked (-1)


def _rng_for_step(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def host_batch(acfg: ArchConfig, shape: ShapeSpec, step: int,
               cfg: DataConfig = DataConfig()) -> Dict[str, np.ndarray]:
    """One global batch as host numpy arrays."""
    rng = _rng_for_step(cfg, step)
    B, S = shape.global_batch, shape.seq_len
    V = acfg.model.vocab_size
    # Zipf over the vocab, clipped
    toks = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
    toks = np.minimum(toks - 1, V - 1).astype(np.int32)
    batch: Dict[str, np.ndarray] = {}
    if acfg.model.frontend is not None:
        d = acfg.model.d_model
        batch["embeds"] = rng.standard_normal(
            (B, S, d), dtype=np.float32).astype(np.float32)
    else:
        batch["tokens"] = toks[:, :S]
    labels = toks[:, 1:].copy()
    if cfg.mask_fraction > 0:
        drop = rng.random((B, S)) < cfg.mask_fraction
        labels[drop] = -1
    batch["labels"] = labels
    return batch


def device_batch(batch: Dict[str, np.ndarray], device,
                 ctx: ParallelCtx = NO_MESH) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``; under a mesh as DTensors,
    the rows over the batch axes (``launch.steps.batch_shardings``)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    if ctx.mesh is None:
        return out
    from repro_torch.launch.steps import batch_shardings
    pl = batch_shardings(ctx, out)
    return {k: place(v, ctx.mesh, pl[k]) for k, v in out.items()}


def iterate(acfg: ArchConfig, shape: ShapeSpec, device,
            start_step: int = 0, cfg: DataConfig = DataConfig()
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield device_batch(host_batch(acfg, shape, step, cfg), device)
        step += 1
