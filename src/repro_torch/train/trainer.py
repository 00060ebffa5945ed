"""Trainer: checkpoint/restart, straggler watchdog, failure recovery —
the fault-tolerance layer, on one device or over a mesh (``ctx``).

Everything the step needs (params, opt state, data cursor) is
reconstructable from (checkpoint, step index), because the data pipeline
is step-indexed and deterministic and the train step is functional: a
failed step is retried from the params and opt state it started with.
Checkpoints are written in the JAX package's layout
(``models.convert.to_jax_params``), so a run of either package resumes
from the other's checkpoint.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.optim import optimizer as O
from repro_torch.parallel.sharding import NO_MESH, ParallelCtx

log = logging.getLogger("repro_torch.trainer")

#: The step fault boundary: what counts as a *node failure* the retry /
#: restart-from-checkpoint path may absorb. Device and runtime faults
#: surface as RuntimeError (``torch.OutOfMemoryError`` and CUDA errors
#: subclass it) and host-side checkpoint/data I/O as OSError. Programming
#: errors (TypeError, ValueError, ...) propagate — retrying them would
#: loop a bug through max_step_retries and then "recover" into the same
#: bug from the checkpoint. This is the one broad catch in
#: src/repro_torch/train/ (tests/test_torch_train.py rejects inline
#: blanket Exception handlers here).
STEP_FAULTS = (RuntimeError, OSError)


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 25
    keep_ckpts: int = 3
    # straggler watchdog: a step slower than ema * factor is "straggling"
    straggler_factor: float = 3.0
    straggler_patience: int = 3
    max_step_retries: int = 2
    log_every: int = 10


@dataclass
class StepRecord:
    step: int
    loss: float
    wall_s: float
    straggler: bool = False
    retried: int = 0


@dataclass
class RunRecord:
    """What a Trainer's run leaves behind, without its tensors (it
    crosses processes)."""
    history: List[StepRecord]
    straggler_events: List[int]


def state_to_jax(acfg: ArchConfig, params, opt) -> tuple:
    """(params, opt) in the reference's layout, as numpy: the tree the
    trainer checkpoints, with the leaf names the reference's trainer
    gives its own ``(params, opt)``."""
    period = acfg.model.pattern_period
    return (to_jax_params(params, period=period),
            O.state_to_reference(opt, period=period))


def state_from_jax(acfg: ArchConfig, tree, device) -> tuple:
    """The inverse of ``state_to_jax``: tensors on ``device``."""
    params, opt = tree
    return (from_jax_params(params, device=device),
            O.state_from_reference(acfg.train, opt, device=device))


class Trainer:
    def __init__(self, acfg: ArchConfig, shape: ShapeSpec,
                 tcfg: Optional[TrainerConfig] = None,
                 dcfg: Optional[DataConfig] = None,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 *, device="cuda", ctx: ParallelCtx = NO_MESH):
        """fault_hook(step): test-injection point — raises to simulate a
        node failure at a given step. ``device``: where params, opt state
        and batches live. ``ctx``: the parallel context (a mesh of the
        ranks that run this trainer alike, or ``NO_MESH``)."""
        self.acfg, self.shape = acfg, shape
        # None -> a fresh instance per Trainer. A dataclass-instance
        # default (``tcfg=TrainerConfig()``) is evaluated once at class
        # definition, so every Trainer would share — and mutate — the
        # same config object.
        self.tcfg = TrainerConfig() if tcfg is None else tcfg
        self.dcfg = DataConfig() if dcfg is None else dcfg
        self.fault_hook = fault_hook
        self.device = torch.device(device)
        self.ctx = ctx
        # checkpoint `extra` metadata restored by resume_or_init; saved
        # back with every checkpoint so a resume->save cycle preserves
        # whatever the launcher recorded (run id, data cursor, ...)
        self.resume_extra: Dict[str, Any] = {}
        self.step_fn = steps_lib.make_train_step(acfg, ctx)
        self.history: List[StepRecord] = []
        self.straggler_events: List[int] = []
        self._ema: Optional[float] = None

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        """Fresh params drawn on the device from ``seed`` (a
        ``torch.Generator``: not the reference's ``jax.random`` draw),
        fresh optimizer state, step 0. Over a mesh each rank draws the
        same whole parameters and keeps its shards."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = M.init_params(self.acfg, device=self.device, generator=gen)
        params = M.distribute_params(self.ctx, self.acfg, params)
        opt = O.init_opt_state(self.acfg.train, params,
                               period=self.acfg.model.pattern_period)
        return params, opt, 0

    def restore_target(self):
        """The checkpoint's restore target: the state's leaf names, shapes
        and dtypes, drawn on the meta device (no data, no memory)."""
        params = M.init_params(self.acfg, device="meta", generator=None)
        opt = O.init_opt_state(self.acfg.train, params,
                               period=self.acfg.model.pattern_period)
        return state_to_jax(self.acfg, params, opt)

    def save(self, step: int, params, opt) -> None:
        ckpt_lib.save(self.tcfg.ckpt_dir, step,
                      state_to_jax(self.acfg, params, opt),
                      extra=self.resume_extra)

    def resume_or_init(self, seed: int = 0):
        d = self.tcfg.ckpt_dir
        if d:
            last = ckpt_lib.latest_step(d)
            if last is not None:
                tree, extra = ckpt_lib.restore(d, last,
                                               self.restore_target())
                params, opt = state_from_jax(self.acfg, tree, self.device)
                params = M.distribute_params(self.ctx, self.acfg, params)
                opt = O.place_state(self.acfg.train, opt, params,
                                    period=self.acfg.model.pattern_period)
                self.resume_extra = dict(extra or {})
                log.info("resumed from step %d", last)
                return params, opt, last
        return self.init_state(seed)

    # ------------------------------------------------------------------
    def _one_step(self, params, opt, step: int):
        batch = device_batch(host_batch(self.acfg, self.shape, step,
                                        self.dcfg), self.device, self.ctx)
        # the hook simulates in-step behaviour (failure OR slowness), so it
        # must run inside the timed window or stragglers are invisible
        t0 = time.perf_counter()
        if self.fault_hook is not None:
            self.fault_hook(step)
        params, opt, metrics = self.step_fn(params, opt, batch)
        loss = float(metrics["loss"])      # waits for the step's work
        wall = self._agreed(time.perf_counter() - t0)
        return params, opt, loss, wall

    def _agreed(self, wall: float) -> float:
        """The slowest rank's wall time (this one's without a mesh)."""
        if self.ctx.mesh is None:
            return wall
        t = torch.tensor([wall], dtype=torch.float64,
                         device=self.ctx.mesh.device_type)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def train(self, params=None, opt=None, start_step: Optional[int] = None,
              seed: int = 0):
        if params is None:
            params, opt, start_step = self.resume_or_init(seed)
        step = start_step or 0
        slow_streak = 0
        while step < self.tcfg.total_steps:
            retries = 0
            while True:
                try:
                    params_n, opt_n, loss, wall = self._one_step(
                        params, opt, step)
                    break
                except STEP_FAULTS as e:    # node-failure boundary
                    retries += 1
                    log.warning("step %d failed (%s); retry %d", step, e,
                                retries)
                    if retries > self.tcfg.max_step_retries:
                        # unrecoverable in-process: restart from last ckpt
                        if self.tcfg.ckpt_dir and \
                                ckpt_lib.latest_step(self.tcfg.ckpt_dir) \
                                is not None:
                            params, opt, step = self.resume_or_init(seed)
                            retries = 0
                            continue
                        raise
            params, opt = params_n, opt_n

            # straggler watchdog
            straggler = False
            if self._ema is not None and \
                    wall > self._ema * self.tcfg.straggler_factor:
                straggler = True
                slow_streak += 1
                self.straggler_events.append(step)
                if slow_streak >= self.tcfg.straggler_patience:
                    log.warning(
                        "straggling %d consecutive steps at step %d — "
                        "checkpointing for preemptive migration",
                        slow_streak, step)
                    if self.tcfg.ckpt_dir:
                        self.save(step + 1, params, opt)
                    slow_streak = 0
            else:
                slow_streak = 0
            if self._ema is None:
                # seed the EMA from the SECOND step: the first includes
                # the kernels' build and would mask real stragglers
                if self.history:
                    self._ema = wall
            else:
                self._ema = 0.9 * self._ema + 0.1 * wall

            self.history.append(StepRecord(step, loss, wall, straggler,
                                           retries))
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.1f ms)", step, loss,
                         wall * 1e3)
            step += 1
            if self.tcfg.ckpt_dir and step % self.tcfg.ckpt_every == 0:
                self.save(step, params, opt)
                ckpt_lib.prune(self.tcfg.ckpt_dir, self.tcfg.keep_ckpts)
        if self.tcfg.ckpt_dir:
            self.save(step, params, opt)
        return params, opt


def train_on_mesh(acfg: ArchConfig, shape: ShapeSpec, tcfg: TrainerConfig,
                  dcfg: DataConfig, mesh_shape, device: str = "cpu",
                  seed: int = 0) -> RunRecord:
    """One rank's Trainer run over a (data, model) mesh of
    ``mesh_shape`` on the process group already started (what each rank
    of ``launch.mesh.spawn`` runs, or one process after
    ``launch.mesh.init_single``)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import make_ctx
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device=device)
    tr = Trainer(acfg, shape, tcfg, dcfg, device=device,
                 ctx=make_ctx(acfg, mesh))
    tr.train(seed=seed)
    return RunRecord(tr.history, tr.straggler_events)
