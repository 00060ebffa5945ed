"""Training launcher, on one device or over a mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      [--shape train_4k] [--reduced] [--steps N] [--seq-len S] \
      [--global-batch B] [--ckpt-dir DIR] [--ckpt-every K] [--ps-mode] \
      [--mesh dxm|production] [--grad-compression bf16|int8] [--seed N] \
      [--device cuda|cpu]

  # a 2 x 2 mesh over four CPU processes (gloo)
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch qwen3-8b --reduced --device cpu --mesh 2x2 --steps 2 \
      --seq-len 32 --global-batch 4

The model trains on ``--device cuda`` (the default; no card is an
error, exit 2): attention's forward runs in the hand-written flash
kernel, also when remat recomputes it in the backward. The WKV kernel
stays off, because it has no backward (the reference's defines no VJP
either), so RWKV-6 trains through the plain chunked scan, as the
reference does. ``--device cpu`` runs every plain PyTorch version.

``--mesh dxm`` lays the ranks out as (data, model) and trains over that
mesh (``production``: the reference's (16, 16)); the world comes from
``torchrun``'s environment, or is this one process (``--mesh 1x1``, no
``torchrun``). Ranks join under gloo with ``--device cpu`` and NCCL on
``cuda``, one card each. A mesh whose size is not the world's exits 2.
``--ps-mode`` sets ``fsdp`` / ``ps_mode`` as the reference does: over a
mesh the weights are then sharded over the data axis and gathered at
use; without a mesh it changes nothing, exactly as in the reference.
Every rank prints the same lines. The full shapes are large
(``train_4k``: 256 x 4096 tokens); on one card pass ``--global-batch``
and ``--seq-len``, or ``--reduced`` for the same family at small dims.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config, get_reduced_config, get_shape
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.parallel.sharding import make_ctx
from repro_torch.train.trainer import Trainer, TrainerConfig


def train_config(arch: str, *, reduced: bool, device: str,
                 ps_mode: bool = False,
                 grad_compression: Optional[str] = None) -> ArchConfig:
    """The config as the CLI trains it: on ``cuda`` the flash kernel is
    on (``use_flash_kernel``; the reference config leaves it off only
    because Pallas TPU kernels do not lower on a CPU) and the WKV kernel
    off (``use_rwkv_kernel``: no backward)."""
    acfg = get_reduced_config(arch) if reduced else get_config(arch)
    if ps_mode:
        acfg = acfg.replace(parallel=dataclasses.replace(
            acfg.parallel, fsdp=True, ps_mode=True))
    train = dataclasses.replace(acfg.train,
                                use_flash_kernel=(device == "cuda"),
                                use_rwkv_kernel=False)
    if grad_compression:
        train = dataclasses.replace(train, grad_compression=grad_compression)
    return acfg.replace(train=train)


def main(argv: Optional[List[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 (data x model) over the torchrun "
                         "ranks; 'production' for (16,16)")
    ap.add_argument("--ps-mode", action="store_true",
                    help="parameter-server (ZeRO-3/fsdp) weight sharding; "
                         "without a mesh it changes nothing")
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model trains (default cuda: the GPU, "
                         "with the flash attention kernel)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: no CUDA GPU is visible "
                 "(torch.cuda.is_available() is False); pass --device cpu "
                 "to train on the CPU")
    shape_dm = None
    if args.mesh and args.mesh != "production":
        try:
            shape_dm = tuple(int(x) for x in args.mesh.split("x"))
        except ValueError:
            shape_dm = ()
        if len(shape_dm) != 2 or min(shape_dm) < 1:
            ap.error(f"--mesh {args.mesh}: expected dxm (e.g. 2x2) or "
                     f"'production'")

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    acfg = train_config(args.arch, reduced=args.reduced, device=args.device,
                        ps_mode=args.ps_mode,
                        grad_compression=args.grad_compression)
    shape = get_shape(args.shape)
    if args.seq_len or args.global_batch:
        shape = dataclasses.replace(
            shape, seq_len=args.seq_len or shape.seq_len,
            global_batch=args.global_batch or shape.global_batch)

    mesh, started = None, False
    if args.mesh:
        started = mesh_lib.init_from_env(args.device)
        try:
            mesh = (mesh_lib.make_production_mesh(device=args.device)
                    if shape_dm is None else
                    mesh_lib.make_mesh(shape_dm, ("data", "model"),
                                       device=args.device))
        except ValueError as e:
            if started:
                torch.distributed.destroy_process_group()
            ap.error(f"--mesh {args.mesh}: {e}")
    ctx = make_ctx(acfg, mesh)

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every)
    trainer = Trainer(acfg, shape, tcfg, DataConfig(), device=args.device,
                      ctx=ctx)
    try:
        trainer.train(seed=args.seed)
    finally:
        if started:
            torch.distributed.destroy_process_group()
    losses = [r.loss for r in trainer.history]
    if not losses:      # resumed from a checkpoint at or past --steps
        print(f"nothing to train: resumed at step "
              f"{ckpt_lib.latest_step(args.ckpt_dir)}, --steps {args.steps}")
        return trainer
    print(f"done: {len(trainer.history)} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"stragglers={len(trainer.straggler_events)}")
    return trainer


if __name__ == "__main__":
    main()
