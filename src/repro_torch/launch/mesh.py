"""Mesh construction over ``torch.distributed``. Every function here
builds on a process group the caller started (``torchrun``,
``init_single`` or ``spawn``); importing this module touches no
process-group state.

``spawn`` is the counterpart of the reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``): it runs a
function on ``n`` CPU processes joined under gloo, so a 2 x 2 mesh runs
on a machine with no accelerator. One H100 runs a 1 x 1 mesh through
``init_single`` (NCCL, world size 1, no ``torchrun``). ``init_fake``
lets one process stand for every rank of the production meshes (256 or
512) for a dry run: a process group on the ``fake`` backend, whose
collectives return at once and move nothing. A process runs one kind of
group: one that started NCCL or gloo cannot also start a fake one.
"""
from __future__ import annotations

import logging
import os
import pickle
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 0


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: str = "cpu") -> DeviceMesh:
    """A mesh of ``shape`` with named dims ``axes`` over every rank of
    the started process group (``device``: "cpu" for gloo ranks, "cuda"
    for NCCL ranks, one card each)."""
    n = 1
    for s in shape:
        n *= s
    if _world() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the process "
                         f"group has {_world()}")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda",
                         fake: bool = False) -> DeviceMesh:
    """Single pod: (16,16)=(data,model) = 256 ranks. Multi-pod:
    (2,16,16)=(pod,data,model) = 512 ranks. With ``fake`` this process
    stands for all of them (``init_fake``; a CPU mesh, for dry runs)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if fake:
        init_fake(512 if multi_pod else 256)
        device = "cpu"
    return make_mesh(shape, axes, device=device)


def init_fake(world_size: int) -> None:
    """A process group of ``world_size`` ranks on the ``fake`` backend in
    this one process (rank 0): every collective returns at once without
    moving data, so with fake tensors a step of any mesh runs shapes
    only. Kept when one of that size is up, replaced when a fake group
    of another size is; a group of another backend raises."""
    if dist.is_initialized():
        if dist.get_backend() == "fake":
            if _world() == world_size:
                return
            dist.destroy_process_group()
        else:
            raise RuntimeError(
                f"init_fake: this process already runs a "
                f"{dist.get_backend()} group of {_world()} ranks; a fake "
                f"group of {world_size} needs a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_test_mesh(data: int = 2, model: int = 2,
                   pod: Optional[int] = None, *, device: str = "cpu",
                   fake: bool = False) -> DeviceMesh:
    """Small mesh over however many ranks ``spawn`` started (with
    ``fake``, over a fake group of its size in this process)."""
    if fake:
        init_fake(data * model * (pod or 1))
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device=device)
    return make_mesh((data, model), ("data", "model"), device=device)


def init_single(device: str = "cuda") -> None:
    """A process group of world size 1 in this process (NCCL on the
    card, gloo on the CPU), for a 1 x 1 mesh without ``torchrun``."""
    if dist.is_initialized():
        return
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def init_from_env(device: str) -> bool:
    """The process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``...), or ``init_single``
    without it. Returns whether it started one (False when a group was
    already up)."""
    if dist.is_initialized():
        return False
    if "WORLD_SIZE" not in os.environ:
        init_single(device)
        return True
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device == "cuda" else "gloo")
    return True


def _child(rank: int, fn: Callable, n: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    # DTensor warns at every redistribute that sums over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), n),
        rank=rank, world_size=n)
    try:
        out = fn(*args)
        with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, *args, timeout: float = 300.0) -> List:
    """``fn(*args)`` on ``n`` spawned CPU processes joined under gloo
    (through a ``FileStore`` in a temporary directory, so runs in
    parallel cannot collide on a port); one torch thread each. ``fn``
    must be importable by name. Returns each rank's result, in rank
    order; a child's exception is raised here, and a run past
    ``timeout`` seconds is killed with ``TimeoutError``."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_spawn_") as tmp:
        pc = mp.start_processes(_child, args=(fn, n, tmp, args), nprocs=n,
                                join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not pc.join(timeout=0.5):
            if time.monotonic() > deadline:
                for p in pc.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"spawn: {n} ranks ran past {timeout} s")
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
