"""Dry run of the production meshes on one CPU, with no card.

For every (architecture x input shape) cell:

    mesh = make_production_mesh(fake=True)   # 256 / 512 ranks, one process
    with FakeTensorMode():                   # shapes only: no memory
        args = the stand-ins of launch/specs.py, laid out on the mesh
        with Counter(), MemTracker():        # launch/roofline.py
            step(*args)                      # make_{train,prefill,decode}_step

on the single-pod (16,16)=(data,model) mesh or, with ``--multi-pod``,
the 2-pod (2,16,16)=(pod,data,model) one; this process is rank 0 and
its collectives move nothing. ``--roofline`` adds the per-segment
roofline (``launch/roofline.py``) on the single-pod mesh. Results are
cached as JSON under results/dryrun_torch/.

The result keeps the reference's keys where they apply:
``cost_analysis`` (``flops`` and ``bytes accessed`` of the whole step,
per device, as ``roofline.Counter`` counts them: eager, unfused bytes),
``collectives`` (the reference's ``collectives_full_hlo``: the
``CollectiveStats.summary()`` of the c10d ops the step ran),
``analytic_bytes_per_device`` and ``memory_analysis``: the peak of
what ``MemTracker`` saw this rank hold on the stand-ins' device (the
arguments and everything the step made there), its bytes by kind, and
under ``other_devices`` anything the tracker saw elsewhere (``meta``),
which no total counts, as XLA's count holds device buffers only. The
reference's ``while_trip_counts`` and ``overlap`` have
no counterpart: Python runs every loop trip itself, so there is no
``while`` to count, and eager collectives are calls in program order,
with no asynchronous start / done pairs in a schedule to read. Its
``lower_s`` and ``compile_s`` become ``run_s``.

A step with a data-dependent shape (``.item()``, ``nonzero``) cannot run
on fake tensors, as the reference's ``eval_shape`` cannot trace one: the
port's steps keep static shapes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k [--multi-pod] [--roofline] [--force]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  (--out-dir DIR writes the JSON there instead)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --override train.remat=false --variant noremat
  (each --override sets one ``section.field`` of the config, its value
  read as JSON where it parses and as a string where not; the cell's
  file gains ``__{variant}``)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import cells, get_config, get_shape
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import optimizer as O
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import ParallelCtx, make_ctx

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def _cell_path(arch: str, shape: str, mesh_name: str, variant: str = "",
               out_dir: str = RESULTS_DIR) -> str:
    v = f"__{variant}" if variant else ""
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}{v}.json")


def _tree_bytes(ctx: ParallelCtx, tree, logical) -> float:
    """Bytes per device of a tree of stand-ins laid out by its logical
    axes: each leaf's bytes over the product of the mesh dims that shard
    it (a KV cache's position, a host int or a 0-d tensor, counts as the
    reference's int32)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(ctx, v, logical[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(ctx, v, a) for v, a in zip(tree, logical))
    if isinstance(tree, int) or tree.dim() == 0:
        return 4.0
    div = 1
    for ax in ctx.spec(*logical):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            div *= ctx.size(a)
    return float(tree.numel() * tree.element_size()) / div


def _analytic_bytes_per_device(ctx: ParallelCtx, acfg: ArchConfig,
                               shape: ShapeSpec) -> Dict[str, float]:
    """Sharded resident bytes/device: params + optimizer + decode state
    (the reference's estimate: the optimizer as a multiple of the
    parameters)."""
    out = {"params": _tree_bytes(ctx, specs_lib.param_specs(acfg),
                                 M.param_logical_axes(acfg))}
    if shape.kind == "train":
        # m/v mirror params (adamw) or factored (adafactor ~= params/64)
        mult = {"adamw": 2.0, "adafactor": 0.05, "sgd": 1.0}[
            acfg.train.optimizer]
        out["optimizer"] = out["params"] * mult
    if shape.kind == "decode":
        out["decode_state"] = _tree_bytes(
            ctx, specs_lib.state_specs(ctx, acfg, shape),
            M.state_logical_axes(acfg, shape.global_batch, ctx))
    out["total"] = sum(out.values())
    return out


def lay_out(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec):
    """The step's arguments, from ``specs.input_specs``' stand-ins, as
    the trainer and the serve engine lay them out: the parameters on
    ``param_logical_axes``, the optimizer state built from them, the
    states on ``state_logical_axes``, the batch's rows over the batch
    axes. On the CPU: fake tensors under an active ``FakeTensorMode``."""
    device = "cpu"
    args = specs_lib.input_specs(ctx, acfg, shape)
    params = M.distribute_params(ctx, acfg,
                                 specs_lib.materialize(args[0], device))

    def batch(b):
        b = specs_lib.materialize(b, device)
        if ctx.mesh is None:
            return b
        return {k: sh.place(v, ctx.mesh, pl) for (k, v), pl in
                zip(b.items(), steps_lib.batch_shardings(ctx, b).values())}
    if shape.kind == "train":
        opt = O.init_opt_state(acfg.train, params,
                               period=acfg.model.pattern_period)
        return params, opt, batch(args[2])
    if shape.kind == "prefill":
        return params, batch(args[1])
    b = batch({k: v for k, v in (("tokens", args[2]), ("embeds", args[3]))
               if v is not None})
    states = M.init_states(acfg, shape.global_batch, shape.seq_len,
                           device=device, ctx=ctx)
    return params, states, b.get("tokens"), b.get("embeds")


def make_step(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec):
    if shape.kind == "train":
        return steps_lib.make_train_step(acfg, ctx)
    if shape.kind == "prefill":
        return steps_lib.make_prefill_step(acfg, ctx=ctx)
    return steps_lib.make_decode_step(acfg, shape.global_batch, ctx=ctx)


def _locals(tree):
    return [t._local_tensor if isinstance(t, sh.DTensor) else t
            for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def dry_run(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec,
            tracker=None) -> Dict[str, Any]:
    """One cell on ``ctx``'s mesh (a fake group's, or none): its step on
    fake stand-ins under the counters. Returns ``cost_analysis``,
    ``collectives``, ``memory_analysis`` and ``run_s``. The kernels stay
    off (no dispatch mode sees a ``ctypes`` launch). ``tracker`` is the
    ``MemTracker`` to count with (a new one by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    acfg = acfg.replace(train=dataclasses.replace(
        acfg.train, use_flash_kernel=False, use_rwkv_kernel=False))
    out: Dict[str, Any] = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = lay_out(ctx, acfg, shape)
        step = make_step(ctx, acfg, shape)
        mt = MemTracker() if tracker is None else tracker
        arg_locals = _locals(args)
        mt.track_external(*arg_locals)
        t0 = time.time()
        with mt:
            _, cost = roof_lib.count(ctx, "step", step, *args)
        out["run_s"] = time.time() - t0
        peak = mt.get_tracker_snapshot("peak")
    out["cost_analysis"] = {"flops": cost.flops,
                            "bytes accessed": cost.bytes_accessed}
    out["collectives"] = cost.collectives.summary()
    out["memory_analysis"] = memory_analysis(peak, arg_locals)
    return out


def _kinds(snapshot) -> Dict[str, int]:
    return {getattr(k, "name", k): int(v) for k, v in snapshot.items()
            if k != "Total"}


def memory_analysis(peak, arg_locals) -> Dict[str, Any]:
    """The reference's ``memory_analysis`` keys from ``MemTracker``'s
    peak snapshot: the peak of the device the stand-ins live on, its
    bytes by kind (``PARAM``, ``ACT``, ``TEMP``, ``OPT``, ...), and the
    argument bytes. Any other device the tracker saw (a ``meta`` tensor
    made for its metadata) is listed under ``other_devices`` and counted
    in no total: XLA's count has device buffers only."""
    device = arg_locals[0].device
    mine = peak.get(device, {"Total": 0})
    return {
        "available": True,
        "peak_memory_in_bytes": int(mine["Total"]),
        "argument_size_in_bytes": int(sum(
            t.numel() * t.element_size() for t in arg_locals)),
        "by_kind": _kinds(mine),
        "other_devices": {str(d): dict(_kinds(s), Total=int(s["Total"]))
                          for d, s in peak.items() if d != device}}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             do_roofline: bool = False, force: bool = False,
             overrides: Optional[Dict] = None, variant: str = "",
             out_dir: str = RESULTS_DIR) -> Dict[str, Any]:
    """One cell's result, cached as JSON. ``overrides`` (see
    ``_apply_overrides``) change the config, and ``variant`` names the
    changed cell: its file gains ``__{variant}``."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    path = _cell_path(arch, shape_name, mesh_name, variant, out_dir)
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    acfg = get_config(arch)
    if overrides:
        acfg = _apply_overrides(acfg, overrides)
    shape = get_shape(shape_name)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "ok": False,
    }
    skips = dict(acfg.skip_reasons)
    if shape_name not in acfg.shapes:
        result["skipped"] = skips.get(shape_name, "unsupported")
        _save(path, result)
        return result

    t_start = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        ctx = make_ctx(acfg, mesh)
        res = dry_run(ctx, acfg, shape)
        ca = res["cost_analysis"]
        print(f"[{arch} x {shape_name} x {mesh_name}] memory_analysis: "
              f"peak {res['memory_analysis']['peak_memory_in_bytes']} B")
        print(f"[{arch} x {shape_name} x {mesh_name}] cost_analysis: "
              f"flops={ca['flops']} bytes={ca['bytes accessed']}")
        result.update(res)
        result["analytic_bytes_per_device"] = \
            _analytic_bytes_per_device(ctx, acfg, shape)
        if do_roofline and not multi_pod:
            result["roofline"] = roofline(ctx, acfg, shape,
                                          mesh_name).to_dict()
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 - a failed cell is a result
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["total_s"] = time.time() - t_start
    _save(path, result)
    return result


def _apply_overrides(acfg: ArchConfig, overrides: Dict) -> ArchConfig:
    """Hillclimb knobs: {'parallel.fsdp': True, 'train.remat': False, ...}"""
    for k, v in overrides.items():
        section, field_ = k.split(".", 1)
        sub = getattr(acfg, section)
        acfg = acfg.replace(**{section: dataclasses.replace(sub,
                                                            **{field_: v})})
    return acfg


def roofline(ctx: ParallelCtx, acfg: ArchConfig, shape: ShapeSpec,
             mesh_name: str) -> roof_lib.Roofline:
    """The per-segment roofline of a cell, counted on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    acfg = acfg.replace(train=dataclasses.replace(
        acfg.train, use_flash_kernel=False, use_rwkv_kernel=False))
    with FakeTensorMode(allow_non_fake_inputs=True):
        segs = roof_lib.segment_costs(ctx, acfg, shape)
    return roof_lib.build_roofline(ctx, acfg, shape, mesh_name, segs)


def _save(path: str, result: Dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=1, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR,
                    help="where the cells' JSON goes (default: "
                         "results/dryrun_torch/ at the repo's root)")
    ap.add_argument("--override", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="set one config field (VALUE as JSON, else a "
                         "string); repeatable")
    ap.add_argument("--variant", default="",
                    help="the changed cell's name: its file gains "
                         "__VARIANT")
    args = ap.parse_args(argv)
    overrides = {}
    for item in args.override:
        key, sep, value = item.partition("=")
        if not sep or "." not in key:
            ap.error(f"--override {item!r}: want SECTION.FIELD=VALUE")
        try:
            overrides[key] = json.loads(value)
        except ValueError:
            overrides[key] = value
    # DTensor warns at every redistribute that sums over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    todo = []
    if args.all:
        for arch, shape, skip in cells(include_skipped=True):
            if skip is None:
                todo.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo.append((args.arch, args.shape))

    n_fail = 0
    for arch, shape in todo:
        r = run_cell(arch, shape, multi_pod=args.multi_pod,
                     do_roofline=args.roofline, force=args.force,
                     overrides=overrides, variant=args.variant,
                     out_dir=args.out_dir)
        status = "SKIP" if "skipped" in r else ("OK" if r["ok"] else "FAIL")
        print(f"{status}: {arch} x {shape} (run {r.get('run_s', 0):.1f}s)")
        if status == "FAIL":
            n_fail += 1
            print(r.get("error"))
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
