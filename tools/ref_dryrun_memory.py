#!/usr/bin/env python3
"""The JAX reference's own memory count of production cells, for
comparison with the port's dry run (``repro_torch.launch.dryrun``), on
the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_dryrun_memory.py \\
        --arch kimi-k2-1t-a32b --shape train_4k [--layers 1,2] [--multi-pod]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ref_dryrun_memory.py \\
        --all [--multi-pod]

It lowers and compiles the reference's step on 512 forced host devices
as ``repro/launch/dryrun.py:run_cell`` does (the train step with
``donate=False``, the prefill and decode steps, ``specs.input_specs``),
on the production mesh built with ``Auto`` axes (jax 0.9's default
``Explicit`` axes refuse the reference's sharding constraints), at each
depth of ``--layers`` (the config's by default), and prints one JSON
line a cell: XLA's ``memory_analysis`` of the compiled step per device.
XLA's CPU backend leaves its temporaries out of
``peak_memory_in_bytes``, so read ``argument_size_in_bytes`` and
``temp_size_in_bytes``. Only this tool and the tests import both
packages; the port imports no JAX."""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro.launch import dryrun as D      # forces 512 host devices first

import jax
from jax.sharding import AxisType

from repro.configs import cells, get_config, get_shape
from repro.launch import specs as specs_lib
from repro.launch import steps as steps_lib
from repro.parallel.sharding import make_ctx


def compile_cell(mesh, acfg, shape):
    ctx = make_ctx(acfg, mesh)
    with mesh:
        if shape.kind == "train":
            step = steps_lib.make_train_step(ctx, acfg, donate=False)
        elif shape.kind == "prefill":
            step = steps_lib.make_prefill_step(ctx, acfg)
        else:
            step = steps_lib.make_decode_step(ctx, acfg, shape.global_batch)
        return step.lower(*specs_lib.input_specs(ctx, acfg, shape)).compile()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", default="",
                    help="comma-separated depths (default: the config's)")
    args = ap.parse_args(argv)
    if args.all:
        todo = [(a, s) for a, s, skip in cells(include_skipped=True)
                if skip is None]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    shape_axes = ((2, 16, 16), ("pod", "data", "model")) if args.multi_pod \
        else ((16, 16), ("data", "model"))
    mesh = jax.make_mesh(*shape_axes,
                         axis_types=(AxisType.Auto,) * len(shape_axes[0]))
    for arch, shape_name in todo:
        base = get_config(arch)
        depths = [int(n) for n in args.layers.split(",") if n] or \
            [base.model.num_layers]
        for n in depths:
            acfg = base.replace(model=dataclasses.replace(base.model,
                                                          num_layers=n))
            row = {"arch": arch, "shape": shape_name, "mesh":
                   "pod2x16x16" if args.multi_pod else "pod16x16",
                   "layers": n}
            t0 = time.time()
            try:
                ma = D._memory_analysis_dict(
                    compile_cell(mesh, acfg, get_shape(shape_name)))
                ma.pop("repr", None)
                row.update(ma)
            except Exception as e:  # noqa: BLE001 - a failed cell is a row
                row["error"] = f"{type(e).__name__}: {e}"[:500]
            row["compile_s"] = time.time() - t0
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
