#!/usr/bin/env python3
"""Names the tensors that make up a dry-run cell's peak memory, on the
CPU, with no card:

    PYTHONPATH=src python tools/trace_dryrun_peak.py --arch kimi-k2-1t-a32b \\
        --shape train_4k [--multi-pod] [--layers N] [--top 30] [--json OUT]

It runs the cell twice as ``launch/dryrun.py`` runs it (fake tensors on
the fake production mesh, ``MemTracker``): once for the peak of the
stand-ins' device, then again under a tracker that notes, for every
storage it sees made, the op, shape and dtype of the tensor and the
innermost ``repro_torch`` frame that made it, and lists what is live the
first time the device holds the peak again. Rows are grouped by (kind,
where, op, shape, dtype) and printed largest first with their share of
the peak; the rows sum to the peak. ``--layers`` cuts the depth (the
whole model by default)."""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from collections import defaultdict

from torch.distributed._tools.common_utils import get_untyped_storages
from torch.distributed._tools.mem_tracker import MemTracker

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.sharding import make_ctx

PKG = os.sep + "repro_torch" + os.sep


def _where() -> str:
    """The innermost frame of the port that is running, past the
    dispatch modes' own (the counter's)."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if PKG in path and f.f_code.co_name != "__torch_dispatch__":
            rel = path.split(PKG, 1)[1]
            return f"{rel}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return "?"


class PeakTrace(MemTracker):
    """``MemTracker`` that keeps where each storage came from and lists
    the live storages of ``device`` the first time its total reaches
    ``target``."""

    def __init__(self, device, target: int):
        super().__init__()
        self.device, self.target = device, target
        self.live = None
        self._op = "?"

    def track_external(self, *external):
        super().track_external(*external)
        for t in external:
            self._note(t, "argument")

    def _note(self, t, op):
        for st in get_untyped_storages(t):
            winfo, _ = self._WINFO.get(st, (None, None))
            if winfo is not None and not hasattr(winfo, "origin"):
                winfo.origin = (op, _where() if op != "argument" else "-",
                                tuple(t.shape), str(t.dtype))

    def _track(self, reftype, t):
        super()._track(reftype, t)
        self._note(t, self._op)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = str(func)
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _update_peak_stats(self, peak_state):
        super()._update_peak_stats(peak_state)
        snap = self._curr_mem_snap.get(self.device)
        if self.live is None and snap and snap["Total"] >= self.target:
            self.live = [(winfo.reftype.name,) + getattr(
                winfo, "origin", ("?", "?", (), "?")) + (winfo.mem_consumed,)
                for winfo, _ in self._WINFO.values()
                if winfo.device == self.device and winfo.mem_consumed > 0]


def trace(arch: str, shape_name: str, *, multi_pod: bool = False,
          layers: int = 0):
    acfg = get_config(arch)
    if layers:
        acfg = acfg.replace(model=dataclasses.replace(
            acfg.model, num_layers=layers))
    shape = get_shape(shape_name)
    ctx = make_ctx(acfg, make_production_mesh(multi_pod=multi_pod,
                                              fake=True))
    first = D.dry_run(ctx, acfg, shape)["memory_analysis"]
    peak = first["peak_memory_in_bytes"]
    import torch
    pt = PeakTrace(torch.device("cpu"), peak)
    again = D.dry_run(ctx, acfg, shape, tracker=pt)["memory_analysis"]
    assert again["peak_memory_in_bytes"] == peak, (again, first)
    assert pt.live is not None
    rows = defaultdict(lambda: [0, 0])
    for kind, op, where, shp, dtype, nbytes in pt.live:
        r = rows[(kind, where, op, shp, dtype)]
        r[0] += 1
        r[1] += nbytes
    rows = sorted(((k, n, b) for k, (n, b) in rows.items()),
                  key=lambda r: -r[2])
    assert sum(b for _, _, b in rows) == peak, (sum(
        b for _, _, b in rows), peak)
    return {"arch": arch, "shape": shape_name, "layers":
            layers or acfg.model.num_layers, "multi_pod": multi_pod,
            "peak_memory_in_bytes": peak, "by_kind": first["by_kind"],
            "rows": [{"kind": k[0], "where": k[1], "op": k[2],
                      "shape": list(k[3]), "dtype": k[4], "count": n,
                      "bytes": b} for k, n, b in rows]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--json", default=None, help="write every row here")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    res = trace(args.arch, args.shape, multi_pod=args.multi_pod,
                layers=args.layers)
    peak = res["peak_memory_in_bytes"]
    print(f"{args.arch} x {args.shape} ({res['layers']} layers): peak "
          f"{peak} B = {peak / 1e9:.2f} GB (CPU dry-run count); by kind "
          f"{res['by_kind']}")
    acc = 0
    for r in res["rows"][:args.top]:
        acc += r["bytes"]
        print(f"{r['bytes'] / 1e9:9.3f} GB {100 * acc / peak:6.2f} % "
              f"{r['kind']:5} {r['count']:5} x {r['dtype']:14} "
              f"{tuple(r['shape'])} {r['op']} @ {r['where']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
