"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs its driver, reads the per-layer metrics, decides ``correct`` and
prints the result line.

Layout, every piece found by name:

  configs/<config>.json    sizes of a configuration (and what was cut)
  mixes/<traffic>.json     a traffic mix: its ``kind`` and parameters
  cells/<workload>.json    a cell's own parameters (its rate)
  drivers/<kind>.py        ``run(h) -> Outcome`` for one kind of mix
  metrics/<metric>.py      ``read(records) -> float or None``
  reference/               the plain references
  yardstick/               frozen arithmetic (peaks, generators, bounds)
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Check:
    """One number compared, with its limit: ``value <= limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the units of work due and failed, the
    end-to-end metrics it took, the records the per-layer readers read,
    lines to print, ``release`` (frees the program's state) and
    ``verify`` (runs the reference, returns the numbers compared) and
    ``control`` (the same numbers with the reference, in the precision
    below the configuration's, put in the program's place; only
    ``control.py`` calls it)."""
    attempted: int
    failed: int
    metrics: Dict[str, float]
    records: Dict = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    release: Callable[[], None] = lambda: None
    verify: Callable[[], List[Check]] = lambda: []
    control: Callable[..., List[Check]] = lambda variant="fp8": []


class Harness:
    """One run of one cell: everything a driver reads."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, *, device: str = "cuda",
                 t_start: Optional[float] = None,
                 data_dir: Optional[Path] = None):
        """``data_dir`` holds ``BENCHMARK.json`` and the data folders
        (configs, mixes, cells); by default the repository's. Code
        (drivers, metrics, references) always comes from this folder."""
        self.dir = HERE
        data = data_dir or HERE
        self.bench = load_json(data / "BENCHMARK.json" if data_dir
                               else HERE.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; the "
                             f"benchmark has {sorted(cells)}")
        self.cell = cells[workload]
        self.config = load_json(data / "configs"
                                / f"{self.cell['config']}.json")
        self.mix = load_json(data / "mixes" / f"{self.cell['traffic']}.json")
        cell_file = data / "cells" / f"{workload}.json"
        self.params = load_json(cell_file) if cell_file.exists() else {}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start if t_start is not None else \
            time.perf_counter()

    def log(self, msg: str) -> None:
        print(f"[{self.cell['name']}] {msg}", file=sys.stderr, flush=True)

    def arch_config(self, *, train: bool = False):
        """The port's ``ArchConfig`` of this cell's configuration file:
        the registry's entry with every size the file states."""
        from repro_torch.configs import get_config
        cfg = self.config
        a = get_config(cfg["arch"])
        m = a.model
        kw = dict(num_layers=cfg["num_hidden_layers"],
                  d_model=cfg["hidden_size"],
                  d_ff=cfg["intermediate_size"],
                  vocab_size=cfg["vocab_size"])
        if cfg["family"] == "rwkv6":
            kw["ssm"] = dataclasses.replace(m.ssm,
                                            head_size=cfg["head_size"])
        else:
            kw["attention"] = dataclasses.replace(
                m.attention, n_heads=cfg["num_attention_heads"],
                n_kv_heads=cfg["num_key_value_heads"],
                d_head=cfg["head_dim"],
                sliding_window=cfg["sliding_window"],
                rope_theta=cfg["rope_theta"])
            if cfg.get("num_local_experts"):
                kw["moe"] = dataclasses.replace(
                    m.moe, num_experts=cfg["num_local_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    d_ff_expert=cfg["intermediate_size"],
                    capacity_factor=cfg["capacity_factor"],
                    aux_loss_weight=cfg.get("router_aux_loss_coef",
                                            m.moe.aux_loss_weight))
        on_card = self.device == "cuda"
        t = dataclasses.replace(
            a.train, compute_dtype=cfg["torch_dtype"],
            param_dtype="float32" if train else cfg["torch_dtype"],
            use_flash_kernel=on_card,
            use_rwkv_kernel=on_card and not train)
        if train:
            tc = cfg["train"]
            t = dataclasses.replace(
                t, optimizer=tc["optimizer"],
                learning_rate=tc["learning_rate"],
                warmup_steps=tc["warmup_steps"],
                weight_decay=tc["weight_decay"], beta1=tc["beta1"],
                beta2=tc["beta2"], eps=tc["eps"], grad_clip=tc["grad_clip"],
                remat=tc["remat"], remat_policy=tc["remat_policy"],
                param_dtype=tc["master_dtype"], grad_compression=None)
        return a.replace(model=dataclasses.replace(m, **kw), train=t)

    # metrics ----------------------------------------------------------
    def _applies(self, metric: Dict) -> bool:
        name = self.cell["name"]
        if "workloads" in metric:
            return name in metric["workloads"]
        moved = next(m for m in self.bench["end_to_end"]
                     if m["name"] == metric.get("moves", metric["name"]))
        return "workloads" not in moved or name in moved["workloads"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if self._applies(m)]


def setup_env() -> None:
    """Build and kernel caches at fixed paths under the checkout's
    ``build/`` (set before torch is imported), no JAX behind any
    library's back, and one CPU thread for torch's host-side operations:
    the serving cells' pace is the host's, and a pool of threads spinning
    beside the launching thread on a shared host only adds noise."""
    import os
    build = HERE.parent / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_info() -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(h: Harness, control=()
             ) -> Tuple[Dict, List[Check], List[str]]:
    """Runs the cell's driver and everything after the window: per-layer
    readers, the memory peak, the program's release, the reference (and
    the control in each variant that ``control`` names, under
    ``result["control"][variant]``).
    Returns (result line, checks, notes)."""
    import torch
    driver = load_module(h.dir / "drivers" / f"{h.mix['kind']}.py",
                         f"portbench_driver_{h.mix['kind']}")
    out: Outcome = driver.run(h)
    on_card = h.device == "cuda"
    result = {"correct": False, "attempted": out.attempted,
              "failed": out.failed, "metrics": {}, "device": {}}
    if h.trace:
        for m in h.per_layer():
            reader = load_module(h.dir / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_"
                                 + m["name"].replace(".", "_"))
            v = reader.read(out.records)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        tr = out.records.get("trace")
        if tr is not None and tr.bounds is not None:
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
    else:
        for m in h.end_to_end():
            v = out.metrics.get(m["name"])
            if v is None:
                raise RuntimeError(f"the driver took no {m['name']}")
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    if on_card:
        dev = card_info()
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        tr = out.records.get("trace")
        if h.trace and tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
        result["device"] = dev
    out.records.clear()
    out.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = out.verify()
    result["correct"] = bool(checks) and all(c.ok for c in checks) \
        and all(math.isfinite(c.value) for c in checks)
    if control:
        result["control"] = {}
    for v in control:
        gc.collect()
        result["control"][v] = {c.name: {"value": c.value, "limit": c.limit}
                                for c in out.control(v)}
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                          for c in checks}
    return result, checks, out.notes


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    setup_env()
    h = Harness(args.workload, args.seed, args.seconds, bool(args.trace),
                t_start=t_start)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < h.cell["chips"]:
        print(f"{h.cell['name']}: needs {h.cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h.log(f"card {power_limit()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; peaks 989 TFLOP/s bf16, 3.35 TB/s")
    result, checks, notes = run_cell(h)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark may load none "
              f"of {list(FORBIDDEN)}", file=sys.stderr)
        return 3
    for line in notes:
        h.log(line)
    for c in checks:
        print(f"compared {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
