"""The benchmark's files: ``BENCHMARK.json`` against its required
shape, every configuration, mix, cell, driver and per-layer metric
found by name, the import check, and the device-trace arithmetic."""
import ast
import json
import re
import subprocess
import sys

import pytest

from conftest import ROOT, SERVE_CELLS

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    assert 2 + 14 * 24 <= 2 + 14 * 24   # the limit is the 24-cell one
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24


def test_names_units_and_text_fields():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("portbench/configs/")
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_piece_is_found_by_name():
    cfgs = {c["name"] for c in BENCH["configs"]}
    used = set()
    for w in BENCH["workloads"]:
        assert w["config"] in cfgs
        used.add(w["config"])
        mix = json.loads((PB / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        assert (PB / "drivers" / f"{mix['kind']}.py").is_file()
        if mix["kind"] != "ps_rounds":     # rate or limits of its own
            assert (PB / "cells" / f"{w['name']}.json").is_file()
    assert used == cfgs
    for m in BENCH["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        n = w["name"]
        mine = [m for m in e2e.values()
                if "workloads" not in m or n in m["workloads"]]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if n in m["workloads"]]
        assert layers
        for m in layers:     # the metric it moves is reported there
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or n in moved["workloads"]


def test_readers_report_nothing_from_empty_records():
    from portbench import harness
    for m in BENCH["per_layer"]:
        mod = harness.load_module(PB / "metrics" / f"{m['name']}.py",
                                  "reader_" + m["name"].replace(".", "_"))
        assert mod.read({"config": {"family": "moe"}, "mix": None}) is None


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_read_no_old_benchmark():
    for path in PB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        assert "benchmarks/" not in path.read_text(), path


def test_a_run_loads_no_jax_by_whole_top_level_name(tiny_dir):
    """Every driver kind run in a fresh process: ``repro_torch`` is
    loaded, and no top-level name equals jax, jaxlib, flax or repro."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import harness
for cell in {list(SERVE_CELLS) + ['tiny-ps', 'tiny-train']!r}:
    h = harness.Harness(cell, 3, 0.5, False, device="cpu",
                        data_dir=Path({str(tiny_dir)!r}))
    r, _, _ = harness.run_cell(h)
    assert r["correct"], r
tops = {{m.split(".")[0] for m in sys.modules}}
assert "repro_torch" in tops
print(sorted(tops & set({sorted(FORBIDDEN)!r})))
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"]


def test_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxish", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         BENCH["workloads"][0]["name"], "--seed", str(2**31 + 7),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_busy_is_the_union_of_intervals():
    from portbench.devtrace import DeviceTrace, busy_seconds, merged
    ivs = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.5),
           ("d", 2.1, 2.2)]
    assert merged(ivs) == [(0.0, 1.5), (2.0, 2.5)]
    assert busy_seconds(ivs) == pytest.approx(2.0)
    tr = DeviceTrace()
    tr.device, tr.bounds = ivs, (0.0, 3.0)
    tr.host = [("aten::mm", 1.4, 1.9), ("outer", 1.0, 3.0)]
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::mm", pytest.approx(0.5)]
    assert gaps[1] == ["outer", pytest.approx(0.5)]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_trace_reads_kernels_on_the_card(card):
    import torch
    from portbench.devtrace import DeviceTrace
    a = torch.randn(4096, 4096, device=card)
    tr = DeviceTrace()
    tr.start()
    for _ in range(10):
        a = a @ a / 64
    tr.stop()
    assert tr.device and 0 < tr.busy_s() <= tr.window_s
    assert tr.top_device_ops()


@pytest.mark.parametrize("script", ["run.py", "control.py", "sweep.py"])
def test_scripts_start(script):
    out = subprocess.run([sys.executable, f"portbench/{script}", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--workload" in out.stdout
