"""The port's benchmark drivers and CLI against the JAX package: the
modeled baseline and the netmodel projections equal the reference's
exactly, the committed baseline checks clean, and every paper family
runs end to end on CPU rows through ``repro_torch.launch.bench_comm``."""
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

import repro.core.bench as ref_bench
from repro.configs.tfgrpc_bench import BenchConfig as RefConfig
from repro.core.payload import from_arch as ref_from_arch
from repro.configs import get_config as ref_get_config
import repro_torch.core.bench as bench
from repro_torch.configs import get_config
from repro_torch.configs.tfgrpc_bench import BenchConfig
from repro_torch.core.payload import from_arch, generate_spec
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.payload_pack import ops as pp_ops
from repro_torch.launch import bench_comm

ROOT = Path(__file__).resolve().parents[1]
BASELINE = ROOT / "benchmarks" / "BENCH_fabric.json"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the timing tests of other files share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def baselines():
    return bench.collect_baseline(), ref_bench.collect_baseline()


def test_committed_baseline_checks_clean():
    data = json.loads(BASELINE.read_text())
    assert bench.check_baseline(data, rel_tol=0.01) == []


@pytest.mark.parametrize("section", ["config", "families", "wire_modes",
                                     "train_crossover", "perf_notes",
                                     "schema"])
def test_baseline_equals_reference_exactly(baselines, section):
    port, ref = baselines
    assert set(port) == set(ref)
    assert port[section] == ref[section]


def test_check_baseline_reports_drift(baselines):
    data = json.loads(BASELINE.read_text())
    data["families"]["ring"]["throughput"] *= 1.5
    problems = bench.check_baseline(data, rel_tol=0.01)
    assert len(problems) == 1 and problems[0].startswith("ring.throughput")


PROJECTED = [("p2p_latency", {}), ("p2p_bandwidth", {}),
             ("ps_throughput", {"num_ps": 2, "num_workers": 3}),
             ("fully_connected", {"num_workers": 4}),
             ("ring", {"num_workers": 4, "stream_chunks": 2}),
             ("incast", {"num_workers": 3, "fetch_ratio": 0.25}),
             ("allreduce", {"num_workers": 4, "algo": "tree"}),
             ("train_step", {"num_workers": 4, "num_ps": 2,
                             "train_mode": "ps"})]


@pytest.mark.parametrize("mode", ["non_serialized", "serialized"])
@pytest.mark.parametrize("name,kw", PROJECTED, ids=[p[0] for p in PROJECTED])
@pytest.mark.parametrize("payload", ["skew", "arch"])
def test_model_projection_equals_reference(name, kw, mode, payload):
    port_kw, ref_kw = dict(kw), dict(kw)
    if payload == "arch":
        port_kw["payload_spec"] = from_arch(get_config("qwen3-8b"))
        ref_kw["payload_spec"] = ref_from_arch(ref_get_config("qwen3-8b"))
    else:
        port_kw["scheme"] = ref_kw["scheme"] = "skew"
    cfg = BenchConfig(benchmark=name, mode=mode, **port_kw)
    rcfg = RefConfig(benchmark=name, mode=mode, **ref_kw)
    spec = generate_spec(cfg)
    assert spec.sizes == ref_bench.generate_spec(rcfg).sizes
    got = bench._stats(name, cfg, spec, [1.0, 2.0], {}).model_projection
    want = ref_bench._stats(name, rcfg, ref_bench.generate_spec(rcfg),
                            [1.0, 2.0], {}).model_projection
    assert got == want and len(got) >= 8


PAPER = [("p2p_latency", {}, "rtt_us"), ("p2p_bandwidth", {}, "MBps"),
         ("ps_throughput", {"num_ps": 2, "num_workers": 3}, "rpcs_per_s")]


@pytest.mark.parametrize("mode", ["non_serialized", "serialized"])
@pytest.mark.parametrize("name,kw,metric", PAPER, ids=[p[0] for p in PAPER])
def test_paper_families_run_on_cpu_rows(name, kw, metric, mode):
    cfg = BenchConfig(benchmark=name, mode=mode, warmup_s=0.0,
                      duration_s=0.01, **kw)
    launches = (pp_ops.pack.launches, pp_ops.unpack.launches)
    st = bench.run(cfg, device="cpu")
    assert (pp_ops.pack.launches, pp_ops.unpack.launches) == launches
    assert st.n_iters >= 5 and st.derived[metric] > 0
    want = ref_bench._stats(name, RefConfig(benchmark=name, mode=mode, **kw),
                            st.spec, [1.0], {}).model_projection
    assert st.model_projection == want
    assert st.resources is not None


@pytest.mark.parametrize("mode", ["non_serialized", "serialized"])
def test_fully_connected_runs_on_the_collective_transport(mode):
    cfg = BenchConfig(benchmark="fully_connected", num_workers=4, mode=mode,
                      transport="collective", warmup_s=0.0, duration_s=0.01)
    st = bench.run(cfg, device="cpu")
    assert st.derived["rpcs_per_round"] == 12.0
    assert st.derived["rpcs_per_s"] > 0 and st.rpc_metrics


def test_collective_refuses_zero_copy_and_too_many_endpoints():
    cfg = BenchConfig(benchmark="fully_connected", num_workers=4,
                      transport="collective", wire_mode="zero_copy")
    with pytest.raises(RuntimeError, match="zero_copy"):
        bench.run(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="endpoints"):
        bench.run(replace(cfg, wire_mode=None, num_workers=9), device="cpu")
    with pytest.raises(RuntimeError, match="endpoints"):
        bench.run(BenchConfig(benchmark="ps_throughput", num_ps=3,
                              num_workers=6), device="cpu")


def test_paper_families_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(BenchConfig(benchmark="p2p_latency"))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_runs_p2p_latency_on_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench_comm", "--device",
         "cpu", "--benchmark", "p2p_latency", "--warmup", "0", "--duration",
         "0.05"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr
    assert "rtt_us = " in r.stdout
    assert "device         : cpu" in r.stdout
    assert "model eth40g      : " in r.stdout


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_comm.main(["--benchmark", "p2p_latency", "--warmup", "0",
                         "--duration", "0.05"])
    assert e.value.code == 2
    assert "no CUDA GPU" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--mode", "serialized", "--wire-mode", "zero_copy"],
    ["--algo", "ring"],
    ["--train-mode", "ps"],
    ["--deadline-s", "1"],
    ["--trace", "x.json"],
    ["--fetch-ratio", "0"],
    ["--categories", "tiny"],
    ["--cluster-spec", "{}"],
    ["--baseline", "a.json", "--check-baseline", "b.json"],
    ["--sweep", "transport", "--benchmark", "p2p_latency"],
    ["--sweep", "workers", "--benchmark", "p2p_latency"],
    ["--sweep", "workers,workers", "--benchmark", "ring"],
    ["--sweep", "stream_chunks,algo", "--benchmark", "ring"],
    ["--sweep", "nosuch"],
    ["--sweep", "mode", "--trace", "x.json", "--benchmark", "incast"],
    ["--rate", "5"],
    ["--workload", "poisson", "--rate", "5"],
    ["--workload", "trace"],
    ["--workload", "trace", "--trace-in", "t.json", "--rate", "5"],
    ["--workload", "poisson", "--rate", "5", "--duration-s", "1",
     "--sweep", "mode"],
    ["--workload", "poisson", "--rate", "0", "--duration-s", "1"]])
def test_cli_rejects_inconsistent_flags(flags):
    with pytest.raises(SystemExit) as e:
        bench_comm.main(["--device", "cpu"] + flags)
    assert e.value.code == 2


def test_cli_serialized_ps_throughput_json_row(tmp_path, capsys):
    out = tmp_path / "row.json"
    rows = bench_comm.main(["--device", "cpu", "--benchmark",
                            "ps_throughput", "--num-ps", "2",
                            "--num-workers", "3", "--mode", "serialized",
                            "--warmup", "0", "--duration", "0.01",
                            "--json", str(out)])
    text = capsys.readouterr().out
    assert "rpcs_per_s = " in text and "model rdma_edr    : " in text
    env = json.loads(out.read_text())
    assert env["schema"] == 3 and env["rows"] == rows
    assert rows[0]["metric"] == "rpcs_per_s" and rows[0]["value"] > 0


def test_cli_check_baseline_passes(capsys):
    assert bench_comm.main(["--device", "cpu", "--check-baseline",
                            str(BASELINE)]) is None
    assert "baseline OK" in capsys.readouterr().out


def test_cli_simulated_incast_matches_reference(capsys):
    bench_comm.main(["--device", "cpu", "--benchmark", "incast",
                     "--num-workers", "3", "--transport", "simulated"])
    text = capsys.readouterr().out
    st = ref_bench.run(RefConfig(benchmark="incast", num_workers=3,
                                 transport="simulated"))
    assert f"rpcs_per_s = {st.derived['rpcs_per_s']:.2f}" in text
    assert "net projected " in text and "phase breakdown" in text


# ---------------------------------------------------------------------------
# --sweep
# ---------------------------------------------------------------------------

def _ref_rows(argv, tmp_path, name="ref.json"):
    """The reference CLI's --json rows for ``argv``, in this process (the
    modeled transports need no JAX device)."""
    from repro.launch import bench_comm as ref_cli
    out = tmp_path / name
    ref_cli.main(argv + ["--json", str(out)])
    return json.loads(out.read_text())["rows"]


SIM_SWEEPS = [
    ["--sweep", "benchmark,algo", "--num-workers", "4"],
    ["--sweep", "mode,wire_mode", "--benchmark", "fully_connected",
     "--num-workers", "3"],
    ["--sweep", "workers,stream_chunks", "--benchmark", "ring"],
    ["--sweep", "benchmark,stream_chunks", "--num-workers", "4",
     "--arch", "qwen3-8b"],
]
IDENTITY = ("benchmark", "scheme", "mode", "wire_mode", "transport",
            "network", "payload", "workers", "stream_chunks", "algo",
            "train_mode")


@pytest.mark.parametrize("argv", SIM_SWEEPS, ids=lambda a: a[1])
def test_sweep_on_the_simulated_transport_equals_reference(argv, tmp_path,
                                                           capsys):
    argv = argv + ["--transport", "simulated", "--network", "eth40g",
                   "--warmup", "0.05", "--duration", "0.2"]
    ref = _ref_rows(argv, tmp_path)
    rows = bench_comm.main(argv + ["--device", "cpu"])
    assert len(rows) == len(ref) >= 6
    for got, want in zip(rows, ref):
        # identity columns, metric, the error text of a cell that cannot
        # run, and the modeled value and round time: all equal, not close
        for key in IDENTITY + ("metric", "value", "mean_us", "error"):
            assert got.get(key) == want.get(key), (key, got, want)
        assert set(got) == set(want)
    text = capsys.readouterr().out
    assert "benchmark" in text and "value" in text


def test_sweep_json_envelope_and_table(tmp_path, capsys):
    out = tmp_path / "rows.json"
    rows = bench_comm.main(["--device", "cpu", "--sweep", "scheme,mode",
                            "--benchmark", "incast", "--transport",
                            "simulated", "--num-workers", "4",
                            "--json", str(out)])
    table = capsys.readouterr().out
    doc = json.loads(out.read_text())
    assert doc["schema"] == 3 and doc["rows"] == rows and len(rows) == 6
    assert {(r["scheme"], r["mode"]) for r in rows} == {
        (s, m) for s in ("uniform", "random", "skew")
        for m in ("non_serialized", "serialized")}
    for s in ("uniform", "random", "skew"):
        assert table.count(s) >= 2


def test_sweep_unrunnable_cells_carry_the_reference_error(tmp_path, capsys):
    argv = ["--sweep", "algo", "--benchmark", "allreduce", "--transport",
            "collective", "--num-workers", "4", "--warmup", "0",
            "--duration", "0"]
    ref = _ref_rows(argv, tmp_path)
    capsys.readouterr()
    rows = bench_comm.main(argv + ["--device", "cpu"])
    assert rows == ref and len(rows) == 3
    assert all(r["error"].startswith("allreduce does not run on the "
                                     "collective transport") for r in rows)
    assert capsys.readouterr().out.count("SKIPPED: ") == 3


def test_sweep_collective_zero_copy_cell_skipped(capsys):
    rows = bench_comm.main(["--device", "cpu", "--sweep", "wire_mode",
                            "--benchmark", "fully_connected", "--transport",
                            "collective", "--num-workers", "2", "--warmup",
                            "0", "--duration", "0.02"])
    errors = {r["wire_mode"]: r.get("error") for r in rows}
    assert errors["zero_copy"].startswith("wire_mode=zero_copy is not "
                                          "supported")
    assert errors["serialized"] is None and errors["scatter_gather"] is None
    assert "SKIPPED" in capsys.readouterr().out


@pytest.mark.parametrize("error", [
    KernelError("payload_pack pack launch failed: cudaError 700"),
    torch.OutOfMemoryError("CUDA out of memory"),
], ids=["kernel", "out_of_memory"])
def test_sweep_raises_what_the_card_fails(monkeypatch, error):
    """A cell the card fails stops the sweep (the CLI exits non-zero);
    only a cell's configuration error becomes a SKIPPED row."""
    def run(cfg, device):
        raise error
    monkeypatch.setattr(bench, "run", run)
    argv = ["--device", "cpu", "--sweep", "mode", "--benchmark",
            "p2p_latency", "--warmup", "0", "--duration", "0"]
    with pytest.raises(type(error)):
        bench_comm.main(argv)

    def config_error(cfg, device):
        raise RuntimeError("ring needs --num-workers >= 2")
    monkeypatch.setattr(bench, "run", config_error)
    rows = bench_comm.main(argv)
    assert [r["error"] for r in rows] == ["ring needs --num-workers >= 2"] * 2


def test_mode_sweep_of_p2p_latency_on_cpu_rows_matches_reference(tmp_path):
    """Measured rows: the identity columns and metrics equal the
    reference's; the times cannot be compared. Serialized cells on CPU
    rows launch no kernel."""
    argv = ["--benchmark", "p2p_latency", "--sweep", "mode", "--warmup",
            "0", "--duration", "0.05"]
    out = tmp_path / "ref.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro.launch.bench_comm"] + argv
        + ["--json", str(out)], capture_output=True, text=True,
        timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                          "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(out.read_text())["rows"]
    launches = (pp_ops.pack.launches, pp_ops.unpack.launches)
    rows = bench_comm.main(["--device", "cpu"] + argv)
    assert (pp_ops.pack.launches, pp_ops.unpack.launches) == launches
    assert [r["mode"] for r in rows] == ["non_serialized", "serialized"]
    for got, want in zip(rows, ref):
        for key in IDENTITY + ("metric",):
            assert got.get(key) == want.get(key), key
        assert set(got) == set(want)
        assert got["value"] > 0 and got["n_iters"] > 0
