"""The port's examples (``examples/torch_*.py``) run their smoke forms on
the CPU: the quickstart's three paper families in both modes, the sweep
example's rows against the reference example's, the batched serving
example on a dense and a recurrent model."""
import json
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.payload_pack import ops as pp_ops

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    return runpy.run_path(str(ROOT / "examples" / name),
                          run_name="example")["main"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the timing tests of other files share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_quick_runs_on_cpu(capsys):
    launches = (pp_ops.pack.launches, pp_ops.unpack.launches)
    results = _example("torch_quickstart.py")(["--quick", "--device", "cpu"])
    assert [st.name for st in results[:5]] == ["p2p_latency"] * 3 + [
        "p2p_bandwidth", "ps_throughput"]
    assert len(results) == 10 and all(st.n_iters > 0 for st in results)
    assert (pp_ops.pack.launches, pp_ops.unpack.launches) == launches
    text = capsys.readouterr().out
    assert "endpoints: 8 rows on cpu" in text
    assert text.count("P2P-Latency") == 6 and "PS-Throughput" in text


def test_quickstart_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        _example("torch_quickstart.py")(["--quick"])
    assert e.value.code == 2


def test_sweep_example_rows_equal_the_reference_example(tmp_path, capsys):
    ref_out, out = tmp_path / "ref.json", tmp_path / "port.json"
    _example("comm_benchmark_sweep.py")(["--quick", "--json", str(ref_out)])
    rows = _example("torch_comm_benchmark_sweep.py")(
        ["--quick", "--device", "cpu", "--json", str(out)])
    ref = json.loads(ref_out.read_text())["rows"]
    assert json.loads(out.read_text())["rows"] == rows
    assert len(rows) == 2 * 4 * 4
    assert {r["benchmark"] for r in rows} == {"ring", "incast"}
    assert all("error" not in r for r in rows)
    for got, want in zip(rows, ref):
        for key in ("benchmark", "workers", "stream_chunks", "network",
                    "metric", "value", "mean_us"):
            assert got[key] == want[key], key
    assert "stream_chunks" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-1.6b"])
def test_serve_batched_tiny_runs_on_cpu(arch, capsys):
    from repro_torch.configs import get_reduced_config
    outs = _example("torch_serve_batched.py")(["--tiny", "--device", "cpu",
                                               "--arch", arch])
    vocab = get_reduced_config(arch).model.vocab_size
    assert [o.shape for o in outs] == [(2, 4), (4, 4)]
    assert all(o.dtype == np.int32 and o.min() >= 0 and o.max() < vocab
               for o in outs)
    assert f"[{arch} on cpu] request 1: batch=4" in capsys.readouterr().out


def test_train_ps_mode_tiny_runs_over_the_2x2_mesh(capsys):
    """The PS-mode example trains over a 2 x 2 (data, model) mesh of four
    spawned gloo processes, as the JAX example does over its (2, 2) host
    mesh, then restarts from its checkpoint."""
    tr, tr2 = _example("torch_train_ps_mode.py")(["--tiny", "--device",
                                                   "cpu"])
    out = capsys.readouterr().out
    assert "PS(fsdp) mode over a 2x2 (data x model) mesh" in out
    losses = [r.loss for r in tr.history]
    assert [r.step for r in tr.history] == list(range(6))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert [r.step for r in tr2.history] == [6, 7]
