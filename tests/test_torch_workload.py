"""The port's copy of the workload tier (``repro_torch.workload``) and its
``bench_comm --workload`` against the JAX package's: the same seeds give
the same traces and the same SLO reports, a recorded trace replays to the
same rows, and the cases of tests/test_workload.py and
tests/test_workload_e2e.py hold on the copy. The workload path is
model-free (a numpy ``SyntheticEngine`` behind real per-endpoint
schedulers on the cluster transport), so nothing here needs a card."""
import json

import numpy as np
import pytest

from repro.launch import bench_comm as ref_cli
from repro import workload as ref_wl
from repro_torch import rpc
from repro_torch.launch import bench_comm
from repro_torch.workload import (SyntheticEngine, Trace, TraceEvent,
                                  correlated_burst_windows,
                                  materialize_prompts, serve_workload,
                                  synthesize_trace)


def _rows(main, argv, path):
    main(argv + ["--json", str(path)])
    return json.loads(path.read_text())["rows"]


# ---------------------------------------------------------------------------
# the CLI against the reference's
# ---------------------------------------------------------------------------

WORKLOADS = {
    "poisson": ["--workload", "poisson", "--rate", "60", "--duration-s",
                "1.5", "--num-workers", "2", "--seed", "3"],
    "bursty_fault": ["--workload", "bursty", "--rate", "50",
                     "--duration-s", "2", "--num-ps", "2",
                     "--num-workers", "2", "--fault-bursts", "1",
                     "--fault-burst-width-s", "0.3", "--deadline-s", "0.5",
                     "--dispatch-policy", "scheduler_least_loaded",
                     "--seed", "5"],
    "diurnal_sjf": ["--workload", "diurnal", "--rate", "40",
                    "--duration-s", "1", "--num-workers", "3",
                    "--prompt-dist", "zipf", "--sched-policy", "sjf",
                    "--starvation-age-s", "0.2", "--kv-blocks", "8"],
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_cli_slo_report_equals_reference(name, tmp_path, capsys):
    argv = WORKLOADS[name]
    ref = _rows(ref_cli.main, argv, tmp_path / "ref.json")
    ref_text = capsys.readouterr().out
    rows = _rows(lambda a: bench_comm.main(a + ["--device", "cpu"]), argv,
                 tmp_path / "port.json")
    text = capsys.readouterr().out
    assert rows == ref
    (row,) = rows
    assert row["slo"]["offered"] == row["events"] > 20
    if name == "bursty_fault":
        assert row["fault_windows"] == 1 and row["slo"]["retries"] > 0
    # the same SLO table, line for line, but the "wrote ..." line
    assert [ln for ln in text.splitlines() if not ln.startswith("wrote")] \
        == [ln for ln in ref_text.splitlines() if not ln.startswith("wrote")]


def test_trace_out_then_replay_gives_identical_rows(tmp_path, capsys):
    path = tmp_path / "trace.json"
    first = bench_comm.main(["--device", "cpu"] + WORKLOADS["bursty_fault"]
                            + ["--trace-out", str(path)])
    replay = ["--workload", "trace", "--trace-in", str(path), "--num-ps",
              "2", "--num-workers", "2", "--deadline-s", "0.5",
              "--dispatch-policy", "scheduler_least_loaded"]
    again = bench_comm.main(["--device", "cpu"] + replay)
    assert again == first
    slo = again[0]["slo"]
    # every request completed or was reported shed / failed
    assert slo["completed_ok"] + slo["errors"] + slo["deadline_exceeded"] \
        == slo["offered"] == again[0]["events"]
    # the reference replays the port's recorded trace to the same rows
    assert _rows(ref_cli.main, replay, tmp_path / "ref.json") == first
    assert "wrote trace" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_synthesized_traces_equal_reference(kind):
    kw = dict(seed=4, prompt_kind="lognormal", prompt_kw={"lo": 2,
                                                          "hi": 48})
    tr = synthesize_trace(kind, 30.0, 1.5, **kw)
    ref = ref_wl.synthesize_trace(kind, 30.0, 1.5, **kw)
    assert correlated_burst_windows(tr, n_windows=2, width_s=0.2) == \
        ref_wl.correlated_burst_windows(ref, n_windows=2, width_s=0.2)
    assert tr.to_json() == ref.to_json()
    for ev, rev in zip(tr.events[:5], ref.events[:5]):
        np.testing.assert_array_equal(materialize_prompts(tr.seed, ev),
                                      ref_wl.materialize_prompts(ref.seed,
                                                                 rev))


# ---------------------------------------------------------------------------
# the open-loop cases of tests/test_workload.py, on the copy
# ---------------------------------------------------------------------------

def test_driver_pacing_fires_events_at_their_arrival_times():
    from repro_torch.serve.engine import ShardedServeStub, bind_scheduler
    from repro_torch.serve.scheduler import ServeScheduler
    from repro_torch.workload.driver import run_trace

    cluster = rpc.ps_worker_cluster(1, 1)
    fab = rpc.RpcFabric(rpc.make_transport("cluster", cluster=cluster))
    ps0 = cluster.job_endpoints("ps")[0]
    w0 = cluster.job_endpoints("worker")[0]
    bind_scheduler(fab.add_server(ps0), ServeScheduler(SyntheticEngine()))
    stubs = {w0: ShardedServeStub(fab, w0, [ps0])}
    tr = Trace(events=[
        TraceEvent(id=0, t_s=0.0, prompt_len=4, max_new_tokens=2),
        TraceEvent(id=1, t_s=1.0, prompt_len=4, max_new_tokens=2)])
    rec = run_trace(tr, fab, stubs)
    r0, r1 = rec.records[0], rec.records[1]
    assert r0["outcome"] == "ok" and r1["outcome"] == "ok"
    assert r0["submit_s"] == pytest.approx(0.0, abs=1e-6)
    assert r0["end_s"] < 1.0
    assert r1["submit_s"] == pytest.approx(1.0, abs=1e-6)
    assert r1["end_s"] > 1.0
    assert all(not isinstance(ic, type(rec))
               for ic in fab.client_interceptors)


def test_serve_workload_all_tokens_correct():
    tr = synthesize_trace("poisson", 25.0, 1.0, seed=21,
                          prompt_kind="lognormal",
                          prompt_kw={"lo": 2, "hi": 32})
    run = serve_workload(tr, n_ps=1, n_workers=2, max_new_tokens=3)
    assert run.report.completed_ok == len(tr) and run.report.errors == 0
    by_id = {e.id: e for e in tr.events}
    for rec in run.records:
        ev = by_id[rec["id"]]
        assert rec["outcome"] == "ok"
        assert rec["chunks"] == ev.max_new_tokens
        assert rec["end_s"] >= ev.t_s
        assert rec["first_chunk_s"] <= rec["end_s"]
    ref = ref_wl.serve_workload(
        ref_wl.synthesize_trace("poisson", 25.0, 1.0, seed=21,
                                prompt_kind="lognormal",
                                prompt_kw={"lo": 2, "hi": 32}),
        n_ps=1, n_workers=2, max_new_tokens=3)
    assert run.records == ref.records


def test_serve_workload_sjf_policy_reaches_schedulers():
    tr = synthesize_trace("poisson", 10.0, 0.5, seed=2)
    run = serve_workload(tr, n_ps=2, n_workers=1, sched_policy="sjf",
                         starvation_age_s=1.0)
    for sched in run.schedulers.values():
        assert sched.policy == "sjf" and sched.stats()["policy"] == "sjf"


def test_serve_workload_rejects_oversized_trace():
    tr = Trace(events=[TraceEvent(id=0, t_s=0.0, prompt_len=100,
                                  max_new_tokens=8)])
    with pytest.raises(ValueError, match="max_seq"):
        serve_workload(tr, max_seq=64)


def test_serve_workload_needs_ps_and_workers(capsys):
    tr = synthesize_trace("poisson", 5.0, 0.5, seed=0)
    with pytest.raises(ValueError, match="worker"):
        serve_workload(tr, cluster=rpc.homogeneous(2, "eth40g"))
    with pytest.raises(SystemExit) as e:
        bench_comm.main(["--device", "cpu", "--workload", "poisson",
                         "--rate", "5", "--duration-s", "0.5",
                         "--cluster-spec", rpc.homogeneous(2).to_json()])
    assert e.value.code == 2 and "--workload" in capsys.readouterr().err


def test_synthetic_engine_expected_tokens():
    eng = SyntheticEngine()
    prompts = np.arange(12, dtype=np.int32).reshape(1, 12)
    exp = SyntheticEngine.expected_tokens(prompts, 4)
    np.testing.assert_array_equal(exp, int(prompts.sum()) % 997
                                  + 7 * np.arange(4))
    np.testing.assert_array_equal(
        exp, ref_wl.SyntheticEngine.expected_tokens(prompts, 4))

    class _Req:
        pass
    req = _Req()
    req.prompts, req.rows, req.tokens = prompts, 1, []
    np.testing.assert_array_equal(eng.scheduler_prefill(req),
                                  np.full(1, exp[0]))


# ---------------------------------------------------------------------------
# the acceptance scenario of tests/test_workload_e2e.py, on the copy
# ---------------------------------------------------------------------------

RATE, DURATION, SEED = 40.0, 2.0, 7


def _e2e_trace(lib):
    tr = lib.synthesize_trace("poisson", RATE, DURATION, seed=SEED,
                              prompt_kind="lognormal",
                              prompt_kw={"lo": 2, "hi": 48},
                              decode_kind="fixed", decode_kw={"value": 4})
    lib.correlated_burst_windows(tr, n_windows=1, width_s=0.3)
    return tr


def _e2e_run(lib, tr, tracer, **kw):
    return lib.serve_workload(tr, n_ps=1, n_workers=2, deadline_s=0.5,
                              tracer=tracer, **kw)


@pytest.fixture(scope="module")
def e2e():
    from repro import rpc as ref_rpc
    import repro_torch.workload as port_wl
    tr = _e2e_trace(port_wl)
    return (tr, _e2e_run(port_wl, tr, rpc.Tracer()),
            _e2e_run(ref_wl, _e2e_trace(ref_wl), ref_rpc.Tracer()))


def test_e2e_open_loop_under_burst_loss_equals_reference(e2e):
    tr, run, ref = e2e
    rep = run.report
    assert rep.offered == len(tr) > 30
    assert rep.completed_ok + rep.errors + rep.deadline_exceeded \
        == rep.offered and rep.completed_ok > 0
    assert run.fabric.transport.burst_faults_injected > 0
    assert rep.retries > 0
    assert rep.ttft["p50"] <= rep.ttft["p99"] <= rep.ttft["p999"]
    assert 0.0 < rep.slo_attainment <= 1.0
    assert any(ep.startswith("ps") for ep in rep.queue_peaks)
    assert rep.to_dict() == ref.report.to_dict()
    assert run.records == ref.records
    assert run.completion_times() == ref.completion_times()


def test_e2e_arrival_times_and_tokens(e2e):
    tr, run, _ = e2e
    for rec in run.records:
        assert rec["submit_s"] >= rec["arrival_s"] - 1e-9
    ends = [r["end_s"] for r in run.records if r["end_s"] is not None]
    assert any(s < max(ends) for s in
               [r["submit_s"] for r in run.records][1:])
    by_id = {e.id: e for e in tr.events}
    ok = [r for r in run.records if r["outcome"] == "ok"]
    assert all(r["chunks"] == by_id[r["id"]].max_new_tokens for r in ok)
    assert len(ok) == run.report.completed_ok


def test_e2e_recorded_trace_replays_identically(e2e, tmp_path):
    tr, run, _ = e2e
    path = tmp_path / "recorded.json"
    tr.save(str(path))
    rerun = _e2e_run(__import__("repro_torch.workload").workload,
                     Trace.load(str(path)), rpc.Tracer())
    assert rerun.completion_times() == run.completion_times()
    assert rerun.report.to_dict() == run.report.to_dict()


def test_e2e_sjf_changes_admission_not_results(e2e):
    import repro_torch.workload as port_wl
    tr, _, _ = e2e
    sjf = _e2e_run(port_wl, tr, None, sched_policy="sjf",
                   starvation_age_s=0.5)
    sjf2 = _e2e_run(port_wl, tr, None, sched_policy="sjf",
                    starvation_age_s=0.5)
    assert sjf.completion_times() == sjf2.completion_times()
    rep = sjf.report
    assert rep.completed_ok + rep.errors + rep.deadline_exceeded \
        == rep.offered


def test_e2e_tracer_sees_workload_calls(e2e):
    _, run, _ = e2e
    roots = run.fabric.tracer.calls()
    assert len(roots) >= run.report.completed_ok
    assert any("generate_stream" in s.name for s in roots)
