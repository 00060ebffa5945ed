"""Cluster serving and the cluster transport in the port, against the JAX
package: the port's engine (a reduced fp32 Qwen3-8B whose parameters come
from the reference's ``init_params`` through ``convert.from_jax_params``)
bound on the PS endpoints of a cluster answers concurrent workers with
the JAX engine's greedy tokens, under round_robin and
scheduler_least_loaded dispatch and under seeded faults; the sharded
dispatch policies; the cluster bench family and CLI; the serve CLI's
``--transport cluster``. The cases of tests/test_cluster_transport.py and
tests/test_fault_tier.py, on the port."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.parallel import NO_MESH
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import rpc
from repro_torch.configs import get_reduced_config
from repro_torch.configs.tfgrpc_bench import BenchConfig
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                      decode_token_chunk)

ARCH = "qwen3-8b"


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
def jax_engine_and_params():
    cfg = jax_reduced(ARCH)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    jeng = JaxServeEngine(NO_MESH, cfg, params,
                          JaxServeConfig(max_seq=64, max_new_tokens=4))
    return jeng, jax.tree.map(np.asarray, params)


def _engine(params):
    return ServeEngine(get_reduced_config(ARCH), from_jax_params(params),
                       ServeConfig(max_seq=64, max_new_tokens=4))


def _prompts(seed=0, rows=2, plen=8):
    return np.random.default_rng(seed).integers(
        0, get_reduced_config(ARCH).model.vocab_size, (rows, plen),
        dtype=np.int32)


def _assert_credits_balanced(fab):
    for ch in fab._channels.values():
        assert ch.window.bytes_avail == ch.window.window_bytes
        assert ch.window.msgs_avail == ch.window.window_msgs
        assert ch.rwindow.bytes_avail == ch.rwindow.window_bytes
        assert ch.rwindow.msgs_avail == ch.rwindow.window_msgs
        assert len(ch.rx_gate) == 0 and ch.backlogged == 0
    assert not fab._backlog and not fab._pending
    assert not fab._awaiting_grant


# ---------------------------------------------------------------------------
# serve_cluster with the real (reduced) engine
# ---------------------------------------------------------------------------

def test_serve_cluster_real_engine_concurrent_workers(jax_engine_and_params):
    jeng, params = jax_engine_and_params
    prompts = _prompts()
    want = jeng.generate(prompts)
    eng = _engine(params)
    fabric, stubs = eng.serve_cluster(
        rpc.ps_worker_cluster(2, 2, ps_network="rdma_edr"))
    assert sorted(stubs) == ["worker0", "worker1"]
    calls = {w: stub.generate(prompts) for w, stub in stubs.items()}
    fabric.flush()                          # both served in one loop
    for call in calls.values():
        np.testing.assert_array_equal(call.result(), want)
    assert all(s.outstanding(0) == 0 for s in stubs.values())


def _cluster_rounds(eng, rpclib, policy, decode):
    """Two rounds of one streamed request per worker over a 2 ps x 2
    worker cluster, one flush a round. Returns (tokens by round and
    worker, per-link dispatch counts, requests finished per ps)."""
    cluster = rpclib.ps_worker_cluster(2, 2, ps_network="rdma_edr")
    metrics = rpclib.MetricsInterceptor(per_endpoint=True,
                                        endpoint_name=cluster.name_of)
    fabric, stubs = eng.serve_cluster(
        cluster, policy=policy, client_interceptors=[metrics],
        server_interceptors=[metrics])
    tokens = {}
    for rnd in range(2):
        calls = {w: stub.generate_stream(_prompts(10 * rnd + i))
                 for i, (w, stub) in enumerate(sorted(stubs.items()))}
        fabric.flush()
        for w, h in calls.items():
            tokens[rnd, w] = np.stack([decode(c) for c in h.result()],
                                      axis=1)
    per_link = {k.split("@")[1]: v["calls"] for k, v in
                metrics.snapshot().items()
                if k.startswith("Serve/generate_stream@")}
    finished = {cluster.name_of(ep): s.stats()["finished"]
                for ep, s in eng.schedulers.items()}
    return tokens, per_link, finished, fabric


@pytest.mark.parametrize("policy", ["round_robin",
                                    "scheduler_least_loaded"])
def test_serve_cluster_rounds_dispatch_by_policy(jax_engine_and_params,
                                                 policy):
    """The shape chip_smoke.py drives at full width: every worker gets
    the JAX engine's greedy tokens, and the dispatch counts per link are
    the reference's under the same policy. round_robin: each worker's
    own cycle, so both go to ps0 in round 0 and to ps1 in round 1.
    scheduler_least_loaded: both dispatch before the flush that serves
    them, when every shard reports no load, so ties go to ps0."""
    from repro import rpc as ref_rpc
    from repro.serve.engine import decode_token_chunk as ref_decode
    jeng, params = jax_engine_and_params
    tokens, per_link, finished, fabric = _cluster_rounds(
        _engine(params), rpc, policy, decode_token_chunk)
    ref = _cluster_rounds(jeng, ref_rpc, policy, ref_decode)
    for key, got in tokens.items():
        np.testing.assert_array_equal(got, ref[0][key])
        np.testing.assert_array_equal(got, jeng.generate(
            _prompts(10 * key[0] + int(key[1][-1]))))
    assert (per_link, finished) == ref[1:3]
    if policy == "round_robin":
        assert per_link == {f"worker{w}->ps{p}": 1 for w in (0, 1)
                            for p in (0, 1)}
        assert finished == {"ps0": 2, "ps1": 2}
    else:
        assert per_link == {"worker0->ps0": 2, "worker1->ps0": 2}
        assert finished == {"ps0": 4, "ps1": 0}
    _assert_credits_balanced(fabric)


def test_serve_cluster_needs_both_jobs(jax_engine_and_params):
    _, params = jax_engine_and_params
    with pytest.raises(ValueError, match="serve_cluster needs"):
        _engine(params).serve_cluster(rpc.homogeneous(3))


def test_serve_cluster_under_faults_completes_all_requests(
        jax_engine_and_params):
    jeng, params = jax_engine_and_params
    prompts = _prompts()
    want = jeng.generate(prompts)
    eng = _engine(params)
    cluster = rpc.ClusterSpec(endpoints=(
        rpc.EndpointSpec("ps0", job="ps", network="rdma_edr",
                         admission_limit=2),
        rpc.EndpointSpec("worker0", network="rdma_edr"),
        rpc.EndpointSpec("worker1", network="rdma_edr"),
        rpc.EndpointSpec("worker2", network="rdma_edr")))
    metrics = rpc.MetricsInterceptor(per_endpoint=True)
    retry = rpc.RetryInterceptor(max_attempts=6)
    fabric, stubs = eng.serve_cluster(
        cluster,
        client_interceptors=[metrics,
                             rpc.DeadlineInterceptor(default_deadline_s=30.0),
                             retry],
        server_interceptors=[metrics],
        fault=dict(seed=11, fault_rate=0.3, max_faults=4,
                   links=[(w, 0) for w in (1, 2, 3)]))
    calls = {w: stub.generate(prompts) for w, stub in stubs.items()}
    streams = {w: stub.generate_stream(prompts) for w, stub in stubs.items()}
    fabric.flush()
    for w, call in calls.items():
        np.testing.assert_array_equal(call.result(), want)
    for w, h in streams.items():
        assert h.done and h.error is None, (w, h.error)
        got = np.stack([decode_token_chunk(c) for c in h.chunk_bufs()],
                       axis=1)
        np.testing.assert_array_equal(got, want)
    assert fabric.transport.faults_injected >= 1 and retry.retries >= 1
    snap = metrics.snapshot()
    assert all(rec["deadline_exceeded"] == 0 for rec in snap.values())
    assert snap["server:Serve/generate"]["shed"] == 0
    assert fabric.servers[0].calls_shed == 0
    _assert_credits_balanced(fabric)


# ---------------------------------------------------------------------------
# sharded dispatch policies (fake Serve handlers: policy logic only)
# ---------------------------------------------------------------------------

def _fake_serve_fabric(n_ps=2, n_workers=2, policy="round_robin"):
    from repro_torch.serve.engine import (SERVE_SERVICE, ShardedServeStub,
                                          _i32_buf, decode_generate_request,
                                          encode_generate_reply)
    served = {f"ps{i}": 0 for i in range(n_ps)}

    def make_handlers(name):
        def generate(bufs):
            served[name] += 1
            prompts, mnt = decode_generate_request(bufs)
            return encode_generate_reply(
                np.full((prompts.shape[0], max(mnt, 1)), int(name[-1]),
                        np.int32))

        def generate_stream(bufs):
            served[name] += 1
            prompts, mnt = decode_generate_request(bufs)
            return [[_i32_buf(np.full(prompts.shape[0], int(name[-1]),
                                      np.int32))]
                    for _ in range(max(mnt, 1))]
        return {"generate": generate, "generate_stream": generate_stream}

    cluster = rpc.ps_worker_cluster(n_ps, n_workers)
    fab = rpc.RpcFabric(rpc.make_transport("cluster", cluster=cluster),
                        window_bytes=64 << 20, window_msgs=256)
    for i in range(n_ps):
        fab.add_server(f"ps{i}").add_service(SERVE_SERVICE,
                                             make_handlers(f"ps{i}"))
    stubs = {f"worker{w}": ShardedServeStub(
        fab, f"worker{w}", cluster.job_endpoints("ps"), policy=policy)
        for w in range(n_workers)}
    return fab, stubs, served


def test_sharded_dispatch_round_robin_across_clients():
    fab, stubs, served = _fake_serve_fabric(n_ps=2, n_workers=2)
    prompts = np.zeros((2, 4), np.int32)
    calls = []
    for _ in range(2):
        for stub in stubs.values():
            calls.append(stub.generate(prompts, 3))
    fab.flush()
    outs = [c.result() for c in calls]
    assert all(o.shape == (2, 3) for o in outs)
    assert [int(o[0, 0]) for o in outs] == [0, 0, 1, 1]
    assert served == {"ps0": 2, "ps1": 2}


def test_sharded_dispatch_least_loaded_avoids_busy_shard():
    fab, stubs, served = _fake_serve_fabric(n_ps=2, n_workers=1,
                                            policy="least_loaded")
    stub = stubs["worker0"]
    prompts = np.zeros((1, 4), np.int32)
    first, second, third = (stub.generate(prompts, 1) for _ in range(3))
    fab.flush()
    assert [int(c.result()[0, 0]) for c in (first, second, third)] \
        == [0, 1, 0]
    after = stub.generate(prompts, 1)
    fab.flush()
    assert int(after.result()[0, 0]) == 0
    assert served == {"ps0": 3, "ps1": 1}


def test_sharded_dispatch_rejects_unknown_policy():
    from repro_torch.serve.engine import ShardedServeStub
    fab, _, _ = _fake_serve_fabric()
    with pytest.raises(ValueError, match="unknown dispatch policy"):
        ShardedServeStub(fab, "worker0", ["ps0"], policy="random")


# ---------------------------------------------------------------------------
# the cluster bench family and CLI
# ---------------------------------------------------------------------------

def test_bench_incast_cluster_reports_per_endpoint_metrics():
    from repro.configs.tfgrpc_bench import BenchConfig as RefConfig
    from repro.core import bench as ref_bench
    from repro_torch.core import bench
    kw = dict(benchmark="incast", transport="cluster", num_workers=2,
              stream_chunks=2, warmup_s=0.0, duration_s=0.0, iovec_count=4)
    st = bench.run(BenchConfig(**kw), device="cpu")
    assert "Incast/push_fetch@ep1->ep0" in st.rpc_metrics
    assert "Incast/push_fetch@ep2->ep0" in st.rpc_metrics
    want = rpc.cluster_incast_round_time(
        rpc.homogeneous(3, "eth40g"), list(st.spec.sizes), n_chunks=2)
    assert st.mean_s == pytest.approx(want, rel=1e-9)
    assert st.model_projection["cluster"] == pytest.approx(
        st.derived["rpcs_per_round"] / want, rel=1e-9)
    ref = ref_bench.run(RefConfig(**kw))
    assert st.mean_s == ref.mean_s
    assert st.model_projection == ref.model_projection


def test_bench_comm_cluster_cli_json(tmp_path):
    from repro_torch.launch import bench_comm
    spec_path = tmp_path / "cluster.json"
    spec_path.write_text(rpc.ClusterSpec(
        endpoints=(rpc.EndpointSpec("ps0", job="ps", network="rdma_edr"),
                   rpc.EndpointSpec("w0", network="eth10g"),
                   rpc.EndpointSpec("w1", network="eth10g")),
        links=(rpc.LinkSpec("w0", "ps0", bandwidth_Bps=2e9),)).to_json())
    out = tmp_path / "rows.json"
    rows = bench_comm.main(["--device", "cpu", "--benchmark", "incast",
                            "--num-workers", "2", "--transport", "cluster",
                            "--cluster-spec", str(spec_path),
                            "--stream-chunks", "2", "--warmup", "0",
                            "--duration", "0", "--json", str(out)])
    assert json.loads(out.read_text())["rows"] == rows
    assert rows[0]["transport"] == "cluster"
    assert rows[0]["network"] == "cluster"
    keys = rows[0]["rpc_metrics"].keys()
    assert "Incast/push_fetch@w0->ps0" in keys
    assert "Incast/push_fetch@w1->ps0" in keys


@pytest.mark.parametrize("policy", ["round_robin",
                                    "scheduler_least_loaded"])
def test_serve_cli_cluster_transport_on_cpu(tmp_path, capsys, policy):
    from repro_torch.launch import serve
    spec = tmp_path / "cluster.json"
    spec.write_text(rpc.ps_worker_cluster(2, 2,
                                          ps_network="rdma_edr").to_json())
    res = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--transport", "cluster", "--cluster-spec", str(spec),
                      "--policy", policy, "--batch", "2", "--prompt-len",
                      "8", "--new-tokens", "3", "--requests", "2"])
    text = capsys.readouterr().out
    for i in range(2):
        for w in ("worker0", "worker1"):
            assert f"request {i} [{w}]: batch=2 new=3" in text
        assert f"round {i}: " in text
    assert "per-endpoint   : {" in text
    assert sorted(res["engine"].schedulers) == [0, 1]
    assert sum(s.stats()["finished"]
               for s in res["engine"].schedulers.values()) == 4
