"""The port's serve engine against the JAX engine on the same converted
parameters: greedy tokens identical directly, over the loopback
streaming RPC and over unary RPC; the CLI's device rule."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import init_params as jax_init_params
from repro.parallel import NO_MESH
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_reduced_config
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                      rpc_generate_stream, serve_stub)
from repro_torch.serve.scheduler import ServeScheduler

ARCH = "qwen3-8b"
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one thread each, so that parallel test workers do
    not oversubscribe the cores (the fault tier's timing tests share
    them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_reduced(ARCH)
    params = jax_init_params(jax.random.PRNGKey(0), jcfg)
    scfg = dict(max_seq=32, max_new_tokens=5)
    jeng = JaxServeEngine(NO_MESH, jcfg, params, JaxServeConfig(**scfg))
    teng = ServeEngine(get_reduced_config(ARCH),
                       from_jax_params(jax.tree.map(np.asarray, params)),
                       ServeConfig(**scfg))
    return jeng, teng


def _prompts(rows, plen, seed):
    return np.random.default_rng(seed).integers(0, 128, (rows, plen),
                                                dtype=np.int32)


def test_greedy_tokens_identical_three_ways(engines):
    jeng, teng = engines
    _, channel = teng.serve_loopback()
    for seed in (0, 1):
        prompts = _prompts(2, 8, seed)
        want = jeng.generate(prompts)
        assert want.shape == (2, 5)
        direct = teng.generate(prompts)
        streamed = rpc_generate_stream(channel, prompts)
        unary = serve_stub(channel).generate((prompts, 0)).result()
        for got in (direct, streamed, unary):
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


def test_prefill_and_decode_ops_are_timed(engines):
    _, teng = engines
    n_pre, n_dec = (len(teng.op_seconds[k]) for k in ("prefill", "decode"))
    teng.generate(_prompts(1, 6, 3))
    assert len(teng.op_seconds["prefill"]) == n_pre + 1
    assert len(teng.op_seconds["decode"]) == n_dec + 4


def test_temperature_sampling_replays_across_preemption():
    """Each request walks JAX's key chain from PRNGKey(cfg.seed); a
    request preempted by the KV budget is rebuilt by replaying the same
    splits and draws, so it finishes with the tokens of its solo run."""
    params = from_jax_params(jax.tree.map(
        np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                    jax_reduced(ARCH))))
    eng = ServeEngine(get_reduced_config(ARCH), params,
                      ServeConfig(max_seq=32, max_new_tokens=4,
                                  temperature=0.9, seed=5))
    p1, p2 = _prompts(1, 8, 1), _prompts(1, 8, 2)
    solo = [eng.generate(p) for p in (p1, p2)]
    assert np.array_equal(eng.generate(p1), solo[0])
    sched = ServeScheduler(eng, max_batch=4, kv_blocks=21, block_size=1)
    reqs = [sched.submit(p, 4) for p in (p1, p2)]
    while not all(r.finished for r in reqs):
        sched.step()
    assert sched.counters["preempted"] >= 1
    for req, want in zip(reqs, solo):
        np.testing.assert_array_equal(np.stack(req.tokens, axis=1), want)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--batch", "2", "--prompt-len", "8", "--new-tokens",
         "3", "--requests", "2", *args],
        capture_output=True, text=True, env=env, timeout=120)


def test_cli_same_samples_with_and_without_rpc():
    runs = [_cli("--device", "cpu"), _cli("--device", "cpu", "--no-rpc")]
    samples = []
    for r in runs:
        assert r.returncode == 0, r.stderr
        samples.append([line.split("sample=")[1]
                        for line in r.stdout.splitlines()
                        if "sample=" in line])
    assert len(samples[0]) == 2 and samples[0] == samples[1]
    assert "[rpc/stream" in runs[0].stdout and "[direct]" in runs[1].stdout


def test_cli_without_a_card_refuses_to_run(capsys):
    """The CLI's default device is the card; with none visible it exits
    non-zero before building anything, naming the missing card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device runs")
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", ARCH, "--reduced"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "no CUDA GPU" in err and "--device cpu" in err


# ---------------------------------------------------------------------------
# the reduced RWKV-6: recurrent states carried by the engine
# ---------------------------------------------------------------------------

RWKV = "rwkv6-1.6b"


@pytest.fixture(scope="module")
def rwkv_engines():
    jcfg = jax_reduced(RWKV)
    params = jax_init_params(jax.random.PRNGKey(1), jcfg)
    scfg = dict(max_seq=40, max_new_tokens=5)
    jeng = JaxServeEngine(NO_MESH, jcfg, params, JaxServeConfig(**scfg))
    teng = ServeEngine(get_reduced_config(RWKV),
                       from_jax_params(jax.tree.map(np.asarray, params)),
                       ServeConfig(**scfg))
    return jeng, teng


def test_rwkv_greedy_tokens_identical_three_ways(rwkv_engines):
    jeng, teng = rwkv_engines
    _, channel = teng.serve_loopback()
    for seed, plen in ((0, 8), (1, 21)):
        prompts = _prompts(2, plen, seed)
        want = jeng.generate(prompts)
        assert want.shape == (2, 5)
        direct = teng.generate(prompts)
        streamed = rpc_generate_stream(channel, prompts)
        unary = serve_stub(channel).generate((prompts, 0)).result()
        for got in (direct, streamed, unary):
            np.testing.assert_array_equal(got, want)


def test_rwkv_preemption_replays_the_recurrent_state(rwkv_engines):
    """A request preempted by the KV budget is rebuilt by replaying its
    prefill and decode steps: the RWKV state it resumes from equals the
    dropped one, so it finishes with the tokens of its solo run."""
    _, teng = rwkv_engines
    p1, p2 = _prompts(1, 8, 4), _prompts(1, 8, 5)
    solo = [teng.generate(p, 4) for p in (p1, p2)]
    sched = ServeScheduler(teng, max_batch=4, kv_blocks=21, block_size=1)
    reqs = [sched.submit(p, 4) for p in (p1, p2)]
    while not all(r.finished for r in reqs):
        sched.step()
    assert sched.counters["preempted"] >= 1
    for req, want in zip(reqs, solo):
        np.testing.assert_array_equal(np.stack(req.tokens, axis=1), want)


def test_rwkv_rebuild_reproduces_the_states(rwkv_engines):
    """scheduler_rebuild's states equal the states of the run it
    replays, tensor for tensor."""
    _, teng = rwkv_engines
    sched = ServeScheduler(teng, max_batch=1)
    req = sched.submit(_prompts(2, 9, 6), 4)
    req.tokens.append(teng.scheduler_prefill(req))
    for _ in range(2):
        req.tokens.append(teng.scheduler_decode(req))
    live = req.runtime[0]
    teng.scheduler_rebuild(req)
    for a, b in zip(live, req.runtime[0]):
        for key in ("S", "shift_tm"):
            assert torch.equal(a["mixer"][key], b["mixer"][key])
        assert torch.equal(a["shift_cm"], b["shift_cm"])


def test_rwkv_cli_serves_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    runs = [subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", RWKV,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "11", "--new-tokens", "3", "--requests", "2", *extra],
        capture_output=True, text=True, env=env, timeout=120)
        for extra in ([], ["--no-rpc"])]
    samples = []
    for r in runs:
        assert r.returncode == 0, r.stderr
        samples.append([line.split("sample=")[1]
                        for line in r.stdout.splitlines()
                        if "sample=" in line])
    assert len(samples[0]) == 2 and samples[0] == samples[1]


# ---------------------------------------------------------------------------
# the reduced MoE and Mamba models: expert routing and Mamba states
# carried by the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["mixtral-8x7b",
                                        "jamba-1.5-large-398b"])
def moe_engines(request):
    jcfg = jax_reduced(request.param)
    params = jax_init_params(jax.random.PRNGKey(2), jcfg)
    scfg = dict(max_seq=80, max_new_tokens=5)
    jeng = JaxServeEngine(NO_MESH, jcfg, params, JaxServeConfig(**scfg))
    teng = ServeEngine(get_reduced_config(request.param),
                       from_jax_params(jax.tree.map(np.asarray, params)),
                       ServeConfig(**scfg))
    return jeng, teng


def test_moe_greedy_tokens_identical_three_ways(moe_engines):
    """Greedy tokens equal the JAX engine's, directly, streamed and
    unary; prompts of 8 and 70 (Jamba's padded Mamba chunk)."""
    jeng, teng = moe_engines
    _, channel = teng.serve_loopback()
    for seed, plen in ((0, 8), (1, 70)):
        prompts = _prompts(2, plen, seed)
        want = jeng.generate(prompts)
        assert want.shape == (2, 5)
        direct = teng.generate(prompts)
        streamed = rpc_generate_stream(channel, prompts)
        unary = serve_stub(channel).generate((prompts, 0)).result()
        for got in (direct, streamed, unary):
            np.testing.assert_array_equal(got, want)


def test_moe_preemption_replays_the_states(moe_engines):
    """Preemption by the KV budget rebuilds a request by replaying it:
    with MoE routing (dropless decode) and Mamba states it finishes with
    the tokens of its solo run, and the rebuilt states equal the live
    ones tensor for tensor."""
    _, teng = moe_engines
    p1, p2 = _prompts(1, 8, 4), _prompts(1, 8, 5)
    solo = [teng.generate(p, 4) for p in (p1, p2)]
    sched = ServeScheduler(teng, max_batch=4, kv_blocks=21, block_size=1)
    reqs = [sched.submit(p, 4) for p in (p1, p2)]
    while not all(r.finished for r in reqs):
        sched.step()
    assert sched.counters["preempted"] >= 1
    for req, want in zip(reqs, solo):
        np.testing.assert_array_equal(np.stack(req.tokens, axis=1), want)
    sched = ServeScheduler(teng, max_batch=1)
    req = sched.submit(_prompts(2, 9, 6), 4)
    req.tokens.append(teng.scheduler_prefill(req))
    for _ in range(2):
        req.tokens.append(teng.scheduler_decode(req))
    live = req.runtime[0]
    teng.scheduler_rebuild(req)
    for a, b in zip(live, req.runtime[0]):
        for x, y in zip(jax.tree.leaves(a, is_leaf=torch.is_tensor),
                        jax.tree.leaves(b, is_leaf=torch.is_tensor)):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b",
                                  "kimi-k2-1t-a32b"])
def test_moe_cli_serves_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
         "11", "--new-tokens", "3", "--requests", "2", "--unary"],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert sum("sample=" in line for line in r.stdout.splitlines()) == 2


def test_gemma2_cli_serves_on_the_cpu():
    """Gemma-2-9B reduced (local window 64 / global, softcaps): a 70-token
    prompt wraps the local layers' ring caches before decoding."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma2-9b", "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "70", "--new-tokens", "4", "--requests", "2"],
        capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert sum("sample=" in line for line in r.stdout.splitlines()) == 2
