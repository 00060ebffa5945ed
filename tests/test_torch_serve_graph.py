"""The serve engine's decode slots and their CUDA graphs.

On a CUDA device each request decodes from a fixed slot whose batch-1
decode step is captured once as a CUDA graph and replayed for every later
token; on the CPU the step runs eagerly. The card's tests hold the
graphed engine's greedy tokens equal to a plain eager loop over
``make_decode_step`` on reduced Mixtral (MoE), Gemma-2 (a windowed ring
past its wrap, softcap) and RWKV-6 (recurrent states), a reused slot to a
fresh engine, a preempted and rebuilt request to an uninterrupted one,
and the engine's counters to the slots and decodes; and a small
Granite-4.0-H, whose slot holds a KV cache beside Mamba-2 states. Imports torch only,
so the card's tests run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import rpc
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.launch import steps
from repro_torch.models import init_params
from repro_torch.models.attention import KVCache
from repro_torch.serve.engine import (ServeConfig, ServeEngine, _copy_new,
                                      _DecodeSlot, decode_token_chunk,
                                      serve_stub)
from repro_torch.serve.scheduler import Request, ServeScheduler

#: arch -> (prompt length, new tokens): Gemma-2's prompt of 70 lies past
#: its reduced window of 64, so its ring has wrapped before the decode
FAMILIES = {"mixtral-8x7b": (9, 8), "gemma2-9b": (70, 9),
            "rwkv6-1.6b": (11, 8)}
MAX_SEQ = 96


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _engine(arch, device, dtype="float32", **cfg):
    acfg = get_reduced_config(arch)
    acfg = acfg.replace(train=dataclasses.replace(acfg.train,
                                                  compute_dtype=dtype))
    params = init_params(acfg, device=device,
                         generator=torch.Generator(device).manual_seed(0))
    return ServeEngine(acfg, params, ServeConfig(
        max_seq=MAX_SEQ, max_new_tokens=16, **cfg))


def _granite_engine(device):
    """Granite-4.0-H at a small size in float32: one period of 10 (nine
    Mamba-2 layers, attention at position 5), 8 experts top-3 beside a
    shared expert, the multipliers as published."""
    a = get_config("granite-4.0-h-small")
    m = a.model
    model = dataclasses.replace(
        m, d_model=64, d_ff=24, vocab_size=128, max_position_embeddings=4096,
        attention=dataclasses.replace(m.attention, n_heads=4, n_kv_heads=2,
                                      d_head=16, softmax_scale=0.125),
        moe=dataclasses.replace(m.moe, num_experts=8, top_k=3,
                                d_ff_expert=24, d_ff_shared=32),
        ssm=dataclasses.replace(m.ssm, d_state=16))
    acfg = a.replace(model=model, train=dataclasses.replace(
        a.train, param_dtype="float32", compute_dtype="float32"))
    params = init_params(acfg, device=device,
                         generator=torch.Generator(device).manual_seed(0))
    return ServeEngine(acfg, params, ServeConfig(max_seq=MAX_SEQ,
                                                 max_new_tokens=16))


def _prompt(plen, seed, rows=1):
    return np.random.default_rng(seed).integers(0, 128, (rows, plen),
                                                dtype=np.int32)


def _eager_tokens(eng, prompt, n):
    """Greedy tokens of a plain loop: the engine's prefill, then
    ``make_decode_step`` eagerly, step by step."""
    states, logits = eng._prefill(
        eng.params, {"tokens": torch.as_tensor(prompt, device=eng.device)})
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    decode = steps.make_decode_step(eng.acfg, prompt.shape[0])
    for _ in range(n - 1):
        states, logits = decode(eng.params, states, tok[:, None], None)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def _run_all(sched, prompts_and_lens):
    reqs = [sched.submit(p, n) for p, n in prompts_and_lens]
    while not all(r.finished for r in reqs):
        sched.step()
    return [np.stack(r.tokens, axis=1) for r in reqs]


def _n_slots(eng):
    return sum(len(v) for v in eng._slots.values())


# ---------------------------------------------------------------------------
# the CPU: eager decode, and the slots' bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_the_cpu_engine_decodes_eagerly(arch):
    plen, n = FAMILIES[arch]
    eng = _engine(arch, "cpu")
    got = eng.generate(_prompt(plen, 1), n)
    np.testing.assert_array_equal(got, _eager_tokens(eng, _prompt(plen, 1),
                                                     n))
    assert eng.counters == {"graph_captures": 0, "graph_replays": 0,
                            "eager_decodes": n - 1}
    assert _n_slots(eng) == 0


def _states(device="cpu"):
    return [{"mixer": KVCache(torch.zeros(1, 4, 1, 2, device=device),
                              torch.zeros(1, 4, 1, 2, device=device),
                              torch.zeros((), dtype=torch.int64,
                                          device=device))},
            {"mixer": {"S": torch.zeros(1, 3, device=device)}}]


def test_a_slot_is_free_once_its_owner_drops_its_states():
    states = _states()
    slot = _DecodeSlot(states, torch.zeros(1, dtype=torch.int64))
    assert slot.tok.shape == (1, 1) and slot.free()
    req = Request(1, _prompt(3, 0), 2)
    slot.owner = req
    req.runtime = (states, None, None)
    assert not slot.free()
    req.runtime = (_states(), None, None)      # decodes from another slot
    assert slot.free()
    req.runtime = (states, None, None)
    assert not slot.free()
    req.runtime = None                         # finished or preempted
    assert slot.free()


def test_copy_new_copies_what_the_step_did_not_write_in_place():
    static = _states()
    cache = static[0]["mixer"]
    cache.k[0, 1] = 7.0                        # a write in place
    new = [{"mixer": KVCache(cache.k, cache.v,
                             torch.tensor(5, dtype=torch.int64))},
           {"mixer": {"S": torch.full((1, 3), 2.0)}}]
    _copy_new(static, new)
    assert int(static[0]["mixer"].index) == 5
    assert static[1]["mixer"]["S"].eq(2.0).all()
    assert static[0]["mixer"].k is cache.k and cache.k[0, 1].eq(7.0).all()


# ---------------------------------------------------------------------------
# the card: graphs
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_graphed_tokens_equal_an_eager_loop_on_the_card(cuda, arch):
    plen, n = FAMILIES[arch]
    eng = _engine(arch, cuda)
    for seed in (1, 2):                        # a capture, then a replay
        got = eng.generate(_prompt(plen, seed), n)
        np.testing.assert_array_equal(
            got, _eager_tokens(eng, _prompt(plen, seed), n))
    assert eng.counters == {"graph_captures": 1,
                            "graph_replays": 2 * (n - 1) - 1,
                            "eager_decodes": 0}


@pytest.mark.gpu
def test_graphed_granite_tokens_equal_an_eager_loop_on_the_card(cuda):
    """Both kinds of state live in the slot one graph reads and writes:
    the attention layer's KV cache and the Mamba-2 layers' SSM states
    and conv histories; the graphed tokens equal an eager loop's."""
    eng = _granite_engine(cuda)
    prompt = _prompt(70, 3)
    got = eng.generate(prompt, 9)
    np.testing.assert_array_equal(got, _eager_tokens(eng, prompt, 9))
    assert eng.counters == {"graph_captures": 1, "graph_replays": 7,
                            "eager_decodes": 0}
    slot, = eng._slots[1]
    kinds = eng.acfg.model.layer_pattern
    for st, kind in zip(slot.states, kinds):
        if kind == "attn":
            assert isinstance(st["mixer"], KVCache)
        else:
            assert set(st["mixer"]) == {"h", "conv", "conv_bc"}
            assert st["mixer"]["h"].shape == (1, 2, 64, 16)
    assert kinds.count("attn") == 1 and kinds.count("mamba") == 9


@pytest.mark.gpu
def test_graphed_bf16_mixtral_tokens_equal_an_eager_loop_on_the_card(cuda):
    """bf16 compute, as the benchmark serves: the same kernels in the
    graph and eagerly, so the same tokens."""
    plen, n = FAMILIES["mixtral-8x7b"]
    eng = _engine("mixtral-8x7b", cuda, dtype="bfloat16")
    for seed in (1, 2):
        np.testing.assert_array_equal(
            eng.generate(_prompt(plen, seed), n),
            _eager_tokens(eng, _prompt(plen, seed), n))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_a_reused_slot_decodes_as_a_fresh_engine(cuda, arch):
    plen, n = FAMILIES[arch]
    used = _engine(arch, cuda)
    used.generate(_prompt(plen + 3, 5), n + 2)
    got = used.generate(_prompt(plen, 6), n)
    assert _n_slots(used) == 1
    fresh = _engine(arch, cuda)
    np.testing.assert_array_equal(got, fresh.generate(_prompt(plen, 6), n))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_a_rebuilt_request_decodes_as_an_uninterrupted_one(cuda, arch):
    """The KV budget preempts the later joiner; its rebuild replays its
    prefill and decodes through a slot, and it finishes with the tokens
    of its solo run."""
    plen, n = FAMILIES[arch]
    eng = _engine(arch, cuda)
    work = [(_prompt(plen, 7), n), (_prompt(plen, 8), n)]
    solo = [eng.generate(p, k) for p, k in work]
    sched = ServeScheduler(eng, max_batch=4,
                           kv_blocks=2 * plen + n + 1, block_size=1)
    got = _run_all(sched, work)
    assert sched.counters["preempted"] >= 1
    for g, want in zip(got, solo):
        np.testing.assert_array_equal(g, want)
    assert eng.counters["eager_decodes"] == 0


@pytest.mark.gpu
def test_counters_count_one_capture_a_slot_and_replays_after(cuda):
    plen, _ = FAMILIES["mixtral-8x7b"]
    eng = _engine("mixtral-8x7b", cuda)
    lens = (3, 6, 4)
    work = [(_prompt(plen + i, 10 + i), k) for i, k in enumerate(lens)]
    decodes = sum(k - 1 for k in lens)
    _run_all(eng.make_scheduler(max_batch=4), work)
    assert _n_slots(eng) == 3
    assert eng.counters == {"graph_captures": 3,
                            "graph_replays": decodes - 3,
                            "eager_decodes": 0}
    _run_all(eng.make_scheduler(max_batch=4), work)   # the slots reused
    assert _n_slots(eng) == 3
    assert eng.counters == {"graph_captures": 3,
                            "graph_replays": 2 * decodes - 3,
                            "eager_decodes": 0}


@pytest.mark.gpu
def test_each_replay_is_a_serve_graph_region_in_its_decode(cuda):
    """Over a traced loopback fabric, each decode op that replays holds
    one ``serve.graph`` range inside its ``serve.launch``; the tokens are
    those of an untraced fabric."""
    eng = _engine("mixtral-8x7b", cuda)
    requests = ((8, 3), (11, 5), (6, 4))

    def serve(tracer=None):
        fabric, channel = eng.serve_loopback(tracer=tracer, max_batch=4)
        stub = serve_stub(channel)
        handles = [stub.generate_stream((_prompt(s, 20 + s), n))
                   for s, n in requests]
        fabric.flush()
        assert all(h.error is None for h in handles)
        return [[int(decode_token_chunk(c)[0]) for c in h.chunks]
                for h in handles]

    want = serve()                             # captures every slot
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = serve(rpc.Tracer())
    assert got == want
    names = ("serve.decode", "serve.launch", "serve.graph")
    ranges = sorted(((ev.name(), ev.start_ns(),
                      ev.start_ns() + ev.duration_ns())
                     for ev in prof.profiler.kineto_results.events()
                     if ev.name() in names), key=lambda r: (r[1], -r[2]))

    def inside(inner, outer):
        return outer[1] <= inner[1] and inner[2] <= outer[2]
    decodes = [r for r in ranges if r[0] == "serve.decode"]
    assert len(decodes) == sum(n - 1 for _, n in requests)
    for op in decodes:
        (launch,) = [r for r in ranges if r[0] == "serve.launch"
                     and inside(r, op)]
        graphs = [r for r in ranges if r[0] == "serve.graph"
                  and inside(r, op)]
        assert len(graphs) == 1 and inside(graphs[0], launch)
