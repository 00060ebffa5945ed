"""The serving path's live regions: with a tracer, each decode op is a
``decode_step`` span in its call's tree, and under ``torch.profiler`` the
regions nest as ranges (``rpc.flush`` > ``sched.step`` > ``serve.decode``
> ``serve.launch``, then ``serve.to_host``), one ``serve.decode`` a
decode op; without a tracer no region is entered; the tokens do not
change. A reduced Mixtral (MoE) served over the loopback fabric; imports
torch only, so the card's test runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_serve_spans.py
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import rpc
from repro_torch.configs import get_reduced_config
from repro_torch.models import init_params
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import (ServeConfig, ServeEngine,
                                      decode_token_chunk, serve_stub)

REGIONS = ("rpc.flush", "sched.step", "serve.prefill", "serve.rebuild",
           "serve.decode", "serve.launch", "serve.to_host")
#: (prompt length, answer length) of the requests served at once
REQUESTS = ((8, 3), (11, 5), (6, 4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(device="cpu"):
    acfg = get_reduced_config("mixtral-8x7b")
    params = init_params(acfg, device=device,
                         generator=torch.Generator(device).manual_seed(0))
    return ServeEngine(acfg, params, ServeConfig(max_seq=32,
                                                 max_new_tokens=8))


def _serve(eng, tracer=None, requests=REQUESTS, kv_blocks=None):
    """Serves ``requests`` at once over a fresh loopback fabric; returns
    the handles' tokens and the handles."""
    fabric, channel = eng.serve_loopback(tracer=tracer, max_batch=4,
                                         kv_blocks=kv_blocks)
    stub = serve_stub(channel)
    rng = np.random.default_rng(0)
    handles = [stub.generate_stream(
        (rng.integers(0, 128, (1, s), dtype=np.int32), n))
        for s, n in requests]
    fabric.flush()
    assert all(h.error is None for h in handles)
    return [[int(decode_token_chunk(c)[0]) for c in h.chunks]
            for h in handles], handles


def _ranges(prof):
    """The regions' host ranges in the profile, as (name, start, end) in
    nanoseconds, by start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.name() in REGIONS]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_each_decode_op_is_a_decode_step_span_of_its_call():
    eng = _engine()
    tracer = rpc.Tracer()
    tokens, handles = _serve(eng, tracer)
    roots = {r.attrs["call_id"]: r for r in tracer.calls()}
    for (_, n), toks, h in zip(REQUESTS, tokens, handles):
        assert len(toks) == n
        spans = list(roots[h.call_id].walk())
        steps = [s for s in spans if s.name == "decode_step"]
        # the first token comes from the prefill, each later one from a
        # decode op
        assert len(steps) == n - 1
        assert all(s.category == "server" and s.endpoint == 0
                   and s.closed for s in steps)
        assert len({s.attrs["request"] for s in steps}) == 1
        # the prefill op is the scheduler's prefill phase, not a span
        # of its own beside it
        names = [s.name for s in spans]
        assert names.count("prefill") == 1
        assert not any(name.startswith("serve.") for name in names)
    assert len(eng.op_seconds["decode"]) == sum(n - 1 for _, n in REQUESTS)


def test_regions_nest_as_profiler_ranges():
    eng = _engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(eng, rpc.Tracer())
    got = _ranges(prof)
    by = {name: [r for r in got if r[0] == name] for name in REGIONS}
    decodes = by["serve.decode"]
    assert len(decodes) == len(eng.op_seconds["decode"]) \
        == sum(n - 1 for _, n in REQUESTS)
    assert len(by["serve.prefill"]) == len(REQUESTS)
    for op in decodes + by["serve.prefill"]:
        step = [s for s in by["sched.step"] if _inside(op, s)]
        assert len(step) == 1
        assert any(_inside(step[0], f) for f in by["rpc.flush"])
        launch = [r for r in by["serve.launch"] if _inside(r, op)]
        to_host = [r for r in by["serve.to_host"] if _inside(r, op)]
        assert len(launch) == len(to_host) == 1
        assert launch[0][2] <= to_host[0][1]


def test_a_preempted_request_rebuilds_inside_its_region():
    """Three 15-token prompts fill a 3-block budget; their second tokens
    preempt two of them, whose rebuilds are ``serve.rebuild`` ranges
    (each around one ``serve.launch``) inside a step."""
    eng = _engine()
    requests = ((15, 4),) * 3
    want, _ = _serve(eng, requests=requests)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = _serve(eng, rpc.Tracer(), requests, kv_blocks=3)
    assert got == want
    ranges = _ranges(prof)
    rebuilds = [r for r in ranges if r[0] == "serve.rebuild"]
    assert rebuilds
    for op in rebuilds:
        assert any(_inside(op, s) for s in ranges if s[0] == "sched.step")
        assert len([r for r in ranges if r[0] == "serve.launch"
                    and _inside(r, op)]) == 1


def test_no_tracer_enters_no_region(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a region was entered without a tracer")
    monkeypatch.setattr(engine_mod, "profiler_range", refuse)
    monkeypatch.setattr(rpc.Tracer, "region", refuse)
    eng = _engine()
    tokens, _ = _serve(eng)
    assert [len(t) for t in tokens] == [n for _, n in REQUESTS]
    # the check bites: a traced fabric enters the refusing region
    with pytest.raises(AssertionError, match="without a tracer"):
        _serve(eng, rpc.Tracer())


def test_the_private_range_of_function_scope_is_there():
    """``profiler_range`` rides torch's private ``_RecordFunctionFast``:
    a torch release without it fails here, by name, and not as an
    AttributeError in every traced serving run."""
    fast = getattr(getattr(torch._C, "_profiler", None),
                   "_RecordFunctionFast", None)
    assert fast is not None, (
        f"torch {torch.__version__} has no "
        f"torch._C._profiler._RecordFunctionFast: models/layers.py "
        f"profiler_range needs another range of function scope")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with engine_mod.profiler_range("serve.probe"):
            pass
    assert [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.name() == "serve.probe"] == ["serve.probe"]


def test_tokens_are_the_same_with_and_without_a_tracer():
    eng = _engine()
    plain, _ = _serve(eng)
    traced, _ = _serve(eng, rpc.Tracer())
    again, _ = _serve(eng)
    assert plain == traced == again


@pytest.mark.gpu
def test_decode_ranges_hold_their_tokens_copy_on_the_card():
    """On the card, each ``serve.decode`` range holds the device
    interval of its token's copy to the host (the device-to-host copy
    that an aten op inside its ``serve.to_host`` launched, found by the
    profiler's correlation ids): host ranges and device operations share
    one clock. Prints the largest overhang."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    eng = _engine("cuda")
    _serve(eng, rpc.Tracer())           # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve(eng, rpc.Tracer())
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    aten = [(ev.correlation_id(), ev.start_ns()) for ev in events
            if ev.name().startswith("aten::") and ev.device_type() != cuda]
    copies = {ev.linked_correlation_id():
              (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in events if ev.device_type() == cuda
              and "DtoH" in ev.name() and not ev.is_user_annotation()}
    got = _ranges(prof)
    decodes = [r for r in got if r[0] == "serve.decode"]
    assert len(decodes) == sum(n - 1 for _, n in REQUESTS)
    # the least room between each copy and its range's start / end
    # (negative: the copy overhangs the range)
    before = after = None
    for op in decodes:
        (to_host,) = [r for r in got if r[0] == "serve.to_host"
                      and _inside(r, op)]
        mine = {copies[c] for c, t in aten
                if to_host[1] <= t <= to_host[2] and c in copies}
        assert len(mine) == 1, mine
        ((a, b),) = mine
        before = a - op[1] if before is None else min(before, a - op[1])
        after = op[2] - b if after is None else min(after, op[2] - b)
    overhang = max(0, -before, -after)
    print(f"decode ops {len(decodes)}: a token's copy starts at least "
          f"{before / 1e3:.3f} us into its serve.decode range and ends at "
          f"least {after / 1e3:.3f} us before the range's end; largest "
          f"overhang {overhang / 1e3:.3f} us "
          f"({torch.cuda.get_device_name(0)})")
    assert overhang < 50_000
