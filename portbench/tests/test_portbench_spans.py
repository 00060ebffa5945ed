"""The readers of the serving path's live regions (``portbench/regions.py``
and the five metrics built on it) on hand-built device traces: the exact
value each returns, the clipping at the trace's bounds, nothing without
a trace or without the ranges, and the idle split never above the
device's idle share."""
import numpy as np
import pytest

from conftest import ROOT

NEW = ("decode_launch_ms.serve", "decode_busy_ms.serve",
       "ops_per_decode.serve", "idle_engine.serve", "idle_stack.serve")


def _reader(name):
    from portbench import harness
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "spans_" + name.replace(".", "_"))


def _trace(bounds=(0.0, 10.0), window_s=10.0):
    """Two decode ops and a prefill inside one flush, kernels and copies
    inside and outside them, a client kernel outside every range."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = bounds, window_s
    tr.host = [("rpc.flush", 1.0, 9.0), ("sched.step", 1.5, 8.0),
               ("serve.decode", 2.0, 4.0), ("serve.launch", 2.0, 3.0),
               ("aten::mm", 2.1, 2.2), ("serve.to_host", 3.0, 4.0),
               ("serve.decode", 5.0, 7.0), ("serve.launch", 5.0, 5.5),
               ("serve.to_host", 5.5, 7.0),
               ("serve.prefill", 8.2, 8.9), ("serve.launch", 8.5, 8.8)]
    tr.device = [("k1", 2.5, 3.5), ("k2", 3.2, 3.8), ("k6", 3.9, 4.5),
                 ("k3", 5.2, 5.4), ("Memcpy DtoH", 6.9, 7.0),
                 ("k4", 8.3, 8.4), ("client", 0.5, 0.7)]
    return tr


def _read_all(tr):
    return {n: _reader(n).read({"trace": tr, "config": {"family": "moe"}})
            for n in NEW + ("device_idle.serve",)}


def test_each_reader_reads_its_value():
    got = _read_all(_trace())
    # launches in the decodes: 1.0 and 0.5 s (the prefill's is not one)
    assert got["decode_launch_ms.serve"] == pytest.approx(750.0)
    # busy inside the decodes: 1.3 + 0.1 and 0.2 + 0.1 s
    assert got["decode_busy_ms.serve"] == pytest.approx(850.0)
    # k1, k2, k6 start in the first decode, k3 and the copy in the second
    assert got["ops_per_decode.serve"] == pytest.approx(2.5)
    # engine ops 2 + 2 + 0.7 s, of which 1.4 + 0.3 + 0.1 busy
    assert got["idle_engine.serve"] == pytest.approx(29.0)
    # the flush less the ops: 1 + 1 + 1.2 + 0.1 s, k6's tail 0.5 busy
    assert got["idle_stack.serve"] == pytest.approx(28.0)
    assert got["device_idle.serve"] == pytest.approx(75.0)


def test_readers_clip_at_the_bounds():
    from portbench import regions
    tr = _trace(bounds=(2.5, 6.0), window_s=3.5)
    assert regions.ranges(tr, "serve.decode") == [(2.5, 4.0), (5.0, 6.0)]
    assert regions.busy(tr) == [(2.5, 3.8), (3.9, 4.5), (5.2, 5.4)]
    got = _read_all(tr)
    assert got["decode_launch_ms.serve"] == pytest.approx(500.0)
    assert got["decode_busy_ms.serve"] == pytest.approx(800.0)
    # k1 starts on the lower bound; the copy after the upper one
    assert got["ops_per_decode.serve"] == pytest.approx(2.0)
    assert got["idle_engine.serve"] == pytest.approx(100 * 0.9 / 3.5)
    assert got["idle_stack.serve"] == pytest.approx(100 * 0.5 / 3.5)


def test_readers_report_nothing_without_the_ranges_or_a_trace():
    tr = _trace()
    tr.host = [iv for iv in tr.host if not iv[0].startswith(
        ("serve.", "rpc.", "sched."))]
    got = _read_all(tr)
    assert all(got[n] is None for n in NEW)
    assert got["device_idle.serve"] == pytest.approx(75.0)
    for n in NEW:
        assert _reader(n).read({"trace": None}) is None
        assert _reader(n).read({}) is None


def _random_trace(rng):
    """Device work inside the bounds, as ``DeviceTrace`` records it
    (synchronised before the start and before the end); host ranges
    anywhere, the ops inside flushes or astride their edges."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    lo, hi = sorted(rng.uniform(0, 10, 2))
    tr.bounds, tr.window_s = (lo, hi), (hi - lo) * rng.uniform(1.0, 1.01)
    starts = rng.uniform(lo, hi, 40)
    tr.device = [("k", a, min(hi, a + d))
                 for a, d in zip(starts, rng.exponential(0.1, 40))]
    host = []
    t = rng.uniform(-1, 1)
    while t < 11:
        f = t + rng.exponential(1.0)
        host.append(("rpc.flush", t, f))
        s = t + rng.uniform(-0.2, 0.2)
        while s < f + 0.2:
            e = s + rng.exponential(0.3)
            name = rng.choice(["serve.decode", "serve.prefill",
                               "serve.rebuild"])
            host += [(name, s, e), ("serve.launch", s, (s + e) / 2)]
            s = e + rng.exponential(0.2)
        t = f + rng.exponential(0.3)
    tr.host = host
    return tr


def test_the_idle_split_stays_within_the_device_idle_share():
    rng = np.random.default_rng(25)
    for _ in range(200):
        got = _read_all(_random_trace(rng))
        split = (got["idle_engine.serve"] or 0.0) \
            + (got["idle_stack.serve"] or 0.0)
        assert 0.0 <= split <= got["device_idle.serve"] + 1e-9
        if got["decode_launch_ms.serve"] is not None:
            assert got["decode_busy_ms.serve"] is not None
