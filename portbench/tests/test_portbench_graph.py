"""The reader of ``decode_graphed.serve`` on hand-built device traces: the
share of ``serve.decode`` ranges holding a ``serve.graph`` range, the
clipping at the trace's bounds, and nothing where the program opens no
``serve.graph`` range or there is no trace."""
import pytest

from conftest import ROOT


def _read(tr):
    from portbench import harness
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / "decode_graphed.serve.py",
        "graph_decode_graphed_serve")
    return reader.read({"trace": tr, "config": {"family": "moe"}})


def _trace(bounds=(0.0, 10.0), graphed=(True, True, False, True)):
    """Four decode ops (the third a capture, which replays nothing) and a
    prefill, each with its launch; a replay's ``serve.graph`` range lies
    in its launch."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = bounds, bounds[1] - bounds[0]
    tr.host = [("rpc.flush", 0.5, 9.5), ("serve.prefill", 0.6, 0.9),
               ("serve.launch", 0.6, 0.7)]
    for i, g in enumerate(graphed):
        a = 1.0 + 2.0 * i
        tr.host += [("serve.decode", a, a + 1.5),
                    ("serve.launch", a, a + 0.5)]
        if g:
            tr.host.append(("serve.graph", a + 0.1, a + 0.3))
    tr.device = [("k", 1.2, 1.4), ("k", 3.2, 3.4)]
    return tr


def test_reads_the_share_of_decodes_that_replay():
    assert _read(_trace()) == pytest.approx(75.0)
    assert _read(_trace(graphed=(True,) * 4)) == pytest.approx(100.0)


def test_a_graph_range_outside_every_decode_counts_for_none():
    tr = _trace(graphed=(True, False, False, False))
    tr.host.append(("serve.graph", 0.65, 0.68))      # in the prefill
    assert _read(tr) == pytest.approx(25.0)


def test_clips_at_the_bounds():
    # the first decode lies before the bounds; the last is cut at 7.6,
    # its replay inside the cut
    assert _read(_trace(bounds=(2.9, 7.6))) == pytest.approx(200.0 / 3)
    # cut at 7.05, before its replay
    assert _read(_trace(bounds=(2.9, 7.05))) == pytest.approx(100.0 / 3)


def test_nothing_without_graph_ranges_or_a_trace():
    assert _read(_trace(graphed=(False,) * 4)) is None
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] != "serve.decode"]
    assert _read(tr) is None
    assert _read(None) is None
