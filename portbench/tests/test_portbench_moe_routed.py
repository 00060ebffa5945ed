"""The reader of ``moe_routed.serve`` on hand-built device traces: the
share of ``serve.decode`` ranges holding a launch of K5 (kernels named
``moe_decode_*``), 0 where decodes ran without K5, and nothing where
there is no decode range, no trace or no K5 in the program."""
import pytest

from conftest import ROOT

K5 = "void (anonymous namespace)::moe_decode_gemv<__nv_bfloat16>(Gemv)"


def _read(tr):
    from portbench import harness
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / "moe_routed.serve.py",
        "moe_routed_serve")
    return reader.read({"trace": tr, "config": {"family": "moe"}})


def _trace(routed=(True, True, False, True), bounds=(0.0, 10.0)):
    """A prefill (its dense expert GEMMs) and four decode ops, each
    decode's device work starting inside its range: K5's kernels where
    ``routed``, a library GEMM where not."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = bounds, bounds[1] - bounds[0]
    tr.host = [("rpc.flush", 0.5, 9.5), ("serve.prefill", 0.6, 0.9)]
    tr.device = [("nvjet_tst_256x160_64x4_2x1_v_bz_TNT", 0.65, 0.7)]
    for i, r in enumerate(routed):
        a = 1.0 + 2.0 * i
        tr.host.append(("serve.decode", a, a + 1.5))
        if r:
            tr.device += [(K5, a + 0.2, a + 0.3),
                          ("void (anonymous namespace)::moe_decode_sum"
                           "<__nv_bfloat16>(float const*, __nv_bfloat16*, "
                           "int, int, int)", a + 0.3, a + 0.35)]
        else:
            tr.device.append(("nvjet_tst_192x8_64x3_4x1_v_bz_TNN",
                              a + 0.2, a + 0.3))
    return tr


def test_reads_the_share_of_decodes_that_launch_k5():
    assert _read(_trace()) == pytest.approx(75.0)
    assert _read(_trace(routed=(True,) * 4)) == pytest.approx(100.0)
    assert _read(_trace(routed=(False, True, False, False))) == \
        pytest.approx(25.0)


def test_a_k5_launch_outside_every_decode_counts_for_none():
    tr = _trace(routed=(False, False, False, True))
    tr.device.append((K5, 0.7, 0.75))                # in the prefill
    assert _read(tr) == pytest.approx(25.0)


def test_clips_at_the_bounds():
    # the first decode lies before the bounds, the last is cut at 7.25,
    # after its K5 launches began
    assert _read(_trace(bounds=(2.9, 7.25))) == pytest.approx(200.0 / 3)


def test_zero_where_no_decode_launches_k5():
    assert _read(_trace(routed=(False,) * 4)) == 0.0
    tr = _trace(routed=(False,) * 4)
    tr.device.append((K5, 0.7, 0.75))                # in the prefill
    assert _read(tr) == 0.0


def test_nothing_where_the_program_has_no_k5(monkeypatch):
    import importlib.util
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "repro_torch.kernels.moe_decode"
        else find_spec(name, *a))
    assert _read(_trace(routed=(False,) * 4)) is None


def test_nothing_without_decode_ranges_or_a_trace():
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] != "serve.decode"]
    assert _read(tr) is None
    assert _read(None) is None
