"""The reader of ``ssd_kernel.serve`` on hand-built device traces: the
share of the ``serve.prefill`` ranges inside the sub-window that hold a
launch of K6 (kernels named ``ssd_scan_*``), 0 where prefills ran
without K6, and nothing where there is no prefill range, no trace or no
K6 in the program."""
import pytest

from conftest import ROOT

K6 = "void (anonymous namespace)::ssd_scan_chunk<128>(Params)"


def _read(tr):
    from portbench import harness
    reader = harness.load_module(
        ROOT / "portbench" / "metrics" / "ssd_kernel.serve.py",
        "ssd_kernel_serve")
    return reader.read({"trace": tr, "config": {"family": "hybrid"}})


def _trace(scanned=(True, True, False, True), bounds=(0.0, 10.0)):
    """Four prefills, each followed by a decode, every prefill's device
    work starting inside its range: K6's two kernels where ``scanned``,
    the plain loop's cumsum where not."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = bounds, bounds[1] - bounds[0]
    tr.host = [("rpc.flush", 0.1, 9.9)]
    tr.device = []
    for i, s in enumerate(scanned):
        a = 0.5 + 2.0 * i
        tr.host += [("serve.prefill", a, a + 1.0),
                    ("serve.decode", a + 1.2, a + 1.4)]
        tr.device.append(("nvjet_tst_256x160_64x4_2x1_v_bz_TNT",
                          a + 0.1, a + 0.2))
        if s:
            tr.device += [("void (anonymous namespace)::ssd_scan_prep<128>"
                           "(Params)", a + 0.3, a + 0.31), (K6, a + 0.31,
                                                            a + 0.4)]
        else:
            tr.device.append(("void at::native::tensor_kernel_scan_outer_"
                              "dim<float>", a + 0.3, a + 0.4))
        tr.device.append(("moe_decode_gemv<bf16, 2>", a + 1.25, a + 1.3))
    return tr


def test_reads_the_share_of_prefills_that_launch_k6():
    assert _read(_trace()) == pytest.approx(75.0)
    assert _read(_trace(scanned=(True,) * 4)) == pytest.approx(100.0)
    assert _read(_trace(scanned=(False, True, False, False))) == \
        pytest.approx(25.0)


def test_a_k6_launch_outside_every_prefill_counts_for_none():
    tr = _trace(scanned=(False, False, False, True))
    tr.device.append((K6, 1.8, 1.85))                 # in a decode
    assert _read(tr) == pytest.approx(25.0)


def test_a_prefill_the_bounds_cut_is_left_out():
    # the first prefill starts before the bounds, the last ends after
    assert _read(_trace(bounds=(1.0, 6.8))) == pytest.approx(50.0)
    assert _read(_trace(scanned=(False, True, True, False),
                        bounds=(1.0, 6.8))) == pytest.approx(100.0)


def test_zero_where_no_prefill_launches_k6():
    assert _read(_trace(scanned=(False,) * 4)) == 0.0


def test_nothing_where_the_program_has_no_k6(monkeypatch):
    import importlib.util
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == "repro_torch.kernels.ssd_scan"
        else find_spec(name, *a))
    assert _read(_trace(scanned=(False,) * 4)) is None


def test_nothing_without_prefill_ranges_or_a_trace():
    tr = _trace()
    tr.host = [h for h in tr.host if h[0] != "serve.prefill"]
    assert _read(tr) is None
    assert _read(_trace(bounds=(0.6, 1.3))) is None   # cut at both ends
    assert _read(None) is None
