"""Kimi-K2's benchmark pieces: ``yardstick/mla.py``'s counts against a
hand count at the published widths; a tiny ``kimi_k2`` cell, as data
files only, served through the harness on the CPU (correct, and its
three readers reading in a traced run); the three readers on hand-built
records; and each reader reading nothing where the program has no MLA
(another family, no share count in ``DROPS``, no trace).

The tiny configuration keeps every number the harness does not set from
the file at the published value (the router's 384 experts, MLA's ranks
and head dims): the port takes those from its registry entry, and the
experts' widths from the weights it is handed."""
import json
import math

import pytest

from conftest import ROOT, write_tiny

CELL = "tiny-kimi.serve"
PUB = json.loads((ROOT / "portbench" / "configs"
                  / "kimi-k2-instruct.json").read_text())
#: float32 on both sides: the program's gaps read 1e-6 or less
GAP_LIMIT = 1e-4
TINY_KIMI = dict(
    PUB, hidden_size=64, intermediate_size=40, num_attention_heads=4,
    num_key_value_heads=4, moe_intermediate_size=24, num_hidden_layers=3,
    num_local_experts=4, vocab_size=128, torch_dtype="float32")


def _reader(name):
    from portbench import harness
    return harness.load_module(ROOT / "portbench" / "metrics"
                               / f"{name}.py", name.replace(".", "_"))


# --- the yardstick, by hand --------------------------------------------

def test_mla_weights_and_decode_bytes_by_hand():
    from portbench.yardstick import mla
    d, H = 7168, 64
    mla_w = (d * 1536 + 1536 + 1536 * H * 192 + d * 576 + 512
             + 512 * H * 256 + H * 128 * d)
    assert mla.mla_params(PUB) == mla_w == 101_124_096
    shared = 3 * d * 2048
    held = 8 * 8 / 384 * shared           # a token's held experts, mean
    want = 2 * (163840 * d + d + 61 * (mla_w + 2 * d) + 3 * d * 18432
                + 60 * ((d + 1) * 384 + shared + held) + 61 * 2048 * 576)
    assert mla.decode_bytes(PUB, 2048) == pytest.approx(want, rel=1e-12)
    assert 22.0e9 < want < 22.2e9


def test_prefill_flops_by_hand():
    from portbench.yardstick import mla
    S, d = 1905, 7168
    pairs = S * (S + 1) // 2
    attn = 2 * 64 * (192 + 128) * pairs
    layer = 2 * S * 101_124_096 + attn
    moe = 2 * S * ((d + 1) * 384 + 3 * d * 2048) \
        + 2 * (S * 8 * 8 / 384) * 3 * d * 2048
    want = 2 * d * 163840 + (layer + 2 * S * 3 * d * 18432) + 60 * (
        layer + moe)
    assert mla.prefill_flops(PUB, S) == pytest.approx(want, rel=1e-12)
    assert 41e12 < want < 43e12
    # held assignments as counted move the held experts' part alone
    assert mla.prefill_flops(PUB, S, held=0) == pytest.approx(
        want - 60 * 2 * (S * 8 * 8 / 384) * 3 * d * 2048, rel=1e-12)


def test_k3_bound_is_flops_at_the_unpadded_dims():
    from portbench.yardstick import mla
    from portbench.yardstick.peaks import BF16_FLOPS, HBM_BPS
    S = 1905
    flops = 2 * 64 * 320 * S * (S + 1) / 2
    nbytes = 2 * S * 64 * (2 * 192 + 2 * 128)
    assert flops / BF16_FLOPS > nbytes / HBM_BPS
    assert mla.k3_bound(PUB, S) == pytest.approx(flops / BF16_FLOPS)


# --- the readers on hand-built records --------------------------------

def _trace(n_prefill=2, layers=61, k3_s=1e-4, decode_busy=0.01):
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = (0.0, 10.0), 10.0
    tr.host, tr.device = [], []
    t = 0.5
    for _ in range(n_prefill):
        tr.host.append(("serve.prefill", t, t + 1.0))
        for li in range(layers):
            a = t + 0.01 * li
            tr.device.append(("void fa_fwd_wgmma_bf16<256>(Params)", a,
                              a + k3_s))
        t += 1.2
        tr.host.append(("serve.decode", t, t + 0.02))
        tr.device.append(("moe_decode_gemv<bf16, 2>", t + 0.001,
                          t + 0.001 + decode_busy))
        t += 0.1
    return tr


def test_the_decode_roofline_reads_bytes_over_busy_time():
    from portbench.yardstick.mla import decode_bytes
    from portbench.yardstick.peaks import HBM_BPS
    rec = {"config": PUB, "trace": _trace(), "prefill_lens": [1000, 3000]}
    got = _reader("mla_decode_roofline.serve").read(rec)
    assert got == pytest.approx(100 * 2 * decode_bytes(PUB, 2000)
                                / (0.02 * HBM_BPS))


def test_k3_mla_roofline_reads_the_bound_over_k3_time():
    from portbench.yardstick.mla import k3_bound
    rec = {"config": PUB, "trace": _trace(),
           "trace_prefill_lens": [1000, 3000]}
    got = _reader("k3_mla_roofline.serve").read(rec)
    want = 100 * 61 * (k3_bound(PUB, 1000) + k3_bound(PUB, 3000)) \
        / (2 * 61 * 1e-4)
    assert got == pytest.approx(want)
    # a launch count that is not one a layer a prefill reads nothing
    rec["trace"] = _trace(layers=60)
    assert _reader("k3_mla_roofline.serve").read(rec) is None


def test_the_prefill_mfu_takes_the_held_share_counted(monkeypatch):
    """40 of 1000 assignments routed to held experts, 10 of them dropped:
    the held experts compute 3 % of the prefills' assignments."""
    from portbench.yardstick.mla import prefill_flops
    from portbench.yardstick.peaks import BF16_FLOPS
    from repro_torch.models import moe
    monkeypatch.setattr(moe.DROPS, "read", lambda: (10, 40))
    monkeypatch.setattr(moe.DROPS, "assigned", 1000)
    rec = {"config": PUB, "trace": _trace(), "prefill_lens": [1000, 3000],
           "op_seconds": {"prefill": [0.1, 0.3]}}
    got = _reader("mla_prefill_mfu.serve").read(rec)
    want = sum(prefill_flops(PUB, s, held=0.03 * s * 8)
               for s in (1000, 3000)) / (0.4 * BF16_FLOPS)
    assert got == pytest.approx(100 * want)
    monkeypatch.setattr(moe.DROPS, "assigned", 0)
    assert _reader("mla_prefill_mfu.serve").read(rec) is None
    # a program whose count has no total of assignments (the parent's)
    monkeypatch.delattr(moe.DROPS, "assigned")
    assert _reader("mla_prefill_mfu.serve").read(rec) is None


@pytest.mark.parametrize("name", ["mla_prefill_mfu.serve",
                                  "mla_decode_roofline.serve",
                                  "k3_mla_roofline.serve"])
def test_nothing_where_the_program_has_no_mla(name, monkeypatch):
    rec = {"config": PUB, "trace": _trace(), "prefill_lens": [1000],
           "trace_prefill_lens": [1000, 3000],
           "op_seconds": {"prefill": [0.1]}}
    other = dict(rec, config={"family": "moe", "num_hidden_layers": 61})
    assert _reader(name).read(other) is None
    assert _reader(name).read(dict(rec, trace=None)) is None
    if name == "mla_prefill_mfu.serve":
        # a program without the MoE module
        import sys
        monkeypatch.setitem(sys.modules, "repro_torch.models.moe", None)
        assert _reader(name).read(rec) is None


# --- the tiny cell through the harness ----------------------------------

@pytest.fixture(scope="module")
def kimi_dir(tmp_path_factory):
    d = write_tiny(tmp_path_factory.mktemp("kimi"))
    (d / "configs" / "tiny-kimi.json").write_text(json.dumps(TINY_KIMI))
    serve = json.loads((d / "mixes" / "tiny-serve.json").read_text())
    (d / "mixes" / "tiny-hybrid.json").write_text(
        json.dumps(dict(serve, kind="serve_hybrid")))
    (d / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": GAP_LIMIT}}))
    bench = json.loads((d / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-kimi",
                               "traffic": "tiny-hybrid", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-moe.serve" in m.get("workloads", ()) \
                or "kimi-k2-instruct.azure-code" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def test_the_tiny_cell_serves_correct_through_the_engine(kimi_dir):
    from portbench import harness
    h = harness.Harness(CELL, 2**31 + 13, 2.0, False, device="cpu",
                        data_dir=kimi_dir)
    arch = h.arch_config().model
    assert (arch.moe.num_experts, arch.moe.n_routed) == (4, 384)
    assert arch.moe.is_share and arch.attention.mla
    result, _, notes = harness.run_cell(h)
    assert result["correct"], (result, notes)
    assert result["attempted"] > 4 and result["failed"] == 0
    assert result["compared"]["max_logit_gap"]["value"] < 1e-5, notes
    assert math.isfinite(result["metrics"]["served_tok_s"]["value"])
