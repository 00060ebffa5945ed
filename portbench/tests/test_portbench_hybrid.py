"""The ``serve_hybrid`` kind on a tiny Granite-4.0-H cell that exists only
as data files (a configuration of the ``granitemoehybrid`` family, the
Azure mix's parameters under the new kind, a cell with its limit), run
through the harness on the CPU; the faults that must make ``correct``
false; and the four readers the family adds, on hand-built traces.

The tiny configuration keeps every number the harness does not set from
the file at the registry's published value (d_state 128, the shared
expert of 1536, the multipliers, the softmax scale), so the reference,
which reads them from the file, computes what the port runs."""
import json

import pytest
import torch

from conftest import ROOT, _mix, write_tiny

CELL = "tiny-granite.serve"
#: the tiny cell's limit on the widest logit gap: float32 on both sides
#: (the program's gaps read 1e-9 or less), under logits whose spread is
#: about 2e-3 (the tied head over an embedding of 0.004)
GAP_LIMIT = 1e-5
TINY_GRANITE = dict(
    json.loads((ROOT / "portbench" / "configs" / "granite-4.0-h-small.json")
               .read_text()),
    hidden_size=64, intermediate_size=24, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, num_hidden_layers=10,
    num_local_experts=8, num_experts_per_tok=3, vocab_size=128,
    mamba_n_heads=2, torch_dtype="float32")


@pytest.fixture(scope="module")
def hybrid_dir(tmp_path_factory):
    d = write_tiny(tmp_path_factory.mktemp("hybrid"))
    (d / "configs" / "tiny-granite.json").write_text(
        json.dumps(TINY_GRANITE))
    serve = json.loads((d / "mixes" / "tiny-serve.json").read_text())
    (d / "mixes" / "tiny-hybrid.json").write_text(
        json.dumps(dict(serve, kind="serve_hybrid")))
    (d / "cells" / f"{CELL}.json").write_text(json.dumps(
        {"limits": {"max_logit_gap": GAP_LIMIT}}))
    bench = json.loads((d / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny-granite",
                               "traffic": "tiny-hybrid", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny-moe.serve" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return d


def _run(d, seed=5, trace=False, control=()):
    from portbench import harness
    h = harness.Harness(CELL, seed, 2.0, trace, device="cpu", data_dir=d)
    return harness.run_cell(h, control=control)


def test_the_mix_is_the_azure_mix_under_the_new_kind():
    a, b = _mix("azure-code"), _mix("azure-code-hybrid")
    assert b.pop("kind") == "serve_hybrid" and a.pop("kind") == "serve_stream"
    assert a == b


def test_the_tiny_cell_serves_correct_through_the_engine(hybrid_dir):
    result, checks, notes = _run(hybrid_dir, seed=2**31 + 11)
    assert result["correct"], (result, notes)
    assert result["attempted"] > 4 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "served_tok_s"}
    assert result["compared"]["max_logit_gap"]["value"] < 1e-7, notes


def test_the_kind_leaves_serve_stream_drawing_its_own_weights(hybrid_dir):
    """The family's draw is set on a copy of ``serve_stream``; the kind
    itself still draws ``weights.py``'s layouts."""
    from portbench import harness, weights
    _run(hybrid_dir, seed=3)
    stream = harness.load_module(ROOT / "portbench" / "drivers"
                                 / "serve_stream.py", "check_stream")
    assert stream.weights is weights


def test_the_control_is_not_correct(hybrid_dir):
    result, _, _ = _run(hybrid_dir, seed=23, control=["fp8"])
    assert result["correct"]
    assert result["control"]["fp8"]["max_logit_gap"]["value"] \
        > GAP_LIMIT


def _no_shared_expert(monkeypatch):
    from repro_torch.models import moe
    monkeypatch.setattr(moe, "apply_ffn", lambda cfg, p, x: x * 0)


def _no_residual_multiplier(monkeypatch):
    from repro_torch.models import model
    monkeypatch.setattr(model, "_branch", lambda cfg, h, x: h.to(x.dtype))


def _mamba_state_not_carried(monkeypatch):
    from repro_torch.models import ssm
    step = ssm.mamba_step

    def stale(cfg, s, p, x, state, norm_group=None):
        return step(cfg, s, p, x, state, norm_group)[0], state
    monkeypatch.setattr(ssm, "mamba_step", stale)


FAULTS = {"shared_expert_dropped": _no_shared_expert,
          "residual_multiplier_left_out": _no_residual_multiplier,
          "mamba_state_not_carried": _mamba_state_not_carried}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(hybrid_dir, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result, _, _ = _run(hybrid_dir, seed=21)
    assert not result["correct"]
    gap = result["compared"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _reader(name):
    from portbench import harness
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "hybrid_" + name.replace(".", "_"))


def _trace():
    """A prefill holding two Mamba ranges and an attention stretch, a
    Mamba range in a decode (its first step, captured), and a decode."""
    from portbench.devtrace import DeviceTrace
    tr = DeviceTrace()
    tr.bounds, tr.window_s = (0.0, 10.0), 10.0
    tr.host = [("serve.prefill", 1.0, 5.0), ("model.mamba", 1.0, 2.0),
               ("model.mamba", 3.0, 4.0), ("serve.decode", 6.0, 7.0),
               ("model.mamba", 6.1, 6.2), ("serve.decode", 8.0, 9.0)]
    tr.device = [("ssd", 1.2, 1.7), ("k3", 2.0, 3.0), ("ssd", 3.5, 4.0),
                 ("gemm", 4.0, 5.0), ("a", 6.0, 6.5), ("b", 8.0, 8.25)]
    return tr


def test_mamba_share_reads_the_prefills_mamba_device_time():
    got = _reader("mamba_prefill_share.serve").read({"trace": _trace()})
    # 0.5 + 0.5 s of 0.5 + 1.0 + 0.5 + 1.0 s busy in the prefill
    assert got == pytest.approx(100.0 / 3)


def test_decode_roofline_reads_the_routed_bytes_over_the_busy_time():
    from portbench.yardstick.hybrid import decode_bytes
    from portbench.yardstick.peaks import HBM_BPS
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "granite-4.0-h-small.json").read_text())
    got = _reader("hybrid_decode_roofline.serve").read(
        {"trace": _trace(), "config": cfg})
    assert got == pytest.approx(100.0 * 2 * decode_bytes(cfg)
                                / (0.75 * HBM_BPS))
    assert _reader("hybrid_decode_roofline.serve").read(
        {"trace": _trace(), "config": {"family": "moe"}}) is None


def test_prefill_mfu_counts_the_hybrids_flops():
    from portbench.yardstick.hybrid import prefill_flops
    from portbench.yardstick.peaks import BF16_FLOPS
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "granite-4.0-h-small.json").read_text())
    rec = {"config": cfg, "prefill_lens": [1500, 400],
           "op_seconds": {"prefill": [0.2, 0.1]}}
    got = _reader("hybrid_prefill_mfu.serve").read(rec)
    want = prefill_flops(cfg, 1500) + prefill_flops(cfg, 400)
    assert got == pytest.approx(100.0 * want / (0.3 * BF16_FLOPS))
    # 17.0 GFLOP a token at 1500: the published model's 9 B active
    # parameters twice, plus the SSD and attention
    assert prefill_flops(cfg, 1500) / 1500 == pytest.approx(17.02e9,
                                                           rel=1e-3)


def test_dropped_share_reads_the_count_in_a_traced_run():
    from repro_torch.models.moe import DROPS
    DROPS.reset()
    reader = _reader("moe_dropped.serve")
    assert reader.read({"trace": _trace()}) is None      # nothing routed
    DROPS.add(torch.tensor([True, False, True, True]))
    try:
        assert reader.read({"trace": _trace()}) == pytest.approx(25.0)
        assert reader.read({}) is None                    # no trace
    finally:
        DROPS.reset()


def test_the_yardstick_counts_the_published_model():
    from portbench.yardstick.hybrid import decode_bytes
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "granite-4.0-h-small.json").read_text())
    # 17.6 GB of routed-only weights and 0.3 GB of Mamba state a step
    assert decode_bytes(cfg) == pytest.approx(17.91e9, rel=1e-3)
